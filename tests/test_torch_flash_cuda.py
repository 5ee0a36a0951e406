"""The CUDA flash kernels against their plain PyTorch versions, on a card.

These need an NVIDIA card and nvcc, so they skip on a host without one.
They import neither JAX nor the JAX package, so they also run on a
machine that has only PyTorch; there, without this directory's
conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py

Tolerance: flash_attention.KERNEL_TOLERANCE, the limits chip_smoke.py
holds the kernels to (each element within atol + rtol * |plain|, and the
tensor within rel_fro of the plain version in Frobenius norm), stated and
explained there.
"""

import pytest
import torch

from shockwave_tpu_torch.ops import flash_attention as fa

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from shockwave_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _close(got, ref, tol, what):
    r = fa.compare(got, ref, tol)
    assert r["ok"], f"{what}: {r}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "B,S,H,Hkv,D,window",
    [
        (1, 128, 2, 2, 16, None),
        (2, 256, 4, 1, 32, None),
        (1, 384, 4, 2, 64, 1),
        (1, 512, 2, 2, 128, 64),
        (2, 512, 4, 2, 64, 200),
        (1, 1024, 2, 1, 128, 333),
    ],
)
def test_kernels_match_plain_versions(device, dtype, B, S, H, Hkv, D, window):
    gen = torch.Generator(device=device).manual_seed(S + D)

    def randn(rows):
        return torch.randn(rows, S, D, generator=gen, device=device).to(dtype)

    q, g = randn(B * H), randn(B * H)
    k, v = randn(B * Hkv), randn(B * Hkv)
    qs = fa.scale_q(q)
    fa.reset_launch_counts()
    out, lse = fa.flash_fwd(qs, k, v, H, window)
    out_p, lse_p = fa.flash_fwd_plain(qs, k, v, H, window)
    torch.cuda.synchronize()
    tol = fa.KERNEL_TOLERANCE[dtype]
    _close(out, out_p, tol, "out")
    _close(lse, lse_p, fa.KERNEL_TOLERANCE["lse"], "lse")
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, window)
    dk, dv = fa.flash_dkv(*args)
    dq = fa.flash_dq(*args)
    torch.cuda.synchronize()
    dk_p, dv_p = fa.flash_dkv_plain(*args)
    _close(dk, dk_p, tol, "dk")
    _close(dv, dv_p, tol, "dv")
    _close(dq, fa.flash_dq_plain(*args), tol, "dq")
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dkv": 1, "flash_dq": 1}


@pytest.mark.cuda
def test_autograd_through_kernels_matches_dense(device):
    from shockwave_tpu_torch.parallel.ring_attention import (
        dense_causal_attention,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    B, S, H, Hkv, D = 2, 256, 4, 2, 64
    q = torch.randn(B, S, H, D, generator=gen, device=device)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=device)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=device)
    w = torch.randn(B, S, H, D, generator=gen, device=device)
    flash_in = [x.clone().requires_grad_() for x in (q, k, v)]
    dense_in = [x.clone().requires_grad_() for x in (q, k, v)]
    (fa.flash_attention(*flash_in) * w).sum().backward()
    kx, vx = (x.repeat_interleave(H // Hkv, dim=2) for x in dense_in[1:])
    (dense_causal_attention(dense_in[0], kx, vx) * w).sum().backward()
    # float32 against the dense reference: summation order only.
    for a, b in zip(flash_in, dense_in):
        _close(a.grad, b.grad,
               dict(rtol=1e-4, atol=1e-4, rel_fro=1e-5, fro_atol=0.0), "grad")


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(device, monkeypatch):
    def boom(*args):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", boom)
    q = torch.randn(1, 128, 2, 16, device=device)
    fa.reset_launch_counts()
    fa.flash_attention(q, q, q)
    assert fa.LAUNCHES["flash_fwd"] == 1
