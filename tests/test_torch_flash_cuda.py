"""The CUDA flash kernels against their plain PyTorch versions, on a card.

These need an NVIDIA card and nvcc, so they skip on a host without one.
They import neither JAX nor the JAX package, so they also run on a
machine that has only PyTorch; there, without this directory's
conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py

Tolerance: flash_attention.KERNEL_TOLERANCE, the limits chip_smoke.py
holds the kernels to (each element within atol + rtol * |plain| plus one
bf16 step of its largest term, and the tensor within rel_fro of the plain
version in Frobenius norm), stated and explained there. The inputs and
the check are tools/bench_flash.py's, as chip_smoke.py uses them.
"""

import pytest
import torch

from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.tools import bench_flash

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
        # Edges of the bf16 forward's 128-row q and k tiles and of dK/dV's
        # 128 keys and 64-row q tiles: one tile, windows ending on a tile
        # boundary, groups of 4 query heads per KV head.
        (1, 128, 4, 4, 128, None),
        (1, 512, 8, 2, 128, 128),
        (2, 384, 8, 2, 64, 64),
        # Edges of the bf16 dQ's 128-row CTAs, split into two warpgroups of
        # 64 rows, and its 128-wide k tiles: a window shorter than 64 rows
        # and off every tile boundary, so a warpgroup sees nothing of some
        # tiles of its CTA's walk; groups of 8 query heads per KV head at
        # D=16.
        (1, 256, 2, 2, 32, 17),
        (1, 384, 8, 1, 16, 100),
    ],
)
def test_kernels_match_plain_versions(device, dtype, B, S, H, Hkv, D, window):
    fa.reset_launch_counts()
    found, _, _ = bench_flash.check_kernels(fa, fa, S + D, B, S, H, Hkv, D,
                                            dtype, window, device)
    for (kernel, what), r in found.items():
        assert r["ok"], f"{kernel} {what}: {bench_flash.describe(r)}"
    assert fa.LAUNCHES == dict(ONE_CAUSAL_EACH)


ONE_CAUSAL_EACH = {"flash_fwd": 1, "flash_dkv": 1, "flash_dq": 1,
                   "flash_fwd_nc": 0, "flash_dkv_nc": 0, "flash_dq_nc": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "B,Sq,Sk,H,Hkv,D",
    [
        (1, 128, 128, 2, 2, 16),
        (2, 128, 384, 4, 1, 32),
        (2, 512, 1024, 4, 2, 64),
        (1, 384, 128, 8, 2, 128),
        (2, 512, 512, 8, 8, 128),
    ],
)
def test_non_causal_kernels_match_plain_versions(device, dtype, B, Sq, Sk, H,
                                                 Hkv, D):
    """The non-causal mode (a ring hop): every query against every key,
    Sk apart from Sq, GQA groups of 1 to 4, at every head dim."""
    fa.reset_launch_counts()
    found, _, _ = bench_flash.check_kernels(fa, fa, Sq + Sk + D, B, Sq, H,
                                            Hkv, D, dtype, None, device,
                                            causal=False, Sk=Sk)
    for (kernel, what), r in found.items():
        assert r["ok"], f"{kernel} {what}: {bench_flash.describe(r)}"
    assert fa.LAUNCHES == {name: int(name.endswith("_nc"))
                           for name in ONE_CAUSAL_EACH}


@pytest.mark.cuda
def test_ring_on_one_card_matches_flash(device):
    """Ring attention on a 4-shard seq mesh of one card (flash body: 4
    causal hops, 6 live non-causal ones) against flash_attention, float32,
    output and q/k/v gradients at the JAX package's ring limits (rtol
    1e-3, atol 1e-4)."""
    from shockwave_tpu_torch.parallel.mesh import make_mesh
    from shockwave_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh((1, 1, 4, 1), [device] * 4)
    gen = torch.Generator(device=device).manual_seed(0)
    B, S, H, Hkv, D = 1, 512, 4, 2, 64
    inputs = [torch.randn(B, S, h, D, generator=gen, device=device)
              for h in (H, Hkv, Hkv)]
    w = torch.randn(B, S, H, D, generator=gen, device=device)
    ring_in = [x.clone().requires_grad_() for x in inputs]
    flash_in = [x.clone().requires_grad_() for x in inputs]
    fa.reset_launch_counts()
    ring_out = ring_attention(*ring_in, mesh, inner="flash")
    (ring_out * w).sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 4, "flash_dkv": 4, "flash_dq": 4,
                           "flash_fwd_nc": 6, "flash_dkv_nc": 6,
                           "flash_dq_nc": 6}
    flash_out = fa.flash_attention(*flash_in)
    (flash_out * w).sum().backward()
    tol = dict(rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(ring_out, flash_out, **tol)
    for a, b in zip(ring_in, flash_in):
        torch.testing.assert_close(a.grad, b.grad, **tol)


@pytest.mark.cuda
def test_training_shape_on_a_second_seed(device):
    """The training shape (B=8, S=2048, H=8, D=128, bf16) on inputs from
    seed 1, drawn as chip_smoke.py draws seed 0. Under the earlier rule
    (atol 2^-9, no flip term in KERNEL_TOLERANCE) 5 of dk's 134M elements
    broke the per-element limit here: a ds that rounds to bf16 the other
    way in the kernel than in the plain version moves its element by one
    bf16 step of ds * q, more than that atol."""
    found, _, _ = bench_flash.check_kernels(fa, fa, 1, 8, 2048, 8, 8, 128,
                                            torch.bfloat16, None, device)
    for (kernel, what), r in found.items():
        assert r["ok"], f"{kernel} {what}: {bench_flash.describe(r)}"


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
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_cuda_tensors_never_take_the_plain_version(device, monkeypatch, D):
    def boom(*args):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("flash_fwd_plain", "flash_dkv_plain", "flash_dq_plain"):
        monkeypatch.setattr(fa, name, boom)
    q = torch.randn(1, 128, 2, D, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn(1, 256, 1, D, device=device, dtype=torch.bfloat16,
                     requires_grad=True)
    fa.reset_launch_counts()
    fa.flash_attention(q, q, q).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES == ONE_CAUSAL_EACH
    out, lse = fa.flash_attention_lse(q, kv, kv, causal=False)
    (out.float().sum() + lse.sum()).backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {name: 1 for name in ONE_CAUSAL_EACH}
