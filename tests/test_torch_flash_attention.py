"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX Pallas kernels (interpret mode,
as tests/test_flash_attention.py runs them) and through the port's
wrappers, which take their plain PyTorch versions for CPU tensors. The
CUDA kernels themselves are held against those plain versions on the
card (tests/test_torch_flash_cuda.py, chip_smoke.py).

Tolerances, float32 throughout: the JAX kernels sum blockwise with an
online softmax, the plain versions in one pass over the whole row, so
results differ by float32 rounding in the summation order: 2e-5 on out
and lse (values of order 1), 1e-4 on gradients (sums over up to 256 rows).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_lse as jax_flash_attention_lse,
)
from shockwave_tpu.parallel.ring_attention import (
    dense_causal_attention as jax_dense_causal_attention,
)
from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.parallel.ring_attention import dense_causal_attention

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, S, H, kv_heads, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, kv_heads, D)).astype(np.float32)
    v = rng.normal(size=(B, S, kv_heads, D)).astype(np.float32)
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, w


def _flat(x):
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


@pytest.mark.parametrize(
    "S,kv_heads,window",
    [
        (128, 4, None),   # plain causal
        (256, 2, None),   # GQA, groups of 2
        (128, 4, 40),     # window inside a tile
        (256, 2, 100),    # window across tiles, with GQA
        (256, 1, 200),    # GQA with one KV head, and a window
    ],
)
def test_forward_lse_and_grads_match_jax(S, kv_heads, window):
    B, H, D = 1, 4, 16
    q, k, v, w = _inputs(S + kv_heads + (window or 0), B, S, H, kv_heads, D)

    # 128-wide JAX blocks, so its shrunk window walks and the diagonal
    # split are exercised too.
    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, block_q=128, block_k=128,
                                  window=window)
        return jnp.sum(out * w)

    j_out, j_lse = jax_flash_attention_lse(q, k, v, block_q=128,
                                           block_k=128, window=window)
    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **OUT_TOL)
    _, lse = fa.flash_fwd(fa.scale_q(_flat(torch.from_numpy(q))),
                          _flat(torch.from_numpy(k)),
                          _flat(torch.from_numpy(v)), H,
                          fa._resolve_window(window, S))
    np.testing.assert_allclose(lse.view(B, H, S).numpy(), np.asarray(j_lse),
                               **OUT_TOL)
    for t, j in zip((tq, tk, tv), j_grads):
        assert t.grad.shape == j.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


def test_plain_kernels_compose_to_autograd_of_dense():
    """The three plain versions, chained as the autograd Function chains
    the kernels, give the gradient torch autograd takes through the port's
    dense reference (float32, so only summation order differs)."""
    B, S, H, D = 2, 128, 2, 32
    q, k, v, w = _inputs(3, B, S, H, H, D)
    args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = dense_causal_attention(*args)
    (out * torch.from_numpy(w)).sum().backward()
    fq, fk, fv, fw = (_flat(torch.from_numpy(x)) for x in (q, k, v, w))
    qs = fa.scale_q(fq)
    f_out, lse = fa.flash_fwd_plain(qs, fk, fv, H, None)
    delta = (fw * f_out).sum(-1)
    dk, dv = fa.flash_dkv_plain(qs, fk, fv, fw, lse, delta, H, None)
    dq = fa.flash_dq_plain(qs, fk, fv, fw, lse, delta, H, None)
    for got, ref in ((f_out, out.detach()), (dq, args[0].grad),
                     (dk, args[1].grad), (dv, args[2].grad)):
        np.testing.assert_allclose(got.numpy(), _flat(ref).numpy(),
                                   **GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_causal_attention_matches_jax(dtype):
    """float32: summation order only. bfloat16: both multiply bf16
    operands exactly in float32 and round the output once to bf16, so
    they agree to one bf16 rounding of values of order 1 (1/128)."""
    q, k, v, _ = _inputs(4, 2, 64, 2, 2, 16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_dense_causal_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    got = dense_causal_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)))
    assert got.dtype == tdt
    tol = OUT_TOL if dtype == "float32" else dict(rtol=0, atol=1 / 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize(
    "S,kv_heads,window", [(256, 2, None), (256, 1, 100)],
    ids=["gqa", "gqa-window"],
)
def test_bf16_forward_and_grads_match_jax_bf16(S, kv_heads, window):
    """bfloat16 through both packages on the same bf16 inputs, the JAX
    kernels at 128-wide k blocks like the port's forward. Both round p (and
    ds) to bf16 at the same scale, so they agree far inside bf16 rounding
    noise.

    Readings (CPU): port bf16 against JAX bf16, rel_fro 8.2e-6 to 1.0e-4
    over out, dq, dk, dv; the port in float32 on the same inputs against
    JAX bf16, 1.9e-3 to 3.1e-3. The limit, 5e-4, sits between: a port
    that skipped the bf16 casts of p or ds, or ran in float32, fails."""
    B, H, D = 1, 4, 64
    q, k, v, w = (x.astype(jnp.bfloat16).astype(np.float32)
                  for x in _inputs(S + kv_heads, B, S, H, kv_heads, D))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, block_q=128, block_k=128,
                                  window=window)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    ref = [np.asarray(x, np.float32) for x in (j_out, *j_grads)]

    def port(dtype):
        args = [torch.from_numpy(x).to(dtype).requires_grad_()
                for x in (q, k, v)]
        out = fa.flash_attention(*args, window=window)
        (out.float() * torch.from_numpy(w)).sum().backward()
        assert out.dtype == dtype
        return [t.detach().float().numpy()
                for t in (out, *(a.grad for a in args))]

    def rel_fro(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for name, got, f32, want in zip(("out", "dq", "dk", "dv"),
                                    port(torch.bfloat16),
                                    port(torch.float32), ref):
        assert rel_fro(got, want) < 5e-4, name
        assert rel_fro(f32, want) > 5e-4, name  # the limit tells them apart


def _chip_smoke():
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_names_the_kernels_in_cuobjdump_output():
    """The SASS and resource check on the card finds each kernel
    instantiation by its mangled name, as cuobjdump prints it."""
    smoke = _chip_smoke()
    prefix = "_ZN51_GLOBAL__N__c2d97782_18_flash_attention_cu_b294bfd0"
    assert smoke.kernel_of(
        f"Function {prefix}14flash_fwd_bf16ILi32EEEv14CUtensorMap_stS1_S1_S1_"
        "Pfiiii:") == ("flash_fwd_bf16", 32)
    assert smoke.kernel_of(
        f"        Function : {prefix}14flash_dkv_bf16ILi128EEEv14CUtensorMap_"
        "st") == ("flash_dkv_bf16", 128)
    assert smoke.kernel_of(f"{prefix}13flash_dq_f32ILi16EEEvPKf") == (
        "flash_dq_f32", 16)
    assert smoke.kernel_of("Function _Z6helperv:") is None


def test_chip_smoke_checks_every_bf16_kernel():
    """The SASS check covers all three bf16 kernels, and the planted faults
    skip tiles of the widths the CUDA source walks."""
    import re

    from shockwave_tpu_torch.ops import _build

    smoke = _chip_smoke()
    assert smoke.HOPPER_KERNELS == (
        "flash_fwd_bf16", "flash_dkv_bf16", "flash_dq_bf16")
    source = (_build.CSRC / "flash_attention.cu").read_text()
    for name, width in (("FWD_BN", fa._FWD_K_TILE),
                        ("DKV_BQ", smoke.DKV_Q_TILE),
                        ("DQ_BN", smoke.DQ_K_TILE)):
        assert re.search(rf"\b{name} = (\d+)", source).group(1) == str(width)


def test_bench_flash_needs_a_card():
    """The kernel timing tool refuses to run without a card rather than
    timing the plain versions on the CPU."""
    from shockwave_tpu_torch.tools import bench_flash

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time the kernels")
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        bench_flash.main([])


def test_kernel_tolerance_rejects_planted_faults():
    """The limits the card holds each kernel to (KERNEL_TOLERANCE, bf16,
    with its flip terms) reject what chip_smoke.py plants: a skipped tile
    of the width each bf16 kernel walks (a 128-wide k tile for the
    forward and for dQ, a 64-row q tile for dK/dV), and the
    later half of the rows weighted 2% high; here on the plain versions at
    S=2048, D=128 (two heads)."""
    smoke = _chip_smoke()

    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 2048, 128, generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    qs = fa.scale_q(q)
    out, lse = fa.flash_fwd_plain(qs, k, v, 2, None)
    delta = (g.float() * out.float()).sum(-1)
    plain = {"out": out,
             "dq": fa.flash_dq_plain(qs, k, v, g, lse, delta, 2, None)}
    plain["dk"], plain["dv"] = fa.flash_dkv_plain(qs, k, v, g, lse, delta,
                                                  2, None)
    tol = fa.KERNEL_TOLERANCE[torch.bfloat16]
    terms = fa.largest_terms(qs, k, v, g, lse, delta, 2, None)
    faults = smoke.planted_faults(fa, qs, k, v, g, lse, delta, 2)
    assert len(faults) == 5
    for (what, fault), bad in faults.items():
        assert not fa.compare(bad, plain[what], tol, terms[what])["ok"], (
            what, fault)
    for what, t in plain.items():
        assert fa.compare(t, t, tol, terms[what])["ok"], what


def test_largest_terms_bound_every_term_and_allow_one_flip():
    """largest_terms bounds every term p * v, p * g, ds * q, ds * k / sqrt(D)
    of each output element's sum (checked against every term at a small
    GQA-window shape), and a dv element whose largest term rounded to
    bf16 the other way passes KERNEL_TOLERANCE while a shift of twice the
    element's limit fails it."""
    B, S, H, Hkv, D, window = 1, 128, 4, 2, 16, 40
    q, k, v, g = (_flat(torch.from_numpy(x)).to(torch.bfloat16)
                  for x in _inputs(11, B, S, H, Hkv, D))
    qs = fa.scale_q(q)
    out, lse = fa.flash_fwd_plain(qs, k, v, H, window)
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, window)
    terms = fa.largest_terms(*args)
    p, ds = fa._probs_and_dscores(*args)
    ds = ds.float()
    kx, vx = (fa._expand_kv(x, B * H, H).float() for x in (k, v))
    every = {  # [BH, rows of the output, summed index, D]
        "out": p[..., None] * vx[:, None],
        "dv": p.transpose(1, 2)[..., None] * g.float()[:, None],
        "dk": ds.transpose(1, 2)[..., None] * qs.float()[:, None],
        "dq": ds[..., None] * kx[:, None] / D ** 0.5,
    }
    for what, t in every.items():
        assert bool((t.abs().amax(2) <= terms[what] * (1 + 1e-6)).all()), what

    # dv[key, d] with its term p[row, key] * g[row, d] one bf16 step of p
    # off, and with twice its limit added.
    _, dv = fa.flash_dkv_plain(*args)
    tol = fa.KERNEL_TOLERANCE[torch.bfloat16]
    key = 100
    row = int(p[0, :, key].argmax())
    d = int(g[0, row].float().abs().argmax())
    ref = float(dv[0, key, d])
    flip = float(p[0, row, key]) * 2**-7 * float(g[0, row, d])
    limit = (tol["atol"] + tol["rtol"] * abs(ref)
             + tol["flip"] * float(terms["dv"][0, key, d]))
    for shift, ok in ((flip, True), (2 * limit, False)):
        bad = dv.clone()
        bad[0, key, d] = ref + shift
        assert fa.compare(bad, dv, tol, terms["dv"])["ok"] is ok, shift


def test_window_covering_sequence_is_plain_causal():
    q, k, v, _ = _inputs(6, 1, 256, 2, 2, 16)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    assert torch.equal(fa.flash_attention(*args, window=256),
                       fa.flash_attention(*args))
    with pytest.raises(ValueError):
        fa.flash_attention(*args, window=0)


def test_rejects_what_the_kernels_do_not_take():
    def qkv(S=128, H=4, kv=4, D=16, dtype=torch.float32):
        return (torch.zeros(1, S, H, D, dtype=dtype),
                torch.zeros(1, S, kv, D, dtype=dtype),
                torch.zeros(1, S, kv, D, dtype=dtype))

    with pytest.raises(ValueError):
        fa.flash_attention(*qkv(kv=3))  # 4 q heads over 3 kv heads
    q, k, _ = qkv(kv=2)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, torch.zeros(1, 128, 1, 16))  # k/v differ
    with pytest.raises(ValueError):
        fa.flash_attention(*qkv(S=192))  # not a multiple of 128
    with pytest.raises(ValueError):
        fa.flash_attention(*qkv(D=24))
    with pytest.raises(ValueError):
        fa.flash_attention(*qkv(dtype=torch.float16))
    assert fa.flash_tiles(384) and not fa.flash_tiles(64)
    assert not fa.flash_tiles(132)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    fa.reset_launch_counts()
    q, k, v, _ = _inputs(7, 1, 128, 2, 1, 16)
    args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    fa.flash_attention(*args).sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}


def test_ctypes_signatures_match_the_c_entry_points():
    """Every extern "C" entry of the CUDA source has the argument count
    and kinds that _build binds with ctypes (a pointer passed as an int
    would be cut to 32 bits)."""
    import ctypes
    import re

    from shockwave_tpu_torch.ops import _build

    for name, entries in _build.SIGNATURES.items():
        source = (_build.CSRC / f"{name}.cu").read_text()
        found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source))
        assert set(found) == set(entries)
        for fn, argtypes in entries.items():
            params = [p.strip() for p in found[fn].split(",")]
            kinds = [ctypes.c_void_p if "*" in p else
                     ctypes.c_float if p.startswith("float") else ctypes.c_int
                     for p in params]
            assert kinds == argtypes, fn


def test_build_keeps_the_ptxas_report(monkeypatch, tmp_path):
    """build() asks ptxas for its report (-Xptxas -v) and keeps what nvcc
    printed beside the library, where chip_smoke.py looks for serialised
    wgmma."""
    import subprocess

    from shockwave_tpu_torch.ops import _build

    report = "ptxas info    : Used 168 registers, used 16 barriers\n"
    calls = []

    def fake_nvcc(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", report)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    lib = _build.build("flash_attention")
    assert lib.exists() and lib.parent == tmp_path
    assert lib.with_suffix(".log").read_text() == report
    assert "-Xptxas" in calls[0] and "-v" in calls[0]
    assert _build.build("flash_attention") == lib and len(calls) == 1


def test_build_names_a_missing_nvcc(monkeypatch):
    from shockwave_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
