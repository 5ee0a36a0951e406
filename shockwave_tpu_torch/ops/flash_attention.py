"""Blockwise (flash) causal attention with hand-written CUDA kernels.

The port's counterpart of ``shockwave_tpu/ops/flash_attention.py``: the
same public contract (``flash_attention`` on [B, S, H, D], causal, with
grouped-query attention and a sliding window), and the same numerics
choices. The 1/sqrt(D) score scale is folded into q once, in float32,
then cast back to the input dtype. The P.V product takes p in the input
dtype with float32 accumulation. The backward recomputes
p = exp(s - lse) from the saved per-row log-sum-exp, with
delta = rowsum(dout * out) computed outside the kernels. dk/dv are
written per query head and group-summed here in float32, with no atomics.
Dead score entries take the mask value -1e30.

Three kernels live in ``csrc/flash_attention.cu``: forward, dK/dV and dQ.
Each has a wrapper here (``flash_fwd``, ``flash_dkv``, ``flash_dq`` on
flat [B*H, S, D] tensors with a pre-scaled q) and a plain PyTorch version
of the same function. A wrapper takes the plain version only for tensors
on the CPU; on a CUDA tensor it launches the kernel or raises. Each
launch adds one to its entry of ``LAUNCHES``.

What the TPU version needed and this one does not: the 128-lane
replication of lse (here [B*H, S] float32), the 16 MiB VMEM block cap and
the 1024-wide blocks. The block sizes are not arguments. The bf16 forward
takes 128 q rows a CTA and walks 128-wide k tiles (which sets where p is
rounded, so the plain forward walks the same tiles); bf16 dK/dV takes 128
keys a CTA and walks 64-row q tiles; bf16 dQ takes 128 q rows a CTA and
walks 128-wide k tiles. dK/dV and dQ recompute p from lse elementwise, so
their widths do not touch the numerics. The float32 kernels take 64-row
tiles throughout.
"""

from __future__ import annotations

import math

import torch

from shockwave_tpu_torch.ops import _build

_NEG_INF = -1e30
_LANES = 128
# Width of the k tiles the bf16 forward kernel walks: p is rounded to bf16
# at the running max of each such tile, so the plain forward walks them too.
_FWD_K_TILE = 128
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each CUDA kernel since the last reset. Only a kernel launch
# counts; the plain versions do not.
LAUNCHES = {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_tiles(seq_len: int) -> bool:
    """Whether a sequence takes the flash kernels: any multiple of 128.
    Callers that want a dense fallback instead of the ValueError in
    :func:`flash_attention` gate on this (models/transformer.py), with the
    same threshold as the JAX package so both take the same path."""
    return seq_len >= _LANES and seq_len % _LANES == 0


def _check_kv_heads(num_q_heads, k_heads, v_heads):
    if k_heads != v_heads:
        raise ValueError(
            f"k and v head counts differ: {k_heads} vs {v_heads}"
        )
    if num_q_heads % k_heads:
        raise ValueError(
            f"q heads ({num_q_heads}) must be a multiple of kv heads "
            f"({k_heads})"
        )
    return k_heads


def _resolve_window(window, seq_len):
    """Validate the sliding window; a window covering the whole
    sequence is plain causal attention."""
    if window is None:
        return None
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return None if window >= seq_len else int(window)


def _check_supported(seq_len: int, head_dim: int, dtype: torch.dtype):
    if not flash_tiles(seq_len):
        raise ValueError(
            f"seq len {seq_len} does not tile into flash blocks (needs a "
            "multiple of 128; see flash_tiles for the dense-fallback gate)"
        )
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"head dim {head_dim} not supported; use one of {HEAD_DIMS}"
        )
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {dtype} not supported; float32 or bfloat16")


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(D) in float32, cast back to q's dtype: the fold both
    the kernels and the plain versions expect."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * scale).to(q.dtype)


# -- plain PyTorch versions ---------------------------------------------
def _expand_kv(x: torch.Tensor, bh: int, num_q_heads: int) -> torch.Tensor:
    """[B*Hkv, S, D] -> [B*H, S, D]: query head h reads KV head h // group."""
    bhkv, S, D = x.shape
    group = bh // bhkv
    if group == 1:
        return x
    B = bh // num_q_heads
    kv_heads = num_q_heads // group
    x = x.view(B, kv_heads, 1, S, D).expand(B, kv_heads, group, S, D)
    return x.reshape(bh, S, D)


def _masked_scores(q, k, num_q_heads, window):
    """f32 scores of the pre-scaled q against k, dead entries -1e30."""
    S = q.shape[1]
    kx = _expand_kv(k, q.shape[0], num_q_heads)
    s = q.float() @ kx.float().transpose(1, 2)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    dead = cols > rows
    if window is not None:
        dead = dead | (cols < rows - (window - 1))
    return s.masked_fill(dead, _NEG_INF)


def flash_fwd_plain(q, k, v, num_q_heads, window):
    """Plain version of the forward kernel: (out, lse [B*H, S] f32).

    It walks the keys in the bf16 kernel's 128-wide tiles with the same
    online softmax, so p = exp(s - running max) is rounded to the input
    dtype at the same scale as in the kernel (and in the TPU kernel at
    128-wide k blocks). In float32 the rounding is a no-op and the width
    only orders the sums. Tiles a row cannot see change nothing: past its last live
    column p is 0; before its first, the next live tile's correction
    factor exp(-1e30 - m) zeroes what they added."""
    BH, S, D = q.shape
    s = _masked_scores(q, k, num_q_heads, window)
    vx = _expand_kv(v, BH, num_q_heads).float()
    m = torch.full((BH, S, 1), _NEG_INF, device=q.device)
    l = torch.zeros((BH, S, 1), device=q.device)
    acc = torch.zeros((BH, S, D), device=q.device)
    for c in range(0, S, _FWD_K_TILE):
        st = s[:, :, c:c + _FWD_K_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).float() @ vx[:, c:c + _FWD_K_TILE]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    lse = (m + torch.log(l + 1e-30)).squeeze(-1)
    return out.to(q.dtype), lse


def _probs_and_dscores(q, k, v, g, lse, delta, num_q_heads, window):
    s = _masked_scores(q, k, num_q_heads, window)
    p = torch.exp(s - lse[..., None])
    vx = _expand_kv(v, q.shape[0], num_q_heads)
    dp = g.float() @ vx.float().transpose(1, 2)
    ds = (p * (dp - delta[..., None])).to(q.dtype)
    return p, ds


def flash_dkv_plain(q, k, v, g, lse, delta, num_q_heads, window):
    """Plain version of the dK/dV kernel: per query head, [B*H, S, D]."""
    p, ds = _probs_and_dscores(q, k, v, g, lse, delta, num_q_heads, window)
    dv = p.to(q.dtype).float().transpose(1, 2) @ g.float()
    dk = ds.float().transpose(1, 2) @ q.float()
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_dq_plain(q, k, v, g, lse, delta, num_q_heads, window):
    """Plain version of the dQ kernel; 1/sqrt(D) applied once at the end."""
    _, ds = _probs_and_dscores(q, k, v, g, lse, delta, num_q_heads, window)
    kx = _expand_kv(k, q.shape[0], num_q_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return ((ds.float() @ kx.float()) * scale).to(q.dtype)


# -- how close a kernel must come to its plain version -------------------
# Per output, on the same inputs: every element within
# atol + rtol * |plain| + flip * term, and the whole tensor within
# rel_fro * ||plain|| + fro_atol * sqrt(numel) (Frobenius; fro_atol is an
# RMS floor for outputs that are rounding noise around zero, such as dk and
# dq under a one-token window, where the plain version's own noise has an
# RMS of ~6e-8 on the CPU; at the training shape it adds ~1e-5 to the
# rel_fro limit).
#
# bfloat16: both round p (and ds) to bf16 at the same scale and round the
# output once, from float32 sums taken in other orders; an element may sit
# one bf16 step apart (rtol 2^-7 covers one step anywhere in a binade).
# A p (or ds) that sits on a rounding boundary can round the other way in
# one of the two: that moves its element by one bf16 step of that term,
# at most 2^-7 * |p| * |g| for dv. ``largest_terms`` bounds the largest
# term of each element's sum (the largest |p| of its column times the
# largest |g| of its column, and likewise for out, dk and dq), and flip
# 2^-7 lets one such term round the other way. What is left is float32
# summation order, which atol covers. The earlier rule, atol 2^-9 and no
# flip term, broke on 5 of dk's 134M elements at the training shape on
# inputs from seed 1 (they needed atol 2.6e-3), with mma.sync kernels and
# wgmma ones alike. Under this rule, on seeds 0-3 and both kernel
# generations, out, dk and dv needed no atol and dq 2.1e-6, hence atol
# 2^-12, about 100x that. Readings and planted faults: PERF.md §6
# (tools/bench_flash.py and chip_smoke.py on an H100). A skipped k or q
# tile reads rel_fro ~1e-1 and rows weighted 2% high ~7e-3, both far past
# rel_fro 5e-4 (the largest kernel reading is ~2e-4); a float32 result
# against a bf16 one reads ~2e-3.
# float32: summation order only; nothing is rounded to a narrower type, so
# flip is 0. lse: float32 in both, values of order 10.
KERNEL_TOLERANCE = {
    torch.bfloat16: dict(rtol=2**-7, atol=2**-12, flip=2**-7, rel_fro=5e-4,
                         fro_atol=2**-20),
    torch.float32: dict(rtol=1e-5, atol=1e-5, flip=0.0, rel_fro=1e-5,
                        fro_atol=2**-20),
    "lse": dict(rtol=1e-6, atol=1e-5, flip=0.0, rel_fro=1e-6, fro_atol=0.0),
}


def largest_terms(q, k, v, g, lse, delta, num_q_heads, window):
    """For each element of out, dk, dv and dq, a bound on the largest term
    of the product sum it comes from, from the plain versions' p and ds:
    out[r, d] sums p[r, c] * v[c, d], so the bound is max_c p[r, c] times
    max_c |v[c, d]|; dv[c, d] sums p[r, c] * g[r, d]; dk[c, d] sums
    ds[r, c] * q[r, d]; dq[r, d] sums ds[r, c] * k[c, d] / sqrt(D).
    Broadcastable to [B*H, S, D]; the flip rule of KERNEL_TOLERANCE
    multiplies them by one bf16 step."""
    p, ds = _probs_and_dscores(q, k, v, g, lse, delta, num_q_heads, window)
    ds = ds.float().abs()
    bh = q.shape[0]

    def col_max(x):  # [BH, S, D] -> [BH, 1, D]: over the sequence
        return x.float().abs().amax(1, keepdim=True)

    kx, vx = (_expand_kv(x, bh, num_q_heads) for x in (k, v))
    return {
        "out": p.amax(2, keepdim=True) * col_max(vx),
        "dv": p.amax(1)[..., None] * col_max(g),
        "dk": ds.amax(1)[..., None] * col_max(q),
        "dq": ds.amax(2, keepdim=True) * col_max(kx) / math.sqrt(q.shape[-1]),
    }


def compare(got: torch.Tensor, ref: torch.Tensor, tol: dict,
            terms: torch.Tensor | None = None) -> dict:
    """Readings of ``got`` against ``ref`` under one KERNEL_TOLERANCE entry,
    with ``terms`` from :func:`largest_terms` for that output (None: no
    flip allowance): the largest |err|, the atol the elementwise rule
    needed, the Frobenius ratio and its limit, the elements past the
    elementwise limit (and past it without the flip term), and whether it
    passes (every value finite, both limits held)."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    excess = err - tol["rtol"] * ref.abs()
    over_without_flip = int((excess > tol["atol"]).sum())
    if terms is not None and tol["flip"]:
        excess = excess - tol["flip"] * terms.double()
    ref_fro = float(torch.linalg.vector_norm(ref))
    fro_limit = tol["rel_fro"] * ref_fro + tol["fro_atol"] * ref.numel() ** 0.5
    err_fro = float(torch.linalg.vector_norm(err))
    over = int((excess > tol["atol"]).sum())
    finite = bool(torch.isfinite(got).all())
    return {
        "max_abs_err": float(err.max()),
        "atol_needed": max(0.0, float(excess.max())),
        "rel_fro": err_fro / max(ref_fro, 1e-30),
        "rel_fro_limit": fro_limit / max(ref_fro, 1e-30),
        "over": over,
        "over_without_flip": over_without_flip,
        "ok": finite and over == 0 and err_fro <= fro_limit,
    }


# -- kernel wrappers -----------------------------------------------------
def _check_flat(q, kv, like_q=(), rows=()):
    """Shapes, dtypes, devices and layout the kernels take: q-like tensors
    [B*H, S, D], k/v [B*Hkv, S, D], per-row stats [B*H, S] f32."""
    BH, S, D = q.shape
    _check_supported(S, D, q.dtype)
    for t in (q, *kv, *like_q, *rows):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
    for t in kv:
        if t.dtype != q.dtype or t.shape[1:] != (S, D) or BH % t.shape[0]:
            raise ValueError(
                f"k/v {tuple(t.shape)} {t.dtype} do not fit q "
                f"{tuple(q.shape)} {q.dtype}"
            )
    for t in like_q:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} does not match q")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (BH, S):
            raise ValueError(f"row stats must be float32 {(BH, S)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and any(
        t.data_ptr() % 16 for t in (q, *kv, *like_q, *rows)
    ):
        raise ValueError("flash kernels take 16-byte aligned tensors")
    return BH, S, D, BH // kv[0].shape[0]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, num_q_heads, window=None):
    """Forward kernel on flat tensors (q pre-scaled): (out, lse)."""
    BH, S, D, group = _check_flat(q, (k, v))
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_q_heads, window)
    out = torch.empty_like(q)
    lse = torch.empty((BH, S), device=q.device, dtype=torch.float32)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, S,
            num_q_heads, group, window or 0, _stream(q),
        )
    _build.check(code, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_dkv(q, k, v, g, lse, delta, num_q_heads, window=None):
    """dK/dV kernel: per query head [B*H, S, D], group-summed by caller."""
    BH, S, D, group = _check_flat(q, (k, v), (g,), (lse, delta))
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, g, lse, delta, num_q_heads, window)
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        code = lib.flash_dkv(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, S,
            num_q_heads, group, window or 0, _stream(q),
        )
    _build.check(code, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


def flash_dq(q, k, v, g, lse, delta, num_q_heads, window=None):
    """dQ kernel: [B*H, S, D], with the 1/sqrt(D) scale applied."""
    BH, S, D, group = _check_flat(q, (k, v), (g,), (lse, delta))
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, g, lse, delta, num_q_heads, window)
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        code = lib.flash_dq(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), BH, S, num_q_heads, group,
            window or 0, 1.0 / math.sqrt(D), _stream(q),
        )
    _build.check(code, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def _group_sum(d: torch.Tensor, bhkv: int) -> torch.Tensor:
    """Sum per-query-head KV gradients over each group, in float32. Heads
    are minor in the flat layout and groups are contiguous in h."""
    bh, S, D = d.shape
    if bh == bhkv:
        return d
    group = bh // bhkv
    return d.float().view(bhkv, group, S, D).sum(1).to(d.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward dK/dV then dQ. Works on flat tensors."""

    @staticmethod
    def forward(ctx, q, k, v, num_q_heads, window):
        qs = scale_q(q)
        out, lse = flash_fwd(qs, k, v, num_q_heads, window)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.num_q_heads, ctx.window = num_q_heads, window
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, out, lse = ctx.saved_tensors
        H, window = ctx.num_q_heads, ctx.window
        delta = (g.float() * out.float()).sum(-1)
        # Cotangent in the input dtype: bf16 p/ds product operands with
        # f32 accumulation, as the JAX backward does.
        g = g.to(qs.dtype).contiguous()
        dk, dv = flash_dkv(qs, k, v, g, lse, delta, H, window)
        dq = flash_dq(qs, k, v, g, lse, delta, H, window)
        return dq, _group_sum(dk, k.shape[0]), _group_sum(dv, v.shape[0]), \
            None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """Causal flash attention; [B, S, H, D] in and out, differentiable.

    Same contract as
    :func:`shockwave_tpu_torch.parallel.ring_attention.dense_causal_attention`.
    The sequence must be a multiple of 128 (:func:`flash_tiles`) and the
    head dim one of 16, 32, 64, 128; float32 or bfloat16.

    ``window`` restricts each token to its ``window`` most recent
    positions, itself included: row r attends cols (r-window, r]. k/v may
    carry fewer heads than q (grouped-query attention): query head h
    attends KV head h // (H // Hkv), and the KV tensors are never repeated
    per query head.
    """
    B, S, H, D = q.shape
    Hkv = _check_kv_heads(H, k.shape[2], v.shape[2])
    window = _resolve_window(window, S)

    def flat(x, h):
        return x.transpose(1, 2).reshape(B * h, S, D).contiguous()

    out = _FlashAttention.apply(
        flat(q, H), flat(k, Hkv), flat(v, Hkv), H, window
    )
    return out.view(B, H, S, D).transpose(1, 2)
