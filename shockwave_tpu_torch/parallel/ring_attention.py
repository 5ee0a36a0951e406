"""Ring attention: exact causal attention over a sequence-sharded mesh axis.

The port's counterpart of ``shockwave_tpu/parallel/ring_attention.py``.
The sequence is cut into P shards along the mesh's "seq" axis, each on
its mesh device (``parallel/mesh.py``). Every shard keeps its block of Q
and the K/V blocks go round the ring: at hop i shard j holds the block of
shard j - i, moved to it from shard j - 1 at its small (grouped-query)
size. One process steps every shard's body in lockstep, hop by hop, as
``shard_map`` runs the JAX package's bodies, and autograd flows through
the hops and the merges.

Two hop bodies, selected by ``inner``:
- "flash": each hop is ``flash_attention_lse``, so the hop runs the flash
  kernels of ``ops/flash_attention.py``. Hop 0 (the shard's own block) is
  causal; a later hop is live only when its block lies wholly in the past
  (the source shard comes before this one) and then runs in the kernels'
  non-causal mode; a dead hop is skipped, with no launch and no merge.
  Hops merge in (out, lse) space in float32: out = sum_i out_i *
  exp(lse_i - logaddexp_i lse_i).
- "dense": the einsum body, which scores every hop (masked where the
  block lies in the causal future) with an online softmax in float32.

Over a gang's processes (a :class:`~shockwave_tpu_torch.parallel.mesh.
ProcessMesh`) each rank holds its own sequence shard and runs its shard's
body of the one-process version, with the same hops and merges; a hop
moves the K/V block to the next rank with ``torch.distributed``'s
isend/irecv, posted before the hop's launch so the exchange overlaps it
(``_RingHop``). In the backward pass the blocks' gradients go round the
ring the other way. ``_ring_attention_local`` and ``_ring_flash_local``
are the reference each rank's body equals.

``dense_causal_attention`` is the single-device reference the tests hold
both to.
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.ops.flash_attention import (
    flash_attention_lse,
    flash_tiles,
)
from shockwave_tpu_torch.parallel.mesh import ProcessMesh


def _block_attention(q, k, v, scale, mask):
    """Scores and value products for one (Q block, K/V block) pair.
    q: [B, Sq, H, D], k/v: [B, Sk, H, D], mask: [Sq, Sk] additive. The
    softmax state is float32; the products take float32 copies of the
    input-dtype operands (exact for bf16), as ``dense_causal_attention``
    does."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores + mask[None, None, :, :]
    block_max = scores.amax(-1)  # [B, H, Sq]
    # A fully masked row has block_max = -inf; any finite subtrahend keeps
    # exp(-inf) = 0 where subtracting it would give nan.
    safe_max = torch.where(torch.isfinite(block_max), block_max,
                           torch.zeros_like(block_max))
    probs = torch.exp(scores - safe_max[..., None])
    block_denom = probs.sum(-1)  # [B, H, Sq]
    block_out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                             v.float())
    return block_out, block_max, block_denom


def _scale(D: int) -> float:
    """1/sqrt(D) rounded to float32 in float32, as the JAX version does."""
    return (1.0 / torch.sqrt(torch.tensor(float(D)))).item()


def _rotate(blocks, devices):
    """One hop of the ring: shard j takes the block shard j - 1 held."""
    P = len(blocks)
    return [blocks[(j - 1) % P].to(devices[j]) for j in range(P)]


def _ring_attention_local(qs, ks, vs, devices, group: int = 1):
    """The dense body, every shard in lockstep: qs[j] [B, S, H, D] and
    ks[j]/vs[j] [B, S, H // group, D] on devices[j]; returns each shard's
    output. With group > 1 (grouped-query attention) the K/V blocks go
    round at their small size and are repeated to the query head count
    only for the hop's einsum."""
    P = len(qs)
    B, S, H, D = qs[0].shape
    scale = _scale(D)
    acc, m, l = [], [], []
    for q in qs:
        acc.append(torch.zeros(q.shape, dtype=torch.float32, device=q.device))
        m.append(torch.full((B, H, S), -torch.inf, device=q.device))
        l.append(torch.zeros((B, H, S), device=q.device))
    for i in range(P):
        for j in range(P):
            src = (j - i) % P
            q, dev = qs[j], devices[j]
            k, v = ks[j], vs[j]
            if group > 1:
                k = k.repeat_interleave(group, dim=2)
                v = v.repeat_interleave(group, dim=2)
            q_pos = j * S + torch.arange(S, device=dev)
            k_pos = src * S + torch.arange(S, device=dev)
            mask = torch.zeros((S, S), device=dev).masked_fill(
                k_pos[None, :] > q_pos[:, None], -torch.inf)
            blk_out, blk_max, blk_denom = _block_attention(q, k, v, scale,
                                                           mask)
            # Online softmax merge (running max m, normalizer l). A fully
            # masked block has max -inf: its correction exponents are
            # clamped and its scale zeroed, so it changes nothing.
            new_m = torch.maximum(m[j], blk_max)
            old_scale = torch.exp(torch.clamp(m[j] - new_m, -80.0, 0.0))
            blk_scale = torch.exp(torch.clamp(blk_max - new_m, -80.0, 0.0))
            empty = torch.isinf(blk_max) & (blk_max < 0)
            blk_scale = torch.where(empty, torch.zeros_like(blk_scale),
                                    blk_scale)
            new_m = torch.where(torch.isinf(new_m) & (new_m < 0), m[j], new_m)
            l[j] = l[j] * old_scale + blk_denom * blk_scale
            acc[j] = (acc[j] * old_scale.transpose(1, 2)[..., None]
                      + blk_out * blk_scale.transpose(1, 2)[..., None])
            m[j] = new_m
        if i < P - 1:
            ks, vs = _rotate(ks, devices), _rotate(vs, devices)
    return [(a / torch.clamp(n.transpose(1, 2)[..., None], min=1e-20))
            .to(q.dtype) for a, n, q in zip(acc, l, qs)]


def _ring_flash_local(qs, ks, vs, devices):
    """The flash body, every shard in lockstep. Hop 0 (the shard's own
    block) is the only causal hop. At hop i shard j holds the block of
    shard (j - i) mod P; it is live when that shard comes before j, and
    then merges as a non-causal partial result in (out, lse) space. Dead
    hops cost neither a launch nor merge arithmetic."""
    P = len(qs)
    acc, lse = [], []
    for q, k, v in zip(qs, ks, vs):
        out0, lse0 = flash_attention_lse(q, k, v, causal=True)
        acc.append(out0.float())
        lse.append(lse0)  # [B, H, S]; finite: every causal row sees a key
    for i in range(1, P):
        ks, vs = _rotate(ks, devices), _rotate(vs, devices)
        for j in range(P):
            if (j - i) % P >= j:  # the block lies in the causal future
                continue
            out_h, lse_h = flash_attention_lse(qs[j], ks[j], vs[j],
                                               causal=False)
            lse_new = torch.logaddexp(lse[j], lse_h)
            w_prev = torch.exp(lse[j] - lse_new).transpose(1, 2)[..., None]
            w_hop = torch.exp(lse_h - lse_new).transpose(1, 2)[..., None]
            acc[j] = acc[j] * w_prev + out_h.float() * w_hop
            lse[j] = lse_new
    return [a.to(q.dtype) for a, q in zip(acc, qs)]


class _RingHop(torch.autograd.Function):
    """One hop of the ring over processes, as a node of the autograd
    graph: the forward waits for the exchange ``pending`` (posted by
    ``mesh.shift_start`` before the previous hop's launch) and returns the
    K/V block it received from the previous rank; the backward sends the
    received block's gradients back to that rank and takes, from the next
    rank, the gradients of the block this rank sent. Every rank runs every
    hop's backward in the same order (a chain, hop P-1 first), so the
    exchanges pair up."""

    @staticmethod
    def forward(ctx, k, v, mesh, axis, pending):
        ctx.mesh, ctx.axis = mesh, axis
        k_recv, v_recv = mesh.shift_wait(pending)
        return k_recv, v_recv

    @staticmethod
    def backward(ctx, g_k, g_v):
        g_k, g_v = ctx.mesh.shift([g_k, g_v], ctx.axis, -1)
        return g_k, g_v, None, None, None


def _hops(k, v, mesh, axis):
    """The K/V block a rank holds at each hop of the ring over ``axis``,
    as a generator: hop 0's is its own; hop i's is rank (j - i)'s, and the
    next hop's exchange is posted before hop i's block is handed out, so
    the caller's launches on it overlap the exchange."""
    P = mesh.sizes[axis]
    pending = (mesh.shift_start([k.detach(), v.detach()], axis, 1)
               if P > 1 else None)
    yield k, v
    for i in range(1, P):
        k, v = _RingHop.apply(k, v, mesh, axis, pending)
        if i < P - 1:
            pending = mesh.shift_start([k.detach(), v.detach()], axis, 1)
        yield k, v


def _ring_flash_gang(q, k, v, mesh, axis):
    """This rank's body of :func:`_ring_flash_local` over processes: hop 0
    causal, a later hop live when its block lies wholly in the past, the
    (out, lse) merges in float32."""
    j = mesh.index(axis)
    acc = lse = None
    for i, (k_i, v_i) in enumerate(_hops(k, v, mesh, axis)):
        if i == 0:
            out0, lse = flash_attention_lse(q, k_i, v_i, causal=True)
            acc = out0.float()
        elif i <= j:  # the block of rank j - i >= 0 lies in the past
            out_h, lse_h = flash_attention_lse(q, k_i, v_i, causal=False)
            lse_new = torch.logaddexp(lse, lse_h)
            w_prev = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
            w_hop = torch.exp(lse_h - lse_new).transpose(1, 2)[..., None]
            acc = acc * w_prev + out_h.float() * w_hop
            lse = lse_new
    if j < mesh.sizes[axis] - 1:
        # The last hop is dead here but live on the last rank: a zero term
        # keeps its node in this rank's graph, so this rank's backward
        # takes part in that hop's exchange too.
        acc = acc + 0.0 * k_i.float().sum()
    return acc.to(q.dtype)


def _ring_dense_gang(q, k, v, mesh, axis):
    """This rank's body of :func:`_ring_attention_local` over processes:
    every hop scored (masked where its block lies in the causal future),
    merged by the online softmax in float32."""
    j = mesh.index(axis)
    B, S, H, D = q.shape
    group = H // k.shape[2]
    scale = _scale(D)
    dev = q.device
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), -torch.inf, device=dev)
    l = torch.zeros((B, H, S), device=dev)
    P = mesh.sizes[axis]
    for i, (k_i, v_i) in enumerate(_hops(k, v, mesh, axis)):
        src = (j - i) % P
        if group > 1:
            k_i = k_i.repeat_interleave(group, dim=2)
            v_i = v_i.repeat_interleave(group, dim=2)
        q_pos = j * S + torch.arange(S, device=dev)
        k_pos = src * S + torch.arange(S, device=dev)
        mask = torch.zeros((S, S), device=dev).masked_fill(
            k_pos[None, :] > q_pos[:, None], -torch.inf)
        blk_out, blk_max, blk_denom = _block_attention(q, k_i, v_i, scale,
                                                       mask)
        new_m = torch.maximum(m, blk_max)
        old_scale = torch.exp(torch.clamp(m - new_m, -80.0, 0.0))
        blk_scale = torch.exp(torch.clamp(blk_max - new_m, -80.0, 0.0))
        empty = torch.isinf(blk_max) & (blk_max < 0)
        blk_scale = torch.where(empty, torch.zeros_like(blk_scale), blk_scale)
        new_m = torch.where(torch.isinf(new_m) & (new_m < 0), m, new_m)
        l = l * old_scale + blk_denom * blk_scale
        acc = (acc * old_scale.transpose(1, 2)[..., None]
               + blk_out * blk_scale.transpose(1, 2)[..., None])
        m = new_m
    return (acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-20)
            ).to(q.dtype)


def _ring_gang(q, k, v, mesh, seq_axis, inner):
    """Ring attention over a gang's processes: q, k, v are this rank's
    sequence shard ``[batch, seq / P, heads, head_dim]`` (its batch rows
    are its data shard already, its heads its model shard); returns its
    shard of the output."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H and H % Hkv:
        raise ValueError(
            f"q heads ({H}) must be a multiple of kv heads ({Hkv})")
    if inner == "auto":
        inner = "flash" if flash_tiles(q.shape[1]) else "dense"
    if inner == "flash":
        return _ring_flash_gang(q, k, v, mesh, seq_axis)
    return _ring_dense_gang(q, k, v, mesh, seq_axis)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis: str = "seq",
    inner: str = "auto",
) -> torch.Tensor:
    """Causal ring attention over ``mesh``'s ``seq_axis``.

    q, k, v: [batch, seq, heads, head_dim], with k/v carrying as many
    heads as q or a divisor of them (grouped-query attention). The
    sequence shards over ``seq_axis``; batch shards over the mesh's first
    other axis and heads over the second, whatever the mesh calls them
    (``make_mesh`` names them "data" and "model"); further axes replicate,
    and their first index computes. Returns [batch, seq, heads, head_dim]
    on q's device.

    ``inner`` picks the hop body: "flash" (the flash kernels, dead hops
    skipped), "dense" (the einsum body), or "auto" (default): flash
    exactly when the local block ``seq / P`` tiles for the kernels
    (:func:`flash_tiles`).

    Over a :class:`~shockwave_tpu_torch.parallel.mesh.ProcessMesh` q, k, v
    are this rank's shard (``[batch, seq / P, heads, head_dim]``) and so
    is the output.
    """
    if inner not in ("auto", "flash", "dense"):
        raise ValueError(
            f"inner must be 'auto', 'flash' or 'dense', got {inner!r}"
        )
    if isinstance(mesh, ProcessMesh):
        return _ring_gang(q, k, v, mesh, seq_axis, inner)
    other_axes = [a for a in mesh.axis_names if a != seq_axis]
    batch_axis = other_axes[0] if len(other_axes) > 0 else None
    head_axis = other_axes[1] if len(other_axes) > 1 else None
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    P = mesh.shape[seq_axis]
    s_local = S // P
    if inner == "auto":
        inner = "flash" if flash_tiles(s_local) else "dense"
    if Hkv != H and H % Hkv:
        raise ValueError(
            f"q heads ({H}) must be a multiple of kv heads ({Hkv})"
        )
    group = H // Hkv
    nb = mesh.shape[batch_axis] if batch_axis else 1
    nh = mesh.shape[head_axis] if head_axis else 1
    if Hkv % nh:
        # K/V heads shard over the head axis at their grouped (small)
        # count, so that count bounds the usable mesh.
        raise ValueError(
            f"K/V head count ({Hkv}) must be divisible by the mesh's "
            f"{head_axis!r} axis size ({nh}): grouped-query K/V rotate "
            "sharded over that axis"
        )
    if S % P or B % nb:
        raise ValueError(
            f"batch {B} and sequence {S} must divide by the mesh's "
            f"{batch_axis!r} ({nb}) and {seq_axis!r} ({P}) axes"
        )
    bb, hq, hk = B // nb, H // nh, Hkv // nh
    rows = []
    for bi in range(nb):
        heads = []
        for hi in range(nh):
            place = {a: i for a, i in ((batch_axis, bi), (head_axis, hi))
                     if a is not None}
            devices = [mesh.device(**place, **{seq_axis: j})
                       for j in range(P)]

            def shards(x, h):
                return [x[bi * bb:(bi + 1) * bb, j * s_local:(j + 1) * s_local,
                          hi * h:(hi + 1) * h].to(devices[j])
                        for j in range(P)]

            qs, ks, vs = shards(q, hq), shards(k, hk), shards(v, hk)
            if inner == "flash":
                outs = _ring_flash_local(qs, ks, vs, devices)
            else:
                outs = _ring_attention_local(qs, ks, vs, devices, group)
            heads.append(torch.cat([o.to(q.device) for o in outs], dim=1))
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)


def dense_causal_attention(q, k, v):
    """Causal attention over [B, S, H, D]; softmax in float32.

    The JAX version multiplies input-dtype operands with float32
    accumulation (``preferred_element_type``). Here the operands are
    upcast to float32 before the products, which is exact for bf16 values
    and computes the same function on the CPU and on the card (a bf16
    torch.matmul would round its output to bf16)."""
    B, S, H, D = q.shape
    scale = _scale(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dead = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    scores = scores.masked_fill(dead, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
