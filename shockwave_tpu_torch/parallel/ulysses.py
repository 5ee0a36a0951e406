"""All-to-all (Ulysses-style) sequence parallelism.

The port's counterpart of ``shockwave_tpu/parallel/ulysses.py``. Ring
attention (``ring_attention.py``) keeps the sequence sharded and moves
K/V blocks hop by hop; Ulysses re-shards once per attention call: an
all-to-all over the "seq" mesh axis trades the sequence sharding for a
head sharding, so every shard holds the full sequence for H/P of the
heads, runs an ordinary causal attention locally, and a second
all-to-all restores the sequence sharding.

One process drives the mesh (``parallel/mesh.py``), as the ring does: an
all-to-all is a copy between the mesh's devices. Shard j's
``[B, S/P, H, D]`` block sends its head slice p to shard p, which
concatenates what it receives in shard order into ``[B, S, H/P, D]``, so
sequence blocks land in position order and the plain causal mask is
correct. The local attention is ``flash_attention`` (the causal flash
kernels of ``ops/flash_attention.py``), one launch a shard: a layer runs
P launches of each kernel, forward and backward, each over the full
sequence and H/P heads. Each (batch, head) tile computes what a flash
launch over every head computes for it. Where the sequence does not tile
for the kernels (:func:`flash_tiles`), the local body is
``dense_causal_attention``, as in the JAX package.

Over a gang's processes (a :class:`~shockwave_tpu_torch.parallel.mesh.
ProcessMesh`) each rank holds its sequence shard, and the all-to-alls are
``torch.distributed`` all-to-alls over the seq axis (``_AllToAll``, which
is differentiable: with equal pieces the all-to-all is its own adjoint),
around one flash launch a rank; each rank's body is its shard's body of
the one-process version.

Requires the local head count (after any split over the mesh's head
axis) to divide by the seq axis; grouped-query K/V heads must divide by
it too, so each shard's query heads meet their own K/V heads.
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.ops.flash_attention import flash_attention, flash_tiles
from shockwave_tpu_torch.parallel.mesh import ProcessMesh
from shockwave_tpu_torch.parallel.ring_attention import dense_causal_attention


def _all_to_all(blocks, devices, split_dim: int, concat_dim: int):
    """The tiled all-to-all of ``jax.lax.all_to_all`` over one process:
    shard p gets piece p (along ``split_dim``) of every shard's block,
    concatenated in shard order along ``concat_dim``, on devices[p]."""
    P = len(blocks)
    pieces = [b.chunk(P, dim=split_dim) for b in blocks]
    return [torch.cat([pieces[j][p].to(devices[p]) for j in range(P)],
                      dim=concat_dim)
            for p in range(P)]


class _AllToAll(torch.autograd.Function):
    """``mesh.all_to_all`` over ``axis`` of a ``[P, ...]`` tensor (piece p
    to rank p, received pieces stacked in source order). Its adjoint is
    the same all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


def _local_attention(q, k, v, local_attention: str):
    """One shard's causal attention over the full sequence."""
    if local_attention == "flash":
        return flash_attention(q, k, v)
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return dense_causal_attention(q, k, v)


def _ulysses_gang(q, k, v, mesh, axis, local_attention: str):
    """This rank's body of :func:`_ulysses_local` over processes: q, k, v
    are its ``[B, S/P, H, D]`` shard; returns its shard of the output."""
    P = mesh.sizes[axis]

    def scatter_heads(x):  # [B, S/P, H, D] -> [B, S, H/P, D]
        B, s, H, D = x.shape
        pieces = x.reshape(B, s, P, H // P, D).permute(2, 0, 1, 3, 4)
        got = _AllToAll.apply(pieces.contiguous(), mesh, axis)
        return got.permute(1, 0, 2, 3, 4).reshape(B, P * s, H // P, D)

    def gather_heads(x):  # [B, S, H/P, D] -> [B, S/P, H, D]
        B, S, h, D = x.shape
        pieces = x.reshape(B, P, S // P, h, D).permute(1, 0, 2, 3, 4)
        got = _AllToAll.apply(pieces.contiguous(), mesh, axis)
        return got.permute(1, 2, 0, 3, 4).reshape(B, S // P, P * h, D)

    out = _local_attention(scatter_heads(q), scatter_heads(k),
                           scatter_heads(v), local_attention)
    return gather_heads(out)


def _ulysses_local(qs, ks, vs, devices, local_attention: str):
    """Every shard's body in lockstep: qs[j]/ks[j]/vs[j] are shard j's
    ``[B, S/P, H, D]`` blocks on devices[j]; returns each shard's output
    block."""
    # [B, S/P, H, D] -> [B, S, H/P, D]
    qs = _all_to_all(qs, devices, split_dim=2, concat_dim=1)
    ks = _all_to_all(ks, devices, split_dim=2, concat_dim=1)
    vs = _all_to_all(vs, devices, split_dim=2, concat_dim=1)
    outs = [_local_attention(q, k, v, local_attention)
            for q, k, v in zip(qs, ks, vs)]
    # [B, S, H/P, D] -> [B, S/P, H, D]
    return _all_to_all(outs, devices, split_dim=1, concat_dim=2)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis: str = "seq",
    local_attention: str = "dense",
) -> torch.Tensor:
    """Causal attention with all-to-all sequence parallelism.

    The contract of :func:`ring_attention`: q/k/v are
    ``[batch, seq, heads, head_dim]`` with seq sharded on ``seq_axis``,
    batch on the mesh's first other axis and heads on the second
    (``make_mesh`` names them "data" and "model"); further axes
    replicate. ``local_attention`` selects the per-shard body: "dense" or
    "flash" (the flash kernels). Returns ``[batch, seq, heads,
    head_dim]`` on q's device. Over a :class:`~shockwave_tpu_torch.parallel.
    mesh.ProcessMesh` q, k, v are this rank's sequence shard, and so is the
    output.
    """
    if local_attention not in ("dense", "flash"):
        raise ValueError(
            f"local_attention must be 'dense' or 'flash', got "
            f"{local_attention!r}")
    if isinstance(mesh, ProcessMesh):
        # This rank's heads are its model shard already.
        P = mesh.sizes[seq_axis]
        if q.shape[2] % P or k.shape[2] % P:
            raise ValueError(
                f"{q.shape[2]} heads ({k.shape[2]} K/V heads) not divisible "
                f"by seq axis {seq_axis}={P}; use ring attention instead")
        if local_attention == "flash" and not flash_tiles(P * q.shape[1]):
            local_attention = "dense"
        return _ulysses_gang(q, k, v, mesh, seq_axis, local_attention)
    seq_par = mesh.shape[seq_axis]
    other_axes = [a for a in mesh.axis_names if a != seq_axis]
    batch_axis = other_axes[0] if len(other_axes) > 0 else None
    head_axis = other_axes[1] if len(other_axes) > 1 else None
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    nb = mesh.shape[batch_axis] if batch_axis else 1
    nh = mesh.shape[head_axis] if head_axis else 1
    if H % nh or Hkv % nh:
        raise ValueError(
            f"{H} heads ({Hkv} K/V heads) not divisible by mesh axis "
            f"{head_axis}={nh}")
    heads_local, kv_local = H // nh, Hkv // nh
    if heads_local % seq_par != 0:
        raise ValueError(
            f"{heads_local} local heads not divisible by seq axis "
            f"{seq_axis}={seq_par}; use ring attention instead")
    if kv_local % seq_par != 0:
        raise ValueError(
            f"{kv_local} local K/V heads not divisible by seq axis "
            f"{seq_axis}={seq_par}; use ring attention instead")
    if S % seq_par or B % nb:
        raise ValueError(
            f"batch {B} and sequence {S} must divide by the mesh's "
            f"{batch_axis!r} ({nb}) and {seq_axis!r} ({seq_par}) axes")
    # The gathered sequence is the global S, so the kernels' tiling
    # constraint resolves here, once.
    if local_attention == "flash" and not flash_tiles(S):
        local_attention = "dense"
    bb, s_local = B // nb, S // seq_par
    rows = []
    for bi in range(nb):
        heads = []
        for hi in range(nh):
            place = {a: i for a, i in ((batch_axis, bi), (head_axis, hi))
                     if a is not None}
            devices = [mesh.device(**place, **{seq_axis: j})
                       for j in range(seq_par)]

            def shards(x, h):
                return [x[bi * bb:(bi + 1) * bb,
                          j * s_local:(j + 1) * s_local,
                          hi * h:(hi + 1) * h].to(devices[j])
                        for j in range(seq_par)]

            outs = _ulysses_local(shards(q, heads_local),
                                  shards(k, kv_local), shards(v, kv_local),
                                  devices, local_attention)
            heads.append(torch.cat([o.to(q.device) for o in outs], dim=1))
        rows.append(_cat(heads, dim=2))
    return _cat(rows, dim=0)


def _cat(parts, dim: int):
    """``torch.cat`` that returns a lone part as it is, without a copy."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
