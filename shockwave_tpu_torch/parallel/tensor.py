"""Tensor parallelism over a gang's "model" axis.

The JAX package declares it (``shockwave_tpu/models/transformer.py``): the
Q/K/V kernels and the MLP's ``in`` are sharded by their outputs,
``(None, "model")``, the attention's and the MLP's ``out`` by their
inputs, ``("model", None)``, the tied embedding by its vocabulary rows,
and XLA inserts the collectives. Over a gang's processes
(``parallel/mesh.py::ProcessMesh``) the port places them by hand, as
autograd Functions around plain products:

- :func:`copy_to_model` before a column-parallel map: the identity
  forward, its backward the sum of the ranks' input gradients (each rank
  saw only its own columns' share of them);
- :func:`reduce_from_model` after a row-parallel map: the sum of the
  ranks' partial products forward, the identity backward;
- :func:`gather_from_model`: the ranks' pieces side by side forward, a
  rank's own piece of the gradient backward (what follows is replicated,
  so every rank holds the whole gradient already);
- :func:`vocab_embedding` and :func:`vocab_cross_entropy`: the lookup and
  the token cross entropy over vocabulary rows split across the ranks.

Every activation outside a sharded map is replicated over "model": the
ranks compute it alike, from the same all-reduced sums. A rank's tensors
are whatever device it trains on; the collectives stage a card's tensors
through host memory (``ProcessMesh.all_reduce``).
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.parallel.mesh import ProcessMesh

AXIS = "model"


def model_parallel(mesh) -> int:
    """The size of ``mesh``'s model axis over a gang's processes; 1 for a
    one-process mesh or none (whose model axis, if any, only splits heads
    across its devices)."""
    return mesh.sizes[AXIS] if isinstance(mesh, ProcessMesh) else 1


def model_range(size: int, mesh) -> tuple:
    """(first, end) of this rank's share of ``size`` rows split evenly
    over the model axis."""
    parts = model_parallel(mesh)
    if size % parts:
        raise ValueError(f"{size} does not divide over a model axis of "
                         f"{parts}")
    index = mesh.index(AXIS) if parts > 1 else 0
    share = size // parts
    return index * share, (index + 1) * share


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, AXIS), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        parts = mesh.all_gather(x, AXIS)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        pieces = g.chunk(ctx.mesh.sizes[AXIS], dim=ctx.dim)
        return pieces[ctx.mesh.index(AXIS)].contiguous(), None, None


def copy_to_model(x, mesh):
    """``x`` (replicated) as the input of a column-parallel map: the
    backward sums the ranks' gradients."""
    if model_parallel(mesh) == 1:
        return x
    return _Copy.apply(x, mesh)


def reduce_from_model(x, mesh):
    """The sum over the model axis of a row-parallel map's partial
    outputs; replicated from here on."""
    if model_parallel(mesh) == 1:
        return x
    return _Reduce.apply(x, mesh)


def gather_from_model(x, mesh, dim: int):
    """The ranks' pieces of ``x`` concatenated along ``dim`` in model
    order."""
    if model_parallel(mesh) == 1:
        return x
    return _Gather.apply(x, mesh, dim)


def vocab_embedding(table, tokens, mesh):
    """Rows of the vocabulary-sharded ``table`` ([V / M, d], this rank's
    rows) for ``tokens``: each rank looks up the tokens it holds, zeros
    elsewhere, and the sum over the model axis is the whole lookup."""
    if model_parallel(mesh) == 1:
        return table[tokens]
    first, end = model_range(table.shape[0] * model_parallel(mesh), mesh)
    mine = (tokens >= first) & (tokens < end)
    rows = table[torch.where(mine, tokens - first, 0)]
    return reduce_from_model(rows * mine[..., None].to(rows.dtype), mesh)


class _VocabXent(torch.autograd.Function):
    """Per-token cross entropy over vocabulary-sharded logits: logsumexp
    of the whole row (a max and a sum over the model axis) less the
    target's logit, which only its owner holds. A target outside the
    vocabulary picks nothing, as ``token_xent_sum`` does."""

    @staticmethod
    def forward(ctx, logits, targets, mesh):
        first, end = model_range(logits.shape[-1] * mesh.sizes[AXIS], mesh)
        row_max = mesh.all_reduce(logits.amax(dim=-1), AXIS, op="max")
        shifted = logits - row_max[..., None]
        exp = torch.exp(shifted)
        total = mesh.all_reduce(exp.sum(dim=-1), AXIS)
        mine = (targets >= first) & (targets < end)
        local = torch.where(mine, targets - first, 0)
        picked = shifted.gather(-1, local[..., None])[..., 0]
        picked = mesh.all_reduce(torch.where(mine, picked,
                                             torch.zeros_like(picked)), AXIS)
        ctx.save_for_backward(exp / total[..., None], mine, local)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, g):
        softmax, mine, local = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, local[..., None],
                          -mine[..., None].to(grad.dtype))
        return grad * g[..., None], None, None


def vocab_cross_entropy_sum(logits, targets, mesh):
    """``token_xent_sum`` of the whole logits, from this rank's vocabulary
    columns ``logits`` [..., V / M] (float32); replicated over the model
    axis."""
    return _VocabXent.apply(logits, targets, mesh).sum()
