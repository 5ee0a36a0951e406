"""Pipeline parallelism over the "pipe" mesh axis: the GPipe schedule.

The port's counterpart of ``shockwave_tpu/parallel/pipeline.py``. The
transformer's blocks are grouped into S stages, every stage parameter
carrying a leading [S] axis, and M microbatches flow through them: at tick
t stage s runs microbatch t - s, so T = M + S - 1 ticks run S * M stage
applications and leave the bubble (S - 1) / (M + S - 1) idle
(:func:`schedule`). Microbatches split the
batch, so each stage sees whole sequences.

- In one process every stage runs on one device, tick by tick; S = 1
  takes the JAX package's shortcut, the bare stage a microbatch.
- Over a gang's processes (a :class:`~shockwave_tpu_torch.parallel.mesh.
  ProcessMesh` with a pipe axis of S ranks) rank s holds stage s
  (``PipelinedLM.shard_params``) and each tick's activations pass to the
  next rank with ``ProcessMesh.shift`` (``_PipeHop``, whose backward sends
  the gradients the other way, as ``ring_attention._RingHop`` does). The
  last stage's outputs reach every rank (``_FromLast``); ``PipelinedLM``
  runs its head on the last stage's rank and hands the logits (or, for
  ``loss``, the loss) on, and the
  parameters every rank holds (embedding, positions, final LayerNorm) take
  the sum of the ranks' gradients
  (``PipelinedLM.sum_replicated_gradients``).

``PipelinedLM`` is the flagship LM with its blocks pipelined, in the JAX
package's plain-function style: parameters are a dict of tensors
(``init``), and ``logits``, ``logits_sequential`` and ``loss`` are
functions of them. Its stage function applies the port's
``models/transformer.py::Block`` without the MoE's balance loss, so an MoE
config with ``moe_aux_weight > 0`` is refused, as there.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from shockwave_tpu_torch.parallel.mesh import ProcessMesh

AXIS = "pipe"


def schedule(num_stages: int, num_microbatches: int
             ) -> List[List[Tuple[int, int]]]:
    """GPipe's ticks: tick t lists the (stage, microbatch) pairs it runs,
    stage s on microbatch t - s."""
    S, M = num_stages, num_microbatches
    return [[(s, t - s) for s in range(S) if 0 <= t - s < M]
            for t in range(M + S - 1)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _stage(stage_params, s: int):
    return _tree_map(lambda p: p[s], stage_params)


class _PipeHop(torch.autograd.Function):
    """One tick's hand-over along the pipe axis: ``x`` goes to the next
    rank and the previous rank's comes back (the ring closes, and rank 0
    takes no input from it). The backward sends the received tensor's
    gradient to its sender and takes, from the next rank, the gradient of
    what this rank sent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.shift([x.detach()], axis, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift([g.contiguous()], ctx.axis, -1)[0], None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``x`` on every rank of the pipe axis (a
    broadcast). What follows is computed alike on every rank, so the
    gradient is the last rank's own; the others' is zero."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        import torch.distributed as dist

        from shockwave_tpu_torch.parallel.mesh import collective_in_place

        ctx.last = mesh.index(axis) == mesh.sizes[axis] - 1
        out = x.detach().clone()
        collective_in_place(dist.broadcast, out, mesh.members[axis][-1],
                            mesh.groups[axis])
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


def _gpipe_gang(stage_fn, stage_params, microbatches, mesh, axis):
    """This rank's stage of the schedule over the pipe axis: the outputs
    [M, mb, ...] on the last stage's rank, zeros on the others (each
    holding the last hand-over in its graph)."""
    S, s = mesh.sizes[axis], mesh.index(axis)
    M = microbatches.shape[0]
    params = _stage(stage_params, 0)
    outs, received = [], None
    for t in range(M + S - 1):
        m = t - s
        live = 0 <= m < M
        if live:
            x = microbatches[m] if s == 0 else received
            y = stage_fn(params, x).to(microbatches.dtype)
            if s == S - 1:
                outs.append(y)
        # A hand-over that carries nothing is still a node of the graph
        # (its zeros ask for a gradient), as every rank's backward must
        # run each tick's exchange.
        send = (y if live and s < S - 1
                else torch.zeros_like(microbatches[0], requires_grad=True))
        if received is not None:
            # Chains the ticks' hand-overs, so that every rank runs their
            # backward exchanges in the same (reverse) order.
            send = send + 0.0 * received.sum()
        received = _PipeHop.apply(send, mesh, axis)
    out = (torch.stack(outs) if s == S - 1
           else torch.zeros_like(microbatches))
    # The last hand-over stays in the graph of every rank.
    return out + 0.0 * received.sum()


def gpipe_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh=None,
    axis: str = AXIS,
) -> torch.Tensor:
    """Run microbatches through S pipelined stages.

    ``stage_fn(params_of_one_stage, x [mb, ...]) -> y [mb, ...]`` is one
    stage, the same activation shape and dtype in and out; every leaf of
    ``stage_params`` (a dict tree of tensors) has a leading [S] stage
    axis; ``microbatches`` is [M, mb, ...]. Returns the [M, mb, ...]
    outputs, microbatch-aligned with the input. With ``mesh`` a
    :class:`ProcessMesh` whose ``axis`` has S > 1 ranks, ``stage_params``
    is this rank's stage (leading axis 1) and the stages run across the
    ranks; the outputs reach every rank."""
    if isinstance(mesh, ProcessMesh) and mesh.sizes[axis] > 1:
        out = _gpipe_gang(stage_fn, stage_params, microbatches, mesh, axis)
        return _FromLast.apply(out, mesh, axis)
    S = _leaves(stage_params)[0].shape[0]
    M = microbatches.shape[0]
    if S == 1:
        # No bubble and no hand-over: the bare stage a microbatch.
        params0 = _stage(stage_params, 0)
        return torch.stack([stage_fn(params0, microbatches[m])
                            for m in range(M)])
    params = [_stage(stage_params, s) for s in range(S)]
    held = [None] * S  # what each stage handed over at the last tick
    outs = [None] * M
    for tick in schedule(S, M):
        handed = [None] * S
        for s, m in tick:
            x = microbatches[m] if s == 0 else held[s - 1]
            handed[s] = stage_fn(params[s], x)
            if s == S - 1:
                outs[m] = handed[s]
        held = handed
    return torch.stack(outs)


def sequential_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
) -> torch.Tensor:
    """Reference semantics: the stages back to back on one batch."""
    S = _leaves(stage_params)[0].shape[0]
    for s in range(S):
        x = stage_fn(_stage(stage_params, s), x)
    return x


def _init_block(block: nn.Module, generator) -> dict:
    """The JAX Block's initialisers on a fresh ``block``, drawn from
    ``generator``: LeCun-normal kernels and expert weights, LayerNorms at
    one and zero."""
    from shockwave_tpu_torch.models.layers import lecun_normal_
    from shockwave_tpu_torch.models.transformer import MoEMlp

    with torch.no_grad():
        for module in block.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
            elif isinstance(module, MoEMlp):
                for w in (module.w_in, module.w_out):
                    lecun_normal_(w, w.shape[0] * w.shape[1], generator)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
    return {k: v.detach().clone() for k, v in block.state_dict().items()}


class PipelinedLM:
    """The flagship transformer LM with its ``num_layers`` blocks grouped
    into ``num_stages`` stages of equal depth and pipelined over "pipe";
    the embedding, the final LayerNorm and the tied head run outside the
    pipeline. ``mesh``: a :class:`ProcessMesh` whose pipe axis has
    ``num_stages`` ranks runs one stage a rank; otherwise (None, or one
    process's ``Mesh``) every stage runs in this process."""

    def __init__(self, config, num_stages: int, num_microbatches: int,
                 mesh=None):
        from shockwave_tpu_torch.models.transformer import Block

        if config.num_layers % num_stages != 0:
            raise ValueError(
                f"{config.num_layers} layers not divisible into "
                f"{num_stages} stages"
            )
        if config.positional not in ("learned", "rope"):
            raise ValueError(
                f"positional must be 'learned' or 'rope', got "
                f"{config.positional!r}"
            )
        if config.num_experts > 0 and config.moe_aux_weight > 0.0:
            # The stage function drops each block's balance loss, so an
            # MoE promising one would train its router unbalanced.
            raise ValueError(
                "PipelinedLM does not thread the MoE load-balancing "
                "aux loss; set moe_aux_weight=0.0 to pipeline an MoE "
                "explicitly unbalanced"
            )
        self.config = config
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.mesh = mesh
        self.gang = (isinstance(mesh, ProcessMesh)
                     and mesh.sizes[AXIS] > 1)
        if self.gang and mesh.sizes[AXIS] != num_stages:
            raise ValueError(f"{num_stages} stages over a pipe axis of "
                             f"{mesh.sizes[AXIS]} ranks")
        self.layers_per_stage = config.num_layers // num_stages
        self._block = Block(config)

    # -- parameters -----------------------------------------------------
    def init(self, generator: Optional[torch.Generator], tokens) -> dict:
        """Whole parameters (every stage), drawn from ``generator``:
        ``blocks`` maps each Block parameter's name to [S, L, ...] (L
        layers a stage), beside ``embedding``, ``ln_f_scale``,
        ``ln_f_bias`` and, for learned positions, ``positional``."""
        from shockwave_tpu_torch.models.transformer import Block

        cfg = self.config
        S, L = self.num_stages, self.layers_per_stage
        drawn = [_init_block(Block(cfg), generator) for _ in range(S * L)]
        blocks = {name: torch.stack([d[name] for d in drawn]).reshape(
            (S, L) + drawn[0][name].shape) for name in drawn[0]}
        params = {
            "blocks": blocks,
            "embedding": torch.empty(cfg.vocab_size, cfg.d_model).normal_(
                std=0.02, generator=generator),
            "ln_f_scale": torch.ones(cfg.d_model),
            "ln_f_bias": torch.zeros(cfg.d_model),
        }
        if cfg.positional == "learned":
            params["positional"] = torch.empty(
                cfg.max_len, cfg.d_model).normal_(std=0.02,
                                                  generator=generator)
        return params

    def shard_params(self, params: dict) -> dict:
        """Over a gang's pipe axis, this rank's stage of the blocks (a
        leading axis of 1) and the rest whole; otherwise the parameters on
        the mesh's device."""
        if self.gang:
            s = self.mesh.index(AXIS)
            out = dict(params)
            out["blocks"] = _tree_map(lambda p: p[s:s + 1].contiguous(),
                                      params["blocks"])
            return out
        if self.mesh is not None and not isinstance(self.mesh, ProcessMesh):
            device = self.mesh.device()
            return _tree_map(lambda p: p.to(device), params)
        return params

    def sum_replicated_gradients(self, params: dict) -> None:
        """Over a gang's pipe axis, the parameters every rank holds take
        the sum of the ranks' gradients (the embedding's lookup on the
        first stage's rank, the head on the last's)."""
        if not self.gang:
            return
        for key, value in params.items():
            if key == "blocks":
                continue
            # A rank whose stage never used it holds no gradient: zero.
            grad = (value.grad if value.grad is not None
                    else torch.zeros_like(value))
            value.grad = self.mesh.all_reduce(grad, AXIS)

    # -- compute --------------------------------------------------------
    def _stage_fn(self, stage_params, x):
        from torch.func import functional_call

        for i in range(self.layers_per_stage):
            block = {name: p[i] for name, p in stage_params.items()}
            x = functional_call(self._block, block, (x,))[0]
        return x

    def _embed(self, params, tokens):
        x = params["embedding"][tokens]
        if "positional" in params:
            x = x + params["positional"][: tokens.shape[1]]
        return x

    def _head(self, params, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + 1e-6)
        x = x * params["ln_f_scale"] + params["ln_f_bias"]
        return x @ params["embedding"].t()

    def logits(self, params, tokens) -> torch.Tensor:
        """[B, S_len] tokens -> [B, S_len, vocab]; B must split into
        ``num_microbatches``."""
        M = self.num_microbatches
        B = tokens.shape[0]
        if B % M != 0:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        if not self.gang:
            x = self._embed(params, tokens)
            mb = x.reshape((M, B // M) + x.shape[1:])
            y = gpipe_apply(self._stage_fn, params["blocks"], mb)
            return self._head(params, y.reshape(x.shape))
        return self._from_last(params, tokens, lambda logits: logits,
                               tokens.shape + (self.config.vocab_size,))

    def _from_last(self, params, tokens, reduce, shape):
        """``reduce(logits)`` (of ``shape``) of the pipeline over a gang's
        pipe axis: the head and ``reduce`` on the last stage's rank, handed
        to every rank (zeros elsewhere carry the schedule's graph)."""
        M, B = self.num_microbatches, tokens.shape[0]
        x = self._embed(params, tokens)
        mb = x.reshape((M, B // M) + x.shape[1:])
        y = _gpipe_gang(self._stage_fn, params["blocks"], mb, self.mesh, AXIS)
        if self.mesh.index(AXIS) == self.mesh.sizes[AXIS] - 1:
            out = reduce(self._head(params, y.reshape(x.shape)))
        else:
            out = torch.zeros(shape, device=x.device) + 0.0 * y.sum()
        return _FromLast.apply(out, self.mesh, AXIS)

    def logits_sequential(self, params, tokens) -> torch.Tensor:
        """The stages back to back, unpipelined (in one process)."""
        x = self._embed(params, tokens)
        y = sequential_apply(self._stage_fn, params["blocks"], x)
        return self._head(params, y)

    def loss(self, params, tokens) -> torch.Tensor:
        from shockwave_tpu_torch.models.small_models import token_xent

        if not self.gang:
            return token_xent(self.logits(params, tokens[:, :-1]),
                              tokens[:, 1:])
        # Over the pipe axis only the loss, not the logits, is handed on.
        return self._from_last(
            params, tokens[:, :-1],
            lambda logits: token_xent(logits, tokens[:, 1:]), ())
