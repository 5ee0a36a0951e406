"""The flagship workload: a decoder-only transformer LM, in PyTorch.

The port's counterpart of ``shockwave_tpu/models/transformer.py``, on
one card. Same configuration, parameters and numerics:

- Dense layers have no bias and float32 master weights; they compute in
  the activation dtype (input and weight cast down, output in that dtype).
- LayerNorm runs in float32 with epsilon 1e-6 (Flax's default, not
  torch's 1e-5), and its output stays float32 until the next layer casts.
- The MLP uses the tanh approximation of GELU (Flax's default).
- The residual stream is in the activation dtype from the embedding on.
- The tied output head multiplies activation-dtype operands with float32
  accumulation: the operands are upcast to float32, which is exact for
  bf16 values and the same function on the CPU and on the card.

Attention is ``dense``, ``flash`` (the CUDA kernels of
``ops/flash_attention.py``), ``ring`` (``parallel/ring_attention.py``
over the ``mesh`` the model is built with, its hops on the flash kernels
when the local block tiles) or ``ulysses`` (``parallel/ulysses.py``: two
all-to-alls over the mesh's seq axis around the causal flash kernels on
each shard's heads; it refuses grouped-query K/V, as the JAX model does);
flash falls back to dense for sequences that do not tile, as the JAX
model does.

``num_experts > 0`` replaces each block's MLP by the top-1 mixture of
experts (``MoEMlp``: float32 routing, capacity-bucketed ``torch.bmm``
products or the dense one-hot dispatch, the Switch balance loss that
``lm_loss`` adds). ``remat`` recomputes each block (or each group of
``remat_group`` blocks) in the backward pass (``torch.utils.checkpoint``),
and ``lm_loss(..., logit_chunk=c)`` evaluates the tied head and the loss
``c`` positions at a time, each chunk recomputed in the backward, so the
[B, S, vocab] logits never exist whole.

Over a gang's processes with a model axis of M ranks (a
:class:`~shockwave_tpu_torch.parallel.mesh.ProcessMesh`), the model is
tensor- and expert-parallel as the JAX model's annotations declare it
(``parallel/tensor.py``): a rank holds H / M query heads and its share of
the K/V heads (their Q/K/V columns and the output projection's rows), its
d_ff / M share of the MLP, V / M rows of the tied embedding and E / M
experts; LayerNorms, the learned positions and the router are whole on
every rank. Its heads go through the attention body as a one-rank model's
do (the flash kernels, or ring and Ulysses over the seq axis); the
row-parallel products are summed over "model", the experts' buckets are
gathered over it, and the head's loss is the vocabulary-parallel cross
entropy. ``model_shard_dim`` names the dimension each parameter splits
along; ``shard_state`` and ``gather_state`` turn whole parameters into a
rank's and back, so checkpoints hold whole ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from shockwave_tpu_torch.models.layers import lecun_normal_
from shockwave_tpu_torch.models.small_models import token_xent_sum
from shockwave_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_tiles,
)
from shockwave_tpu_torch.parallel.mesh import TOKENS, ProcessMesh
from shockwave_tpu_torch.parallel.ring_attention import (
    dense_causal_attention,
    ring_attention,
)
from shockwave_tpu_torch.parallel.tensor import (
    AXIS,
    copy_to_model,
    gather_from_model,
    model_parallel,
    model_range,
    reduce_from_model,
    vocab_cross_entropy_sum,
    vocab_embedding,
)
from shockwave_tpu_torch.parallel.ulysses import ulysses_attention

_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 1024
    d_model: int = 128
    num_heads: int = 4
    num_layers: int = 2
    d_ff: int = 512
    max_len: int = 512
    dtype: str = "float32"  # "bfloat16" for training on the card
    attention: str = "dense"  # "dense" | "flash" | "ring" | "ulysses"
    attention_window: Optional[int] = None
    num_kv_heads: Optional[int] = None
    num_experts: int = 0  # > 0: the top-1 MoE MLP (MoEMlp)
    moe_aux_weight: float = 1e-2  # the router balance loss's weight
    moe_capacity_factor: float = 1.25  # grouped dispatch's bucket size
    moe_dispatch: str = "grouped"  # "grouped" | "dense"
    positional: str = "learned"  # "learned" | "rope"
    rope_base: float = 10000.0
    remat: bool = False
    remat_group: int = 1


def check_config(cfg: TransformerConfig) -> None:
    """Raise on an option the model cannot run, with the JAX model's
    errors (which it raises at its first call)."""
    if cfg.attention not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.remat_group < 1:
        raise ValueError(f"remat_group must be >= 1, got {cfg.remat_group}")
    if cfg.remat_group > 1 and not cfg.remat:
        raise ValueError("remat_group > 1 requires remat=True")
    if cfg.remat and cfg.num_layers % cfg.remat_group:
        raise ValueError(
            f"remat_group ({cfg.remat_group}) must divide "
            f"num_layers ({cfg.num_layers})"
        )
    if cfg.positional not in ("learned", "rope"):
        raise ValueError(
            f"positional must be 'learned' or 'rope', got {cfg.positional!r}"
        )
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32 or bfloat16, got {cfg.dtype}")


def apply_rope(x, base=10000.0, offset: int = 0):
    """Rotary position embedding over [B, S, H, D] (D even): rotate
    feature pairs (x_i, x_{i+D/2}) by pos * base^(-2i/D), with the angles
    in float32 whatever the activation dtype. ``offset`` is the position
    of the first row (a sequence shard's place in the sequence)."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (2.0 * math.log(base) / D)
    )
    angles = ((torch.arange(S, dtype=torch.float32, device=x.device)
               + offset)[:, None] * freqs[None, :])
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1
    ).to(x.dtype)


def position_offset(mesh, seq_len: int) -> int:
    """The global position of a rank's first token: its sequence shard's
    place over a gang's processes, 0 in one process."""
    if isinstance(mesh, ProcessMesh):
        return mesh.index("seq") * seq_len
    return 0


# Parameters split over a gang's model axis, by name suffix: the
# dimension each splits along (the JAX model's "model" annotations).
_SHARD_DIMS = (
    ("embedding", 0),
    ("attention.query.weight", 0),
    ("attention.key.weight", 0),
    ("attention.value.weight", 0),
    ("attention.out.weight", 1),
    ("mlp.in_.weight", 0),
    ("mlp.out.weight", 1),
    ("moe.w_in", 0),
    ("moe.w_out", 0),
)


def model_shard_dim(name: str) -> Optional[int]:
    """The dimension parameter ``name`` splits along over the model axis;
    None for one that every rank holds whole."""
    for suffix, dim in _SHARD_DIMS:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def shard_state(state: dict, index: int, parts: int) -> dict:
    """Rank ``index``'s share (of ``parts`` on the model axis) of a whole
    state dict."""
    out = {}
    for name, value in state.items():
        dim = model_shard_dim(name)
        if dim is None or parts == 1:
            out[name] = value
        else:
            out[name] = value.chunk(parts, dim=dim)[index].contiguous()
    return out


def gather_state(state: dict, mesh) -> dict:
    """The whole parameters of a rank's ``state`` (every rank of the model
    axis calls it; each gets them)."""
    if model_parallel(mesh) == 1:
        return dict(state)
    out = {}
    for name, value in state.items():
        dim = model_shard_dim(name)
        if dim is None:
            out[name] = value
        else:
            parts = mesh.all_gather(value, AXIS)
            out[name] = torch.cat(list(parts.unbind(0)), dim=dim)
    return out


def _dense(layer: nn.Linear, x, dtype):
    """Flax ``Dense(dtype=...)``: input and float32 kernel cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def _linear(d_in: int, d_out: int) -> nn.Linear:
    # Uninitialised: ``TransformerLM.reset_parameters`` draws the weights
    # (or a checkpoint fills them), so torch's own draw would be wasted.
    return torch.nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.head_dim = cfg.d_model // cfg.num_heads
        self.kv_heads = (cfg.num_heads if cfg.num_kv_heads is None
                         else cfg.num_kv_heads)
        if self.kv_heads < 1 or cfg.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads ({self.kv_heads}) must be >= 1 and divide "
                f"num_heads ({cfg.num_heads})"
            )
        # This rank's heads (all of them off a gang's model axis).
        tp = model_parallel(mesh)
        if self.kv_heads % tp:
            raise ValueError(
                f"{cfg.num_heads} heads ({self.kv_heads} K/V heads) do not "
                f"divide over a model axis of {tp}")
        self.heads, self.heads_kv = cfg.num_heads // tp, self.kv_heads // tp
        if (isinstance(mesh, ProcessMesh) and mesh.sizes["seq"] > 1
                and cfg.attention not in ("ring", "ulysses")):
            raise ValueError(
                "a sequence sharded over a gang's processes needs ring or "
                f"ulysses attention, got {cfg.attention!r}")
        if cfg.attention_window is not None and cfg.attention != "flash":
            raise ValueError(
                "attention_window is only supported by attention='flash'"
                f", got {cfg.attention!r}"
            )
        hd = self.head_dim
        self.query = _linear(cfg.d_model, self.heads * hd)
        self.key = _linear(cfg.d_model, self.heads_kv * hd)
        self.value = _linear(cfg.d_model, self.heads_kv * hd)
        self.out = _linear(self.heads * hd, cfg.d_model)

    def forward(self, x):
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        B, S, _ = x.shape
        group = cfg.num_heads // self.kv_heads
        x = copy_to_model(x, self.mesh)

        def proj(layer, heads):
            return _dense(layer, x, dtype).view(B, S, heads, self.head_dim)

        q = proj(self.query, self.heads)
        k = proj(self.key, self.heads_kv)
        v = proj(self.value, self.heads_kv)
        if cfg.positional == "rope":
            offset = position_offset(self.mesh, S)
            q = apply_rope(q, cfg.rope_base, offset)
            k = apply_rope(k, cfg.rope_base, offset)
        if self.kv_heads != cfg.num_heads and cfg.attention == "ulysses":
            # Ulysses reshards the head dim in its all-to-alls; the JAX
            # model refuses grouped-query K/V there.
            raise ValueError(
                "num_kv_heads != num_heads is not supported by the "
                "'ulysses' path; use 'flash', 'dense' or 'ring'"
            )
        if cfg.attention == "ring":
            if self.mesh is None:
                raise ValueError("ring attention requires a mesh")
            out = ring_attention(q, k, v, self.mesh)
        elif cfg.attention == "ulysses":
            if self.mesh is None:
                raise ValueError("ulysses attention requires a mesh")
            out = ulysses_attention(q, k, v, self.mesh,
                                    local_attention="flash")
        elif cfg.attention == "flash" and flash_tiles(S):
            out = flash_attention(q, k, v, window=cfg.attention_window)
        else:
            if cfg.attention_window is not None:
                raise ValueError(
                    "attention_window needs a flash-tiling sequence "
                    f"(multiple of 128), got {S}"
                )
            if group > 1:
                k = k.repeat_interleave(group, dim=2)
                v = v.repeat_interleave(group, dim=2)
            out = dense_causal_attention(q, k, v)
        out = _dense(self.out, out.reshape(B, S, self.heads * self.head_dim),
                     dtype)
        return reduce_from_model(out, self.mesh)


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        first, end = model_range(cfg.d_ff, mesh)
        self.in_ = _linear(cfg.d_model, end - first)
        self.out = _linear(end - first, cfg.d_model)

    def forward(self, x):
        dtype = getattr(torch, self.cfg.dtype)
        x = copy_to_model(x, self.mesh)
        h = F.gelu(_dense(self.in_, x, dtype), approximate="tanh")
        return reduce_from_model(_dense(self.out, h, dtype), self.mesh), None


def expert_capacity(tokens: int, num_experts: int,
                    capacity_factor: float) -> int:
    """Tokens a bucket holds: ceil(cf * N / E) rounded up to a multiple
    of 8 and at most N; N when N < 8."""
    if tokens < 8:
        return tokens
    c = int(math.ceil(capacity_factor * tokens / num_experts))
    return min(-(-c // 8) * 8, tokens)


def expert_slots(top, num_experts: int, capacity: int):
    """Each token's row in the [E * C] buckets, in token order: its
    expert's bucket at the running count of earlier tokens routed there,
    or ``E * C`` (dropped) at or past the capacity."""
    one_hot = F.one_hot(top, num_experts)
    pos = (torch.cumsum(one_hot, dim=0) * one_hot).sum(dim=-1) - 1
    return torch.where(pos < capacity, top * capacity + pos,
                       num_experts * capacity)


class MoEMlp(nn.Module):
    """Token-choice top-1 mixture of experts (the JAX package's
    ``MoEMlp``). The router runs in float32 and picks the first largest
    gate; the chosen gate's probability scales the expert's output.
    ``grouped`` dispatch scatters each token into its expert's bucket of
    ``expert_capacity`` rows, runs the experts as two ``torch.bmm`` over
    [E, C, d] and gathers back; tokens past an expert's capacity get zero
    (the residual passes). ``dense`` dispatch runs every expert on every
    token and masks. ``forward`` returns the output and the Switch
    balance loss ``E * sum_e f_e * P_e``; ``dropped`` holds the share of
    the last call's tokens dropped and ``balance`` its balance loss (both
    detached scalars).

    In a gang (``mesh`` a :class:`~shockwave_tpu_torch.parallel.mesh.
    ProcessMesh`) the global batch is one routing problem, as under the
    JAX program's global arrays: the capacity is the global token count's,
    a token's place in its expert's bucket counts every token routed there
    before it in the global batch's order (rows of the data shards in rank
    order, each row's sequence shards in seq order; an all-gather of the
    per-row counts), and the balance loss's dispatched fractions and mean
    gates and the dropped share are the global batch's (all-reduces). Each
    rank's balance loss carries the gradient of its own tokens' gates
    scaled by the world size, which the gang's gradient average takes
    back out.

    With a model axis of M ranks, a rank holds E / M experts: it routes
    every token (the router is whole), runs its experts' buckets, and the
    buckets' outputs are gathered over "model" before each token takes its
    row back, as the JAX model's buckets shard over "model"."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        if cfg.moe_dispatch not in ("grouped", "dense"):
            raise ValueError(
                f"moe_dispatch must be 'grouped' or 'dense', got "
                f"{cfg.moe_dispatch!r}"
            )
        if cfg.moe_capacity_factor <= 0:
            raise ValueError(
                f"moe_capacity_factor must be > 0, got "
                f"{cfg.moe_capacity_factor}"
            )
        self.cfg = cfg
        self.gang = mesh if isinstance(mesh, ProcessMesh) else None
        E = cfg.num_experts
        self.router = _linear(cfg.d_model, E)
        self.experts = model_range(E, mesh)  # this rank's [first, end)
        mine = self.experts[1] - self.experts[0]
        self.w_in = nn.Parameter(torch.empty(mine, cfg.d_model, cfg.d_ff))
        self.w_out = nn.Parameter(torch.empty(mine, cfg.d_ff, cfg.d_model))
        self.dropped = None
        self.balance = None

    def _balance_loss(self, one_hot, weights, tokens: int):
        """E * sum_e f_e * P_e over the global batch of ``tokens``."""
        E = self.cfg.num_experts
        gang = self.gang
        if gang is None:
            return E * torch.sum(one_hot.mean(dim=(0, 1))
                                 * weights.mean(dim=(0, 1)))
        frac = gang.all_reduce(one_hot.sum(dim=(0, 1)), TOKENS) / tokens
        local = weights.sum(dim=(0, 1)) / tokens
        # The global mean gate in value; the gradient of this rank's gates
        # times the token shards' count, which the gradient average over
        # every rank (the model axis's copies included) divides out.
        shards = _token_shards(gang)
        prob = shards * local + (gang.all_reduce(local, TOKENS)
                                 - shards * local).detach()
        return E * torch.sum(frac * prob)

    def _gang_slots(self, top, capacity: int):
        """Each of this rank's tokens' row in the [E * C] buckets, counted
        in the global batch's token order (``expert_slots`` over the whole
        batch), or ``E * C`` (dropped)."""
        gang, E = self.gang, self.cfg.num_experts
        B = top.shape[0]
        one_hot = F.one_hot(top, E)  # [B, s, E]
        counts = gang.all_gather(one_hot.sum(dim=1), TOKENS).view(
            gang.sizes["data"], gang.sizes["seq"], B, E)
        d, j = gang.index("data"), gang.index("seq")
        rows = counts[d].sum(dim=0)  # [B, E]: each row of this data shard
        offset = (counts[:d].sum(dim=(0, 1, 2)) + rows.cumsum(dim=0) - rows
                  + counts[d, :j].sum(dim=0))  # [B, E]
        pos = ((torch.cumsum(one_hot, dim=1) * one_hot).sum(dim=-1) - 1
               + offset.gather(1, top))
        return torch.where(pos < capacity, top * capacity + pos,
                           E * capacity).reshape(-1)

    def forward(self, x):
        cfg = self.cfg
        E = cfg.num_experts
        B, S, d = x.shape
        N = B * S
        tokens = N * (_token_shards(self.gang) if self.gang is not None
                      else 1)
        weights = torch.softmax(F.linear(x.float(), self.router.weight),
                                dim=-1)
        top = torch.argmax(weights, dim=-1)  # [B, S]
        one_hot = F.one_hot(top, E).float()
        gate_scale = torch.sum(weights * one_hot, dim=-1, keepdim=True)
        aux = self._balance_loss(one_hot, weights, tokens)
        self.balance = aux.detach()
        w_in, w_out = self.w_in.to(x.dtype), self.w_out.to(x.dtype)
        first, end = self.experts
        # The experts' input: its gradient sums the model axis's experts.
        x_in = copy_to_model(x, self.gang)
        if cfg.moe_dispatch == "dense":
            dispatch = one_hot[..., first:end].to(x.dtype)
            hidden = F.gelu(torch.einsum("bse,bsd,edf->bsf", dispatch, x_in,
                                         w_in), approximate="tanh")
            out = torch.einsum("bse,bsf,efd->bsd", dispatch, hidden, w_out)
            out = reduce_from_model(out, self.gang)
            self.dropped = torch.zeros((), device=x.device)
            return out * gate_scale.to(x.dtype), aux
        C = expert_capacity(tokens, E, cfg.moe_capacity_factor)
        if self.gang is None:
            slot = expert_slots(top.reshape(N), E, C)
            self.dropped = (slot == E * C).float().mean().detach()
        else:
            slot = self._gang_slots(top, C)
            self.dropped = self.gang.all_reduce(
                (slot == E * C).float().sum(), TOKENS) / tokens
        # Row E * C is where dropped tokens land; it is cut off before the
        # products and reads back as zeros.
        buckets = x.new_zeros(E * C + 1, d).index_copy(0, slot,
                                                       x_in.reshape(N, d))
        mine = buckets[first * C:end * C].view(end - first, C, d)
        hidden = F.gelu(torch.bmm(mine, w_in), approximate="tanh")
        out = torch.bmm(hidden, w_out).reshape((end - first) * C, d)
        # Every expert's bucket, from the ranks that hold them.
        out = gather_from_model(out, self.gang, dim=0)
        y = torch.cat([out, out.new_zeros(1, d)])[slot]
        return y.reshape(B, S, d) * gate_scale.to(x.dtype), aux


def _token_shards(gang: ProcessMesh) -> int:
    """How many ranks hold different tokens: the data and seq places."""
    return gang.sizes["data"] * gang.sizes["seq"]


def _layer_norm(ln: nn.LayerNorm, x):
    """Flax ``LayerNorm(dtype=float32)``: statistics and output in f32."""
    return ln(x.float())


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)
        self.attention = Attention(cfg, mesh)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)
        if cfg.num_experts > 0:
            self.moe = MoEMlp(cfg, mesh)
        else:
            self.mlp = Mlp(cfg, mesh)

    def forward(self, x):
        """(output, the MoE balance loss or None)."""
        x = x + self.attention(_layer_norm(self.ln1, x))
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        # The MoE runs on the float32 LayerNorm output (as the JAX model's
        # does), so its output, and the residual from here on, is float32.
        y, aux = mlp(_layer_norm(self.ln2, x))
        return x + y, aux


def _run_blocks(blocks, x):
    auxes = []
    for block in blocks:
        x, aux = block(x)
        auxes.append(aux)
    return x, auxes


class TransformerLM(nn.Module):
    """Logits [B, S, V] (float32) for tokens [B, S]. ``mesh``
    (``parallel/mesh.py``) is the grid ring and Ulysses attention shard over;
    over a gang's processes the tokens are this rank's sequence shard, and
    its positions (learned or rotary) are the shard's global ones, and with
    a model axis the rank holds its share of the parameters (the module
    docstring). ``generator`` draws the whole parameters, which a rank then
    keeps its share of, so every gang shape starts from one process's
    weights. ``draw=False`` leaves them uninitialised, for a checkpoint to
    fill (a resumed run skips the draw, as the JAX program builds only its
    state's template then)."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 draw: bool = True):
        super().__init__()
        check_config(cfg)
        self.config = cfg
        self.mesh = mesh
        rows = model_range(cfg.vocab_size, mesh)
        self.embedding = nn.Parameter(torch.empty(rows[1] - rows[0],
                                                  cfg.d_model))
        if cfg.positional == "learned":
            self.positional = nn.Parameter(
                torch.empty(cfg.max_len, cfg.d_model)
            )
        self.blocks = nn.ModuleList(Block(cfg, mesh)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)
        if draw:  # else uninitialised, for a checkpoint to fill
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX model's initialisers, drawn from ``generator``:
        normal(0.02) tables and LeCun-normal (truncated) dense kernels and
        expert weights. The numbers differ from JAX's for the same seed;
        tests carry JAX's parameters over with ``models/convert.py``
        instead."""
        parts = model_parallel(self.mesh)
        index = self.mesh.index(AXIS) if parts > 1 else 0

        def draw(name, param, init):
            """``init(whole, its shape)`` on the whole parameter; this
            rank keeps its share."""
            dim = model_shard_dim(name) if parts > 1 else None
            if dim is None:
                init(param, param.shape)
                return
            shape = list(param.shape)
            shape[dim] *= parts
            whole = torch.empty(shape)
            init(whole, shape)
            param.copy_(whole.chunk(parts, dim=dim)[index])

        def normal(w, shape):
            nn.init.normal_(w, std=0.02, generator=generator)

        draw("embedding", self.embedding, normal)
        if self.config.positional == "learned":
            draw("positional", self.positional, normal)
        for prefix, module in self.named_modules():
            if isinstance(module, nn.Linear):
                draw(f"{prefix}.weight", module.weight,
                     lambda w, shape: lecun_normal_(w, shape[1], generator))
            elif isinstance(module, MoEMlp):
                # flax's fan-in of an [E, in, out] kernel is E * in.
                for name in ("w_in", "w_out"):
                    draw(f"{prefix}.{name}", getattr(module, name),
                         lambda w, shape: lecun_normal_(
                             w, shape[0] * shape[1], generator))
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def trunk(self, tokens):
        """The final LayerNorm's output [B, S, d] (float32) and each
        block's MoE balance loss (None for a dense MLP)."""
        cfg = self.config
        dtype = getattr(torch, cfg.dtype)
        x = vocab_embedding(self.embedding, tokens, self.mesh)
        if cfg.positional == "learned":
            offset = position_offset(self.mesh, tokens.shape[1])
            x = x + self.positional[offset:offset + tokens.shape[1]]
        x = x.to(dtype)
        if cfg.remat:
            auxes = []
            for i in range(0, cfg.num_layers, cfg.remat_group):
                group = self.blocks[i:i + cfg.remat_group]
                x, aux = checkpoint(_run_blocks, group, x, use_reentrant=False)
                auxes += aux
        else:
            x, auxes = _run_blocks(self.blocks, x)
        return _layer_norm(self.ln_f, x), auxes

    def head(self, x):
        """Tied head: activation-dtype operands, float32 accumulation. With
        a model axis, the logits of this rank's vocabulary rows."""
        dtype = getattr(torch, self.config.dtype)
        x = copy_to_model(x, self.mesh)
        return x.to(dtype).float() @ self.embedding.to(dtype).float().t()

    def xent_sum(self, x, targets):
        """``token_xent_sum`` of the head's logits for ``x``."""
        if model_parallel(self.mesh) == 1:
            return token_xent_sum(self.head(x), targets)
        return vocab_cross_entropy_sum(self.head(x), targets, self.mesh)

    def forward(self, tokens):
        logits = self.head(self.trunk(tokens)[0])
        return gather_from_model(logits, self.mesh, dim=-1)


def lm_loss(model: TransformerLM, tokens, logit_chunk=None):
    """Next-token cross entropy over a [B, S+1] token batch, plus
    ``moe_aux_weight`` times the mean of the layers' balance losses when
    the model is MoE. With ``logit_chunk`` the head and the loss run that
    many positions at a time, each chunk recomputed in the backward; the
    sum is divided once by B * S."""
    cfg = model.config
    targets = tokens[:, 1:]
    x, auxes = model.trunk(tokens[:, :-1])
    if logit_chunk is None:
        loss = model.xent_sum(x, targets) / targets.numel()
    else:
        B, S = targets.shape
        chunk = int(logit_chunk)
        if chunk < 1 or S % chunk:
            raise ValueError(
                f"logit_chunk ({chunk}) must be >= 1 and divide the "
                f"sequence ({S})"
            )

        def chunk_loss(xc, tc):
            return model.xent_sum(xc, tc)

        total = 0.0
        for start in range(0, S, chunk):
            total = total + checkpoint(
                chunk_loss, x[:, start:start + chunk],
                targets[:, start:start + chunk], use_reentrant=False)
        loss = total / (B * S)
    if cfg.num_experts > 0 and cfg.moe_aux_weight > 0.0:
        loss = loss + cfg.moe_aux_weight * (sum(auxes) / len(auxes))
    return loss
