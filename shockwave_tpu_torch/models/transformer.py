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
model does. The MoE MLP, rematerialisation and the chunked head are
later slices of the port and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shockwave_tpu_torch.models.small_models import token_xent
from shockwave_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_tiles,
)
from shockwave_tpu_torch.parallel.ring_attention import (
    dense_causal_attention,
    ring_attention,
)
from shockwave_tpu_torch.parallel.ulysses import ulysses_attention

_LN_EPS = 1e-6  # flax.linen.LayerNorm's default
_LECUN_TRUNC = 0.87962566103423978  # stddev of a unit normal cut at +-2


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
    num_experts: int = 0  # > 0 (the MoE MLP) is not ported yet
    positional: str = "learned"  # "learned" | "rope"
    rope_base: float = 10000.0
    remat: bool = False
    remat_group: int = 1


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to shockwave_tpu_torch yet; see ROADMAP.md "
        "for the slice that brings it"
    )


def check_config(cfg: TransformerConfig) -> None:
    """Raise on every option this slice of the port does not cover."""
    if cfg.attention not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.num_experts > 0:
        raise _not_ported("the mixture-of-experts MLP (num_experts > 0)")
    if cfg.remat or cfg.remat_group != 1:
        raise _not_ported("rematerialisation (remat, remat_group)")
    if cfg.positional not in ("learned", "rope"):
        raise ValueError(
            f"positional must be 'learned' or 'rope', got {cfg.positional!r}"
        )
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32 or bfloat16, got {cfg.dtype}")


def apply_rope(x, base=10000.0):
    """Rotary position embedding over [B, S, H, D] (D even): rotate
    feature pairs (x_i, x_{i+D/2}) by pos * base^(-2i/D), with the angles
    in float32 whatever the activation dtype."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (2.0 * math.log(base) / D)
    )
    angles = (torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
              * freqs[None, :])
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1
    ).to(x.dtype)


def _dense(layer: nn.Linear, x, dtype):
    """Flax ``Dense(dtype=...)``: input and float32 kernel cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def _linear(d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False)


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
        if cfg.attention_window is not None and cfg.attention != "flash":
            raise ValueError(
                "attention_window is only supported by attention='flash'"
                f", got {cfg.attention!r}"
            )
        hd = self.head_dim
        self.query = _linear(cfg.d_model, cfg.num_heads * hd)
        self.key = _linear(cfg.d_model, self.kv_heads * hd)
        self.value = _linear(cfg.d_model, self.kv_heads * hd)
        self.out = _linear(cfg.d_model, cfg.d_model)

    def forward(self, x):
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        B, S, _ = x.shape
        group = cfg.num_heads // self.kv_heads

        def proj(layer, heads):
            return _dense(layer, x, dtype).view(B, S, heads, self.head_dim)

        q = proj(self.query, cfg.num_heads)
        k = proj(self.key, self.kv_heads)
        v = proj(self.value, self.kv_heads)
        if cfg.positional == "rope":
            q = apply_rope(q, cfg.rope_base)
            k = apply_rope(k, cfg.rope_base)
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
        return _dense(self.out, out.reshape(B, S, cfg.d_model), dtype)


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.in_ = _linear(cfg.d_model, cfg.d_ff)
        self.out = _linear(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        dtype = getattr(torch, self.cfg.dtype)
        h = F.gelu(_dense(self.in_, x, dtype), approximate="tanh")
        return _dense(self.out, h, dtype)


def _layer_norm(ln: nn.LayerNorm, x):
    """Flax ``LayerNorm(dtype=float32)``: statistics and output in f32."""
    return ln(x.float())


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)
        self.attention = Attention(cfg, mesh)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)
        self.mlp = Mlp(cfg)

    def forward(self, x):
        x = x + self.attention(_layer_norm(self.ln1, x))
        return x + self.mlp(_layer_norm(self.ln2, x))


class TransformerLM(nn.Module):
    """Logits [B, S, V] (float32) for tokens [B, S]. ``mesh``
    (``parallel/mesh.py``) is the grid ring and Ulysses attention shard over."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        check_config(cfg)
        self.config = cfg
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        if cfg.positional == "learned":
            self.positional = nn.Parameter(
                torch.empty(cfg.max_len, cfg.d_model)
            )
        self.blocks = nn.ModuleList(Block(cfg, mesh)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=_LN_EPS)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX model's initialisers, drawn from ``generator``:
        normal(0.02) tables and LeCun-normal (truncated) dense kernels.
        The numbers differ from JAX's for the same seed; tests carry JAX's
        parameters over with ``models/convert.py`` instead."""
        nn.init.normal_(self.embedding, std=0.02, generator=generator)
        if self.config.positional == "learned":
            nn.init.normal_(self.positional, std=0.02, generator=generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                std = math.sqrt(1.0 / module.in_features) / _LECUN_TRUNC
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def forward(self, tokens):
        cfg = self.config
        dtype = getattr(torch, cfg.dtype)
        x = self.embedding[tokens]
        if cfg.positional == "learned":
            x = x + self.positional[: tokens.shape[1]]
        x = x.to(dtype)
        for block in self.blocks:
            x = block(x)
        x = _layer_norm(self.ln_f, x)
        # Tied head: activation-dtype operands, float32 accumulation.
        head = self.embedding.to(dtype).float()
        return x.to(dtype).float() @ head.t()


def lm_loss(model: TransformerLM, tokens, logit_chunk=None):
    """Next-token cross entropy over a [B, S+1] token batch."""
    if logit_chunk is not None:
        raise _not_ported("the sequence-chunked head (logit_chunk)")
    logits = model(tokens[:, :-1])
    return token_xent(logits, tokens[:, 1:])
