"""Single-device causal attention reference.

Holds only ``dense_causal_attention``, the counterpart of
``shockwave_tpu/parallel/ring_attention.py::dense_causal_attention``. Ring
attention itself is a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import torch


def dense_causal_attention(q, k, v):
    """Causal attention over [B, S, H, D]; softmax in float32.

    The JAX version multiplies input-dtype operands with float32
    accumulation (``preferred_element_type``). Here the operands are
    upcast to float32 before the products, which is exact for bf16 values
    and computes the same function on the CPU and on the card (a bf16
    torch.matmul would round its output to bf16)."""
    B, S, H, D = q.shape
    # 1/sqrt(D) rounded to float32 in float32, as the JAX version does.
    scale = (1.0 / torch.sqrt(torch.tensor(float(D)))).item()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dead = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    scores = scores.masked_fill(dead, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
