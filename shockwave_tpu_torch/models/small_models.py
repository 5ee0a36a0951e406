"""Losses shared by the workload families.

So far only the token cross entropy of
``shockwave_tpu/models/small_models.py``; the other families (LSTM LM,
NeuMF, A3C, CycleGAN) are a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import torch


def token_xent_sum(logits, targets):
    """Sum (not mean) of the token cross entropy: logsumexp minus the
    target's logit. Same contract as the JAX version: a target outside
    [0, vocab) selects nothing (its term is the bare logsumexp); there is
    no ignore index."""
    lse = torch.logsumexp(logits, dim=-1)
    vocab = logits.shape[-1]
    valid = (targets >= 0) & (targets < vocab)
    picked = logits.gather(-1, targets.clamp(0, vocab - 1)[..., None])[..., 0]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    return torch.sum(lse - picked)


def token_xent(logits, targets):
    """Mean next-token cross entropy over every target."""
    return token_xent_sum(logits, targets) / targets.numel()
