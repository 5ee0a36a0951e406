"""The port's flash_attention_lse against the JAX package's, on the CPU.

The non-causal mode (every query attends the whole K/V block, Sk may
differ from Sq) is the ring-attention hop; the lse output is
differentiable. The same numpy inputs go through the JAX Pallas kernels
(interpret mode, 128-wide blocks) and through the port's wrappers, which
take their plain PyTorch versions for CPU tensors. The loss uses both
outputs, so the lse cotangent g_lse is not zero and its fold into the
backward's delta is exercised.

Tolerances, float32 throughout, as tests/test_torch_flash_attention.py
states them: summation order only, 2e-5 on out and lse (values of order
1 and 10), 1e-4 on the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.ops.flash_attention import (
    flash_attention_lse as jax_flash_attention_lse,
)
from shockwave_tpu_torch.ops import flash_attention as fa

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, Sq, Sk, H, kv_heads, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, kv_heads, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, kv_heads, D)).astype(np.float32)
    w = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    u = rng.normal(size=(B, H, Sq)).astype(np.float32)
    return q, k, v, w, u


@pytest.mark.parametrize(
    "B,Sq,Sk,H,kv_heads,causal",
    [
        (1, 128, 128, 2, 2, False),   # Sq = Sk
        (2, 128, 256, 2, 2, False),   # Sk != Sq: two k tiles a row
        (1, 256, 128, 4, 2, False),   # GQA, groups of 2, Sq > Sk
        (1, 256, 256, 4, 2, True),    # the causal mode through its lse
    ],
    ids=["square", "sk-longer", "gqa", "causal"],
)
def test_out_lse_and_grads_through_lse_match_jax(B, Sq, Sk, H, kv_heads,
                                                  causal):
    D = 16
    q, k, v, w, u = _inputs(Sq + Sk + kv_heads, B, Sq, Sk, H, kv_heads, D)

    def jax_loss(q, k, v):
        out, lse = jax_flash_attention_lse(q, k, v, block_q=128,
                                           block_k=128, causal=causal)
        return jnp.sum(out * w) + jnp.sum(lse * u)

    j_out, j_lse = jax_flash_attention_lse(q, k, v, block_q=128, block_k=128,
                                           causal=causal)
    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = fa.flash_attention_lse(tq, tk, tv, causal=causal)
    assert out.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    (torch.sum(out * torch.from_numpy(w))
     + torch.sum(lse * torch.from_numpy(u))).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **OUT_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(j_lse),
                               **OUT_TOL)
    for t, j in zip((tq, tk, tv), j_grads):
        assert t.grad.shape == j.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


def test_non_causal_lse_is_the_logsumexp_of_every_score():
    """Non-causal, each row's lse is logsumexp over all Sk keys of
    q.k / sqrt(D), and out is its softmax against v (float64 check of
    the plain versions, GQA groups of 2)."""
    q, k, v, _, _ = _inputs(11, 1, 128, 384, 4, 2, 32)
    out, lse = fa.flash_attention_lse(*(torch.from_numpy(x) for x in
                                         (q, k, v)), causal=False)
    kx = np.repeat(k, 2, axis=2).astype(np.float64)
    vx = np.repeat(v, 2, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kx) / np.sqrt(32)
    ref_lse = np.log(np.exp(s).sum(-1))
    ref_out = np.einsum("bhqk,bkhd->bqhd", np.exp(s - ref_lse[..., None]),
                        vx)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **OUT_TOL)
    np.testing.assert_allclose(out.numpy(), ref_out, **OUT_TOL)


def test_flash_attention_is_the_causal_lse_entry():
    """flash_attention is flash_attention_lse's out, through one backward
    whose discarded lse folds nothing into delta: equal bit for bit."""
    q, k, v, w, _ = _inputs(5, 1, 256, 256, 2, 1, 16)
    grads = []
    for entry in (lambda *a: fa.flash_attention(*a),
                  lambda *a: fa.flash_attention_lse(*a)[0]):
        args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = entry(*args)
        (out * torch.from_numpy(w)).sum().backward()
        grads.append([out.detach()] + [a.grad for a in args])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["jax", "torch"])
def test_rejects_a_causal_length_mismatch_and_a_non_causal_window(entry):
    """Both packages refuse causal attention with Sq != Sk and a window
    without causality."""
    q, k, v, _, _ = _inputs(0, 1, 128, 256, 2, 2, 16)
    q2, k2, v2, _, _ = _inputs(0, 1, 128, 128, 2, 2, 16)
    if entry == "jax":
        def call(q, k, v, **kw):
            return jax_flash_attention_lse(q, k, v, block_q=128, block_k=128,
                                           **kw)
    else:
        def call(q, k, v, **kw):
            return fa.flash_attention_lse(
                *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    with pytest.raises(ValueError, match="matching q/k lengths"):
        call(q, k, v, causal=True)
    with pytest.raises(ValueError, match="window requires causal"):
        call(q2, k2, v2, causal=False, window=64)


def test_flat_wrappers_check_the_mode():
    """The kernel wrappers refuse what the kernels do not take: a causal
    call with Sq != Sk, a window without causality, a k/v length that
    does not tile."""
    qs = torch.zeros(2, 128, 16)
    k = torch.zeros(2, 256, 16)
    with pytest.raises(ValueError, match="matching q/k lengths"):
        fa.flash_fwd(qs, k, k, 2, None, causal=True)
    with pytest.raises(ValueError, match="window requires causal"):
        fa.flash_fwd(qs, qs, qs, 2, 64, causal=False)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_fwd(qs, torch.zeros(2, 192, 16), torch.zeros(2, 192, 16), 2,
                     None, causal=False)
    out, lse = fa.flash_fwd(qs, k, k, 2, None, causal=False)
    assert out.shape == (2, 128, 16) and lse.shape == (2, 128)
    g = torch.zeros_like(qs)
    dk, dv = fa.flash_dkv(qs, k, k, g, lse, lse, 2, None, causal=False)
    assert dk.shape == dv.shape == (2, 256, 16)
    assert fa.flash_dq(qs, k, k, g, lse, lse, 2, None,
                       causal=False).shape == (2, 128, 16)
