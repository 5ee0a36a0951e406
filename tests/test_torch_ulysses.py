"""The port's Ulysses attention and Ulysses Transformer against the JAX
package's.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py sets up,
its flash local body in interpret mode, as tests/test_ulysses.py runs it;
the port's mesh holds the CPU device in every place, and its flash body
is the kernels' plain version. The same numpy inputs go through both.

Tolerances: the forward as tests/test_ulysses.py holds the JAX Ulysses to
dense attention (rtol 2e-4, atol 2e-5; float32, summation order), the
gradients at its flash limits (rtol 1e-3, atol 1e-4), and the Ulysses
Transformer as tests/test_torch_ring_attention.py holds the ring one:
loss within 1e-5 relative, every gradient within 1e-4 of its largest
entry.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
    lm_loss as jax_lm_loss,
)
from shockwave_tpu.parallel.mesh import make_mesh as jax_make_mesh
from shockwave_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses_attention,
)
from shockwave_tpu_torch.models import train
from shockwave_tpu_torch.models.convert import params_from_jax
from shockwave_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    lm_loss,
)
from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.parallel import mesh as port_mesh
from shockwave_tpu_torch.parallel.ring_attention import dense_causal_attention
from shockwave_tpu_torch.parallel.ulysses import ulysses_attention

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _meshes(shape):
    n = int(np.prod(shape))
    return (jax_make_mesh(shape, devices=jax.devices()[:n]),
            port_mesh.make_mesh(shape, devices=["cpu"] * n))


def _qkv(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, H, D)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize(
    "shape,B,S,H,D,local",
    [
        # tests/test_ulysses.py:22 (dense local body, 2 and 4 shards).
        ((1, 1, 2), 2, 16, 2, 4, "dense"),
        ((1, 1, 4), 2, 32, 4, 4, "dense"),
        # :35, heads over model and seq, batch over data.
        ((2, 2, 2), 4, 16, 4, 8, "dense"),
        # :48, the flash body on the gathered sequence (head dim 16, the
        # port's kernels' least); S = 16 does not tile and takes the
        # dense body.
        ((1, 1, 2), 1, 128, 2, 16, "flash"),
        ((1, 1, 4), 1, 256, 4, 16, "flash"),
        ((1, 1, 2), 1, 16, 2, 8, "flash"),
    ],
    ids=["dense-2", "dense-4", "data-model-seq", "flash-2", "flash-4",
         "flash-fallback"],
)
def test_forward_and_gradients_match_jax(shape, B, S, H, D, local):
    jax_mesh, mesh = _meshes(shape)
    q, k, v = _qkv(S + H + len(shape), B, S, H, D)

    def jax_loss(q, k, v):
        out = jax_ulysses_attention(q, k, v, jax_mesh, local_attention=local)
        return jnp.sum(out ** 2), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ulysses_attention(*args, mesh, local_attention=local)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **OUT_TOL)
    for t, j in zip(args, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_flash_body_launches_once_a_shard_and_falls_back(monkeypatch,
                                                         shards):
    """The flash body runs one causal launch a shard over the gathered
    sequence and H/P heads; a sequence that does not tile runs no launch
    (the dense body, as the JAX package falls back)."""
    calls = []
    original = fa.flash_fwd

    def spy(qs, k, v, num_q_heads, window, causal):
        calls.append((tuple(qs.shape), causal))
        return original(qs, k, v, num_q_heads, window, causal)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    _, mesh = _meshes((1, 1, shards))
    H = 2 * shards
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 128, H, 16))
    out = ulysses_attention(q, k, v, mesh, local_attention="flash")
    assert len(calls) == shards and all(c for _, c in calls)
    np.testing.assert_allclose(out.numpy(),
                               dense_causal_attention(q, k, v).numpy(),
                               **OUT_TOL)
    calls.clear()
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 16 * shards, H, 8))
    ulysses_attention(q, k, v, mesh, local_attention="flash")
    assert calls == []


def test_rejects_what_the_jax_package_rejects():
    jax_mesh, mesh = _meshes((1, 1, 4))
    q = k = v = np.zeros((1, 16, 2, 4), np.float32)
    with pytest.raises(ValueError, match="not divisible by seq axis"):
        ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh)
    with pytest.raises(ValueError, match="not divisible by seq axis"):
        jax_ulysses_attention(q, k, v, jax_mesh)
    with pytest.raises(ValueError, match="local_attention"):
        ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh,
                          local_attention="sparse")
    # Grouped-query K/V: both models refuse the Ulysses path.
    kw = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
              num_layers=1, d_ff=64, max_len=16, attention="ulysses")
    tokens = np.zeros((1, 17), np.int64)
    model = TransformerLM(TransformerConfig(**kw), mesh=mesh)
    with pytest.raises(ValueError, match="num_kv_heads"):
        lm_loss(model, torch.from_numpy(tokens))
    jax_model = JaxLM(JaxConfig(**kw), mesh=jax_mesh)
    with pytest.raises(ValueError, match="num_kv_heads"):
        jax_model.init(jax.random.PRNGKey(0),
                       jnp.asarray(tokens[:, :-1], jnp.int32))
    with pytest.raises(ValueError, match="requires a mesh"):
        lm_loss(TransformerLM(TransformerConfig(
            **{**kw, "num_kv_heads": None})), torch.from_numpy(tokens))


@pytest.mark.parametrize("shards,S", [(2, 256), (4, 128), (2, 64)],
                         ids=["flash-2", "flash-4", "dense-2"])
def test_ulysses_transformer_loss_and_gradients_match_jax(shards, S):
    """A 2-layer, d_model 64 Ulysses Transformer on a seq mesh, on the JAX
    initialisation carried over with params_from_jax (Ulysses adds no
    parameters): S = 256 and 128 tile for the flash body, S = 64 takes
    the dense body."""
    kw = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2,
              d_ff=256, max_len=S)
    rng = np.random.default_rng(shards + S)
    tokens = rng.integers(0, kw["vocab_size"], (2, S + 1))
    jax_mesh, mesh = _meshes((1, 1, shards))
    variables = jax.jit(JaxLM(JaxConfig(**kw)).init)(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:, :-1], jnp.int32))
    params = jax.tree.map(np.asarray, flax_nn.meta.unbox(variables)["params"])
    jax_model = JaxLM(JaxConfig(**kw, attention="ulysses"), mesh=jax_mesh)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jax_model, {"params": p},
                              jnp.asarray(tokens, jnp.int32))))(params)

    model = TransformerLM(TransformerConfig(**kw, attention="ulysses"),
                          mesh=mesh)
    model.load_state_dict(params_from_jax(params))
    loss = lm_loss(model, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = dict(model.named_parameters())
    for name, g in ref.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(
            got[name].grad.numpy(), g.numpy(), rtol=0, atol=1e-4 * scale,
            err_msg=name)


TINY_ARGS = ["--model", "Transformer", "--batch_size", "2", "--vocab_size",
             "256", "--d_model", "64", "--num_heads", "2", "--num_layers",
             "2", "--seq_len", "128", "-n", "2", "--device", "cpu"]


def test_train_runs_ulysses_on_one_device():
    """``--attention ulysses``: on one device the seq axis has one shard,
    whose all-to-alls are the identity, so the losses equal the flash
    run's. On one device --seq_parallel 2 is refused, by the JAX
    package's rule (P must divide the device count)."""
    ulysses = train.main(TINY_ARGS + ["--attention", "ulysses"])
    flash = train.main(TINY_ARGS + ["--attention", "flash"])
    assert ulysses["losses"] == flash["losses"]
    with pytest.raises(ValueError, match="not divisible"):
        train.main(TINY_ARGS + ["--attention", "ulysses",
                                "--seq_parallel", "2"])
