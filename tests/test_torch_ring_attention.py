"""The port's ring attention and ring Transformer against the JAX package's.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py sets up,
its flash hops in interpret mode; the port's mesh holds the CPU device in
every place (a device may stand in several places of a port mesh, as one
card holds a ring on the H100). The same numpy inputs go through both.

Tolerances: the forward as tests/test_ring_attention.py holds the JAX ring
to dense attention (rtol 2e-4, atol 2e-5; float32, summation order and the
hop merge), and gradients at the JAX package's ring-against-dense limits
(rtol 1e-3, atol 1e-4). The ring Transformer as tests/test_torch_
transformer.py holds the flash model: loss within 1e-5 relative, every
gradient within 1e-4 of its largest entry.
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
from shockwave_tpu.parallel.ring_attention import (
    dense_causal_attention as jax_dense_causal_attention,
    ring_attention as jax_ring_attention,
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
from shockwave_tpu_torch.parallel.ring_attention import (
    dense_causal_attention,
    ring_attention,
)

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _meshes(shape):
    """The JAX package's mesh of this shape on its virtual CPU devices and
    the port's on the CPU."""
    n = int(np.prod(shape))
    return (jax_make_mesh(shape, devices=jax.devices()[:n]),
            port_mesh.make_mesh(shape, devices=["cpu"] * n))


def _qkv(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _jax_ring(q, k, v, mesh, **kw):
    return np.asarray(jax.jit(
        lambda q, k, v: jax_ring_attention(q, k, v, mesh, **kw))(q, k, v))


def _port_ring(q, k, v, mesh, **kw):
    return ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh,
                          **kw).numpy()


@pytest.mark.parametrize(
    "shape,B,S,H,Hkv,D,inner",
    [
        # tests/test_ring_attention.py:17 (S = 8 per shard: the dense body).
        ((1, 1, 2), 2, 16, 2, 2, 4, "auto"),
        ((1, 1, 4), 2, 32, 2, 2, 4, "auto"),
        # :35, batch over data, heads over model, sequence over seq.
        ((2, 2, 2), 4, 16, 4, 4, 8, "auto"),
        # :68 (128 per shard: "auto" takes the flash body).
        ((1, 1, 2), 1, 256, 2, 2, 16, "auto"),
        ((1, 1, 4), 1, 512, 2, 2, 16, "flash"),
        # :115, grouped-query K/V in both bodies.
        ((1, 1, 2), 1, 256, 4, 2, 16, "flash"),
        ((1, 1, 2), 1, 256, 4, 2, 16, "dense"),
    ],
    ids=["dense-2", "dense-4", "data-model-seq", "auto-flash-2", "flash-4",
         "gqa-flash", "gqa-dense"],
)
def test_forward_matches_jax(shape, B, S, H, Hkv, D, inner):
    jax_mesh, mesh = _meshes(shape)
    q, k, v = _qkv(S + H + Hkv, B, S, H, Hkv, D)
    np.testing.assert_allclose(_port_ring(q, k, v, mesh, inner=inner),
                               _jax_ring(q, k, v, jax_mesh, inner=inner),
                               **OUT_TOL)


def test_auto_takes_the_flash_body_exactly_when_the_block_tiles(monkeypatch):
    """"auto" picks flash at 128 tokens a shard (the kernels run, here as
    their plain versions) and the dense body at 64."""
    calls = []
    original = fa.flash_fwd

    def spy(qs, k, v, num_q_heads, window, causal):
        calls.append(causal)
        return original(qs, k, v, num_q_heads, window, causal)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    _, mesh = _meshes((1, 1, 2))
    for S in (128, 256):
        q, k, v = _qkv(S, 1, S, 2, 2, 16)
        _port_ring(q, k, v, mesh)
    # S = 256: two causal hops (one a shard) and one live non-causal hop;
    # the hop from the later shard to the earlier one is dead.
    assert calls == [True, True, False]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("H,Hkv", [(1, 1), (4, 2)], ids=["mha", "gqa"])
def test_flash_body_gradients_match_jax_dense(shards, H, Hkv):
    """Gradients through the flash body (the hop merge differentiates
    through each hop's lse) against jax.grad of the JAX package's dense
    causal attention on the repeated K/V (the sizes of the JAX package's
    ring gradient tests, tests/test_ring_attention.py:85, 138)."""
    _, mesh = _meshes((1, 1, shards))
    B, S, D = 1, 128 * shards, 16
    q, k, v = _qkv(6 + shards + H, B, S, H, Hkv, D)

    def rep(x):
        return jnp.repeat(x, H // Hkv, axis=2)

    def jax_loss(q, k, v):
        return jnp.sum(jax_dense_causal_attention(q, rep(k), rep(v)) ** 2)

    j_grads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(q, k, v)
    args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (ring_attention(*args, mesh, inner="flash") ** 2).sum().backward()
    for t, j in zip(args, j_grads):
        assert t.grad.shape == j.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize("kind, layers", [("drop", None), ("double", None),
                                          ("drop", (1,))])
def test_chip_smoke_ring_faults_plant_what_they_say(monkeypatch, kind,
                                                    layers):
    """The hop faults chip_smoke.py plants in the ring 110M tier, on one
    ring call (one layer, 4 shards of the CPU, the flash body): the last
    live hop (shard 3 attending shard 0's block) dropped is dense causal
    attention with that block masked, weighted twice is the same with
    ln 2 added to its scores, and a fault aimed at another layer changes
    nothing. float32, the forward tolerance of this file."""
    from test_torch_flash_attention import _chip_smoke

    from shockwave_tpu_torch.parallel import ring_attention as ra

    _, mesh = _meshes((1, 1, 4))
    B, S, H, D = 1, 512, 2, 16
    block = S // 4
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, B, S, H, H, D))
    bias = torch.zeros(S, S).masked_fill(
        torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    if layers is None:
        bias[3 * block:, :block] += (-torch.inf if kind == "drop"
                                     else float(np.log(2.0)))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D) + bias
    expected = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    monkeypatch.setattr(ra, "flash_attention_lse", _chip_smoke().ring_fault(
        ra.flash_attention_lse, kind, layers, live=6))
    np.testing.assert_allclose(
        ring_attention(q, k, v, mesh, inner="flash").numpy(),
        expected.numpy(), **OUT_TOL)


def test_dense_body_gradients_match_the_dense_reference():
    """The einsum body's gradients (masked hops, the online softmax merge)
    against autograd through the port's single-device reference."""
    _, mesh = _meshes((1, 1, 4))
    q, k, v = _qkv(2, 1, 32, 2, 1, 4)
    ring = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    dense = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (ring_attention(*ring, mesh, inner="dense") ** 2).sum().backward()
    kx, vx = (x.repeat_interleave(2, dim=2) for x in dense[1:])
    (dense_causal_attention(dense[0], kx, vx) ** 2).sum().backward()
    for a, b in zip(ring, dense):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **GRAD_TOL)


def test_rejects_what_the_jax_package_rejects():
    _, mesh = _meshes((1, 1, 2))
    q, k, v = (torch.zeros(1, 16, h, 4) for h in (4, 3, 3))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ring_attention(q, k, v, mesh)
    q, k, v = (torch.zeros(1, 16, 4, 4) for _ in range(3))
    with pytest.raises(ValueError, match="inner"):
        ring_attention(q, k, v, mesh, inner="sparse")
    _, mesh = _meshes((1, 4, 2))
    k = v = torch.zeros(1, 16, 2, 4)
    with pytest.raises(ValueError, match="divisible by the mesh's 'model'"):
        ring_attention(q, k, v, mesh)
    jax_mesh, _ = _meshes((1, 4, 2))
    with pytest.raises(ValueError, match="divisible by the mesh's 'model'"):
        jax_ring_attention(*(jnp.zeros(x.shape) for x in (q, k, v)),
                           jax_mesh)


def test_mesh_matches_the_jax_package():
    """make_mesh and factorize_gang as the JAX package's: axes, shapes,
    the 3-tuple shape's trailing pipe axis, and the same errors."""
    from shockwave_tpu.parallel import mesh as jax_mesh_module

    m = port_mesh.make_mesh((1, 1, 4), devices=["cpu"] * 4)
    jm = jax_mesh_module.make_mesh((1, 1, 4), devices=jax.devices()[:4])
    assert m.axis_names == tuple(jm.axis_names) == port_mesh.AXES
    assert m.shape == dict(jm.shape)
    assert m.device(seq=3) == torch.device("cpu")
    for args in [(8, 2), (8, 2, 2), (6, 3, 1, 2), (4, 1, 1, 1)]:
        assert port_mesh.factorize_gang(*args) == \
            jax_mesh_module.factorize_gang(*args)
    for make in (port_mesh.factorize_gang, jax_mesh_module.factorize_gang):
        with pytest.raises(ValueError, match="not divisible"):
            make(1, 2)
    with pytest.raises(ValueError, match="devices"):
        port_mesh.make_mesh((1, 1, 3), devices=["cpu"] * 2)


@pytest.mark.parametrize("S", [256, 128], ids=["flash-body", "dense-body"])
def test_ring_transformer_loss_and_gradients_match_jax(S):
    """A 2-layer, d_model 64 ring Transformer on a 2-shard seq mesh, on the
    JAX initialisation carried over with params_from_jax (ring attention
    adds no parameters): at S = 256 the shards hold 128 tokens and take
    the flash body, at S = 128 they hold 64 and take the dense body."""
    kw = dict(vocab_size=256, d_model=64, num_heads=2, num_layers=2,
              d_ff=256, max_len=S)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, kw["vocab_size"], (2, S + 1))
    jax_mesh, mesh = _meshes((1, 1, 2))
    variables = jax.jit(JaxLM(JaxConfig(**kw)).init)(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:, :-1], jnp.int32))
    params = jax.tree.map(np.asarray, flax_nn.meta.unbox(variables)["params"])
    jax_model = JaxLM(JaxConfig(**kw, attention="ring"), mesh=jax_mesh)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jax_model, {"params": p},
                              jnp.asarray(tokens, jnp.int32))))(params)

    model = TransformerLM(TransformerConfig(**kw, attention="ring"),
                          mesh=mesh)
    state = params_from_jax(params)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
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


def test_ring_model_needs_a_mesh():
    model = TransformerLM(TransformerConfig(attention="ring", max_len=128))
    with pytest.raises(ValueError, match="requires a mesh"):
        lm_loss(model, torch.zeros(1, 129, dtype=torch.long))


TINY_ARGS = ["--model", "Transformer", "--batch_size", "2", "--vocab_size",
             "256", "--d_model", "64", "--num_heads", "2", "--num_layers",
             "2", "--seq_len", "128", "-n", "2", "--device", "cpu"]


def test_train_runs_ring_on_one_device():
    """``--attention ring --seq_parallel 1``: a one-shard ring is its
    causal hop alone, so the losses equal the flash run's. On one device
    --seq_parallel 2 is refused, by the JAX package's rule (P must divide
    the device count)."""
    ring = train.main(TINY_ARGS + ["--attention", "ring",
                                   "--seq_parallel", "1"])
    flash = train.main(TINY_ARGS + ["--attention", "flash"])
    assert ring["losses"] == flash["losses"]
    with pytest.raises(ValueError, match="not divisible"):
        train.main(TINY_ARGS + ["--attention", "ring", "--seq_parallel", "2"])
