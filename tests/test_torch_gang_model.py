"""Tensor and expert parallelism over a gang's model axis: ``python -m
shockwave_tpu_torch.models.train --model_parallel M`` ranks over gloo on
the CPU, one thread each, against the JAX program in one process over a
mesh of as many virtual CPU devices, whose "model" annotations shard the
same heads, MLP columns, vocabulary rows and experts.

Both start from the JAX program's seed-0 parameters: the port's gang
resumes from a step-0 checkpoint of them, which holds whole parameters
and which each rank takes its share of. A data group's model and seq
ranks share its draw from ``--seed + d`` (here one group, the draw from
``--seed``), the batch the JAX program takes in one process. Losses within
1e-5 relative at every step, and the whole parameters the gang's
checkpoint holds after 2 steps within 1e-4 absolute of the JAX program's
(an AdamW step at lr 1e-3 moves a parameter by about 1e-3 whatever its
gradient's size, so where a gradient is near zero two summation orders
move it apart; ``tests/test_torch_gang_seq.py`` holds seq gangs alike).
"""

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.models import train
from test_torch_gang import run_gang

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
WIDTHS = ["--d_model", "64", "--num_layers", "2", "--num_heads", "4",
          "--vocab_size", "128"]


def _jax_run(extra, steps, batch, shape, same_batch=False):
    """The JAX program's ``build_family`` over a ``shape`` mesh of virtual
    CPU devices in one process: its seed-0 parameters, and its losses and
    parameters after ``steps`` steps on draws from ``--seed`` (each step
    on the first draw when ``same_batch``, as a resumed run draws it)."""
    import flax.linen as flax_nn
    import jax

    from shockwave_tpu.models.train import build_family as jax_build_family
    from shockwave_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from shockwave_tpu_torch.models.convert import params_from_jax

    args = train.parse_args(["--model", "Transformer", "-n", str(steps),
                             "--batch_size", str(batch), *extra])
    mesh = jax_make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])
    variables, step, opt_state, batch_fn = jax_build_family(
        "Transformer", args, mesh)

    def params(tree):
        return params_from_jax(jax.tree.map(
            np.asarray, flax_nn.meta.unbox(tree)["params"]))

    start = params(variables)
    rng = np.random.default_rng(args.seed)
    step = jax.jit(step)
    losses = []
    for _ in range(steps):
        if same_batch:
            rng = np.random.default_rng(args.seed)
        variables, opt_state, loss = step(variables, opt_state,
                                          batch_fn(rng))
        losses.append(float(loss))
    return start, losses, params(variables)


def _step0_checkpoint(directory, extra, state):
    """A step-0 checkpoint of the port's program (one process) holding
    the whole parameters ``state``."""
    args = train.parse_args(["--model", "Transformer", "-n", "1", "--device",
                             "cpu", *extra])
    args.seq_parallel = args.model_parallel = 1
    model, _, opt, _ = train.build_family("Transformer", args, CPU)
    model.load_state_dict(state)
    train.FileCheckpoint(str(directory)).save(model, opt, 0)


def _gang(tmp_path, world, extra, steps=2):
    codes, outs, ranks = run_gang(world, "Transformer", steps=steps, batch=2,
                                  extra=extra, checkpoint_dir=tmp_path,
                                  threads=1)
    assert codes == [0] * world, outs[0][-3000:]
    assert all("RESUMED" in out for out in outs)
    # Every rank reports the same losses and the same whole parameters.
    assert len({str(r) for r in ranks.values()}) == 1, ranks
    return ranks[0][1]


def _check_params(tmp_path, jax_params):
    saved = torch.load(tmp_path / train.CHECKPOINT_NAME)["model"]
    assert saved.keys() == jax_params.keys()
    for name, value in jax_params.items():
        torch.testing.assert_close(saved[name], value, rtol=0,
                                   atol=PARAM_ATOL, msg=name)


@pytest.mark.parametrize("extra", [
    ["--seq_len", "128", "--attention", "flash"],
    ["--seq_len", "64", "--num_kv_heads", "2", "--positional", "rope"],
    ["--seq_len", "32", "--num_experts", "4", "--moe_capacity_factor",
     "0.5"],
    ["--seq_len", "32", "--num_experts", "4", "--moe_dispatch", "dense",
     "--logit_chunk", "16"],
], ids=["dense-flash", "gqa-rope", "moe-grouped", "moe-dense-chunked"])
def test_a_two_rank_model_gang_tracks_the_jax_program(tmp_path, extra):
    """Two ranks over "model" (2 of 4 heads, half the MLP or 2 of 4
    experts, half the vocabulary a rank) against the JAX program over a
    (1, 2, 1, 1) mesh. The grouped MoE at capacity 0.5 drops tokens, so
    the experts' buckets follow the global routing."""
    extra = WIDTHS + extra + ["--model_parallel", "2"]
    start, jax_losses, jax_params = _jax_run(extra, 2, 2, (1, 2, 1, 1))
    _step0_checkpoint(tmp_path, extra, start)
    losses = _gang(tmp_path, 2, extra)
    assert losses == pytest.approx(jax_losses, rel=LOSS_RTOL)
    _check_params(tmp_path, jax_params)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_a_four_rank_model_by_seq_gang_tracks_the_jax_program(tmp_path,
                                                              attention):
    """Four ranks over model x seq (2 x 2): each rank's 2 heads go round
    the ring or through Ulysses' all-to-alls over its seq line, the
    counterparts of the JAX package's model x seq meshes
    (tests/test_ring_attention.py, tests/test_ulysses.py,
    tests/test_models.py::test_transformer_ring_attention_tp_mesh)."""
    extra = WIDTHS + ["--seq_len", "64", "--attention", attention,
                      "--model_parallel", "2", "--seq_parallel", "2"]
    start, jax_losses, jax_params = _jax_run(extra, 2, 2, (1, 2, 2, 1))
    _step0_checkpoint(tmp_path, extra, start)
    losses = _gang(tmp_path, 4, extra)
    assert losses == pytest.approx(jax_losses, rel=LOSS_RTOL)
    _check_params(tmp_path, jax_params)


def test_a_model_gang_resumes_under_another_gang_shape(tmp_path):
    """The checkpoint holds whole parameters: a step taken by a model
    gang of two ranks, then a step by a seq gang of two ranks resumed from
    it (each rank its sequence shard of the whole parameters), track the
    JAX program's two steps (both on the first draw, as a resumed run
    draws it again)."""
    base = WIDTHS + ["--seq_len", "64", "--attention", "ring",
                     "--num_experts", "4"]
    model_gang = base + ["--model_parallel", "2"]
    start, jax_losses, jax_params = _jax_run(model_gang, 2, 2, (1, 2, 1, 1),
                                             same_batch=True)
    _step0_checkpoint(tmp_path, model_gang, start)
    first = _gang(tmp_path, 2, model_gang, steps=1)
    second = _gang(tmp_path, 2, base + ["--seq_parallel", "2"], steps=1)
    assert first + second == pytest.approx(jax_losses, rel=LOSS_RTOL)
    _check_params(tmp_path, jax_params)


def test_the_shares_of_a_rank_make_the_whole_parameters():
    """``shard_state`` and ``convert.params_from_jax(..., model_index=r)``
    give rank r's share; the shares concatenated along
    ``model_shard_dim`` are the whole tensors."""
    from shockwave_tpu_torch.models.convert import params_from_jax
    from shockwave_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        model_shard_dim,
        shard_state,
    )

    cfg = TransformerConfig(vocab_size=32, d_model=16, num_heads=4,
                            num_layers=2, d_ff=32, num_experts=2)
    whole = TransformerLM(cfg, torch.Generator().manual_seed(0)).state_dict()
    shares = [shard_state(whole, r, 2) for r in range(2)]
    split = 0
    for name, value in whole.items():
        dim = model_shard_dim(name)
        if dim is None:
            assert all(torch.equal(s[name], value) for s in shares), name
        else:
            split += 1
            assert shares[0][name].shape[dim] * 2 == value.shape[dim]
            assert torch.equal(torch.cat([s[name] for s in shares], dim),
                               value), name
    assert split == 1 + 2 * 6  # the embedding, 4 attention and 2 MoE a block
    tree = _jax_tree(whole)
    for r in range(2):
        got = params_from_jax(tree, model_index=r, model_parallel=2)
        for name, value in shares[r].items():
            torch.testing.assert_close(got[name], value, rtol=0, atol=0)


def _jax_tree(state):
    """The JAX model's params tree for a whole port state dict (the
    inverse of ``params_from_jax`` on a two-block MoE model)."""
    tree = {"embedding": state["embedding"].numpy(),
            "positional": state["positional"].numpy(),
            "ln_f": {"scale": state["ln_f.weight"].numpy(),
                     "bias": state["ln_f.bias"].numpy()}}
    for b in range(2):
        p = f"blocks.{b}."
        tree[f"block_{b}"] = {
            "ln1": {"scale": state[p + "ln1.weight"].numpy(),
                    "bias": state[p + "ln1.bias"].numpy()},
            "ln2": {"scale": state[p + "ln2.weight"].numpy(),
                    "bias": state[p + "ln2.bias"].numpy()},
            "attention": {n: {"kernel": state[p + f"attention.{n}.weight"]
                              .t().numpy()}
                          for n in ("query", "key", "value", "out")},
            "moe": {"router": {"kernel": state[p + "moe.router.weight"]
                               .t().numpy()},
                    "w_in": state[p + "moe.w_in"].numpy(),
                    "w_out": state[p + "moe.w_out"].numpy()},
        }
    return tree


def test_a_model_axis_needs_heads_and_experts_that_divide():
    from shockwave_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from shockwave_tpu_torch.parallel.mesh import ProcessMesh

    mesh = ProcessMesh((1, 2, 1, 1), 0, 2, {}, {})
    with pytest.raises(ValueError, match="model axis of 2"):
        TransformerLM(TransformerConfig(num_heads=4, num_kv_heads=1),
                      mesh=mesh)
    with pytest.raises(ValueError, match="model axis of 2"):
        TransformerLM(TransformerConfig(num_experts=3), mesh=mesh)
