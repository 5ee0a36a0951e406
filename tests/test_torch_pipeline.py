"""The GPipe pipeline of ``shockwave_tpu_torch/parallel/pipeline.py``
against the JAX package's (``tests/test_pipeline.py``'s seven contracts):
the schedule reproduces the stages applied back to back, is
differentiable, runs one stage a rank over a gang's pipe axis, and
``PipelinedLM`` from the JAX package's parameters gives the JAX logits,
loss and gradients, with learned positions or rotary ones; an MoE with a
balance loss is refused; the bubble is (S-1)/(M+S-1). Float32 on the CPU,
one thread; gangs are gloo ranks (``tests/torch_gang_runs.py``).
"""

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.models.convert import pipelined_params_from_jax
from shockwave_tpu_torch.models.transformer import TransformerConfig
from shockwave_tpu_torch.parallel.pipeline import (
    PipelinedLM,
    gpipe_apply,
    schedule,
    sequential_apply,
)
from torch_gang_runs import (
    gpipe_rank,
    one_thread,
    pipelined_lm_rank,
    pipelined_steps,
    spawn_gang,
    toy_params,
    toy_stage,
)

TOL = 1e-6  # the toy stages: tests/test_pipeline.py's limit
LM_TOL = 2e-4  # PipelinedLM's logits: tests/test_pipeline.py's limit
GRAD_TOL = 1e-5


def _jax_toy(S, M, d, mb, seed):
    """The JAX package's toy params and microbatches and its
    ``gpipe_apply``'s output, from ``tests/test_pipeline.py``'s draws."""
    import jax.numpy as jnp

    from shockwave_tpu.parallel.pipeline import gpipe_apply as jax_gpipe
    from test_pipeline import _toy_params, _toy_stage

    rng = np.random.default_rng(seed)
    params = _toy_params(rng, S, d)
    x = jnp.asarray(rng.normal(size=(M, mb, d)), jnp.float32)
    y = jax_gpipe(_toy_stage, params, x)
    as_torch = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    return as_torch, torch.from_numpy(np.asarray(x)), np.asarray(y)


@pytest.mark.parametrize("S,M", [(1, 1), (1, 4), (2, 4), (4, 2), (4, 8)])
def test_gpipe_matches_sequential(S, M):
    params, x, jax_y = _jax_toy(S, M, 8, 3, 0)
    y = gpipe_apply(toy_stage, params, x)
    seq = torch.stack([sequential_apply(toy_stage, params, x[m])
                       for m in range(M)])
    torch.testing.assert_close(y, seq, rtol=TOL, atol=TOL)
    torch.testing.assert_close(y, torch.from_numpy(jax_y), rtol=TOL,
                               atol=TOL)


def test_gpipe_differentiable():
    """Gradients through the schedule: finite, nonzero, and the JAX
    package's."""
    import jax
    import jax.numpy as jnp

    from shockwave_tpu.parallel.pipeline import gpipe_apply as jax_gpipe
    from test_pipeline import _toy_stage

    params, x, _ = _jax_toy(2, 4, 8, 2, 1)
    jax_params = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jax_grads = jax.grad(lambda p: jnp.sum(
        jax_gpipe(_toy_stage, p, jnp.asarray(x.numpy())) ** 2))(jax_params)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    (gpipe_apply(toy_stage, params, x) ** 2).sum().backward()
    for name, p in params.items():
        assert torch.isfinite(p.grad).all() and (p.grad != 0).any()
        torch.testing.assert_close(p.grad, torch.from_numpy(
            np.asarray(jax_grads[name])), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("pipe", [2, 4])
def test_gpipe_sharded_over_pipe_axis(pipe):
    """One stage a rank over a gang's pipe axis (activations handed on
    with ``ProcessMesh.shift``): every rank's outputs are the JAX
    package's, each rank's stage gradient and the input's gradient the
    one-process run's."""
    params, x, jax_y = _jax_toy(pipe, 2 * pipe, 8, 2, 2)
    ranks = spawn_gang(gpipe_rank, pipe, params, x)
    whole = {k: v.clone().requires_grad_() for k, v in params.items()}
    xg = x.clone().requires_grad_()
    with one_thread():
        (gpipe_apply(toy_stage, whole, xg) ** 2).sum().backward()
    for rank, (y, grads, x_grad) in enumerate(ranks):
        torch.testing.assert_close(y, torch.from_numpy(jax_y), rtol=TOL,
                                   atol=TOL)
        for name, g in grads.items():
            torch.testing.assert_close(g, whole[name].grad[rank],
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
    # The input enters at the first stage's rank.
    torch.testing.assert_close(ranks[0][2], xg.grad, rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def _lm_pair(positional, num_stages=4, num_microbatches=2, seed=3):
    """The JAX and the port's PipelinedLM on tests/test_pipeline.py's
    tiny config, the port's parameters the JAX package's seed-0 ones."""
    import jax
    import jax.numpy as jnp

    from shockwave_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
    )
    from shockwave_tpu.parallel.pipeline import PipelinedLM as JaxLM

    widths = dict(vocab_size=64, d_model=16, num_heads=2, num_layers=4,
                  d_ff=32, max_len=12, positional=positional)
    jax_model = JaxLM(JaxConfig(**widths), num_stages=num_stages,
                      num_microbatches=num_microbatches)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (4, 13))
    jax_params = jax_model.init(jax.random.PRNGKey(0),
                                jnp.asarray(tokens, jnp.int32))
    model = PipelinedLM(TransformerConfig(**widths), num_stages,
                        num_microbatches)
    params = pipelined_params_from_jax(jax.tree.map(np.asarray, jax_params))
    return jax_model, jax_params, model, params, tokens


def _check_lm(positional):
    import jax
    import jax.numpy as jnp

    jax_model, jax_params, model, params, tokens = _lm_pair(positional)
    assert ("positional" in params) == (positional == "learned")
    t = torch.from_numpy(tokens)
    with one_thread():
        logits = model.logits(params, t[:, :-1])
        torch.testing.assert_close(
            logits, model.logits_sequential(params, t[:, :-1]), rtol=LM_TOL,
            atol=LM_TOL)
        torch.testing.assert_close(logits, torch.from_numpy(np.asarray(
            jax_model.logits(jax_params, jnp.asarray(tokens[:, :-1])))),
            rtol=LM_TOL, atol=LM_TOL)
        jax_loss, jax_grads = jax.value_and_grad(jax_model.loss)(
            jax_params, jnp.asarray(tokens, jnp.int32))
        for leaf in [params[k] for k in params if k != "blocks"] + list(
                params["blocks"].values()):
            leaf.requires_grad_()
        loss = model.loss(params, t)
        loss.backward()
    assert torch.isfinite(loss)
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    grads = pipelined_params_from_jax(jax.tree.map(np.asarray, jax_grads))
    for key, value in params.items():
        pairs = (value.items() if key == "blocks" else [(key, value)])
        want = grads["blocks"] if key == "blocks" else grads
        for name, p in pairs:
            assert torch.isfinite(p.grad).all(), name
            torch.testing.assert_close(p.grad, want[name], rtol=1e-4,
                                       atol=1e-5, msg=name)


def test_pipelined_lm_matches_sequential_and_trains():
    """Four stages of one block, two microbatches: the logits equal the
    unpipelined stages' and the JAX model's; the loss and every gradient
    are the JAX model's."""
    _check_lm("learned")


def test_pipelined_lm_rejects_moe_with_aux_loss():
    cfg = TransformerConfig(vocab_size=64, d_model=16, num_heads=2,
                            num_layers=2, d_ff=32, max_len=12, num_experts=2)
    with pytest.raises(ValueError, match="aux loss"):
        PipelinedLM(cfg, num_stages=2, num_microbatches=2)
    off = TransformerConfig(vocab_size=64, d_model=16, num_heads=2,
                            num_layers=2, d_ff=32, max_len=12, num_experts=2,
                            moe_aux_weight=0.0)
    PipelinedLM(off, num_stages=2, num_microbatches=2)


@pytest.mark.parametrize("S,M", [(4, 4), (2, 8), (1, 3)])
def test_gpipe_bubble_fraction_matches_analytic_bound(S, M):
    """The bubble counted in work, not wall time: T = M + S - 1 ticks, each
    stage applied once a microbatch (S * M applications, counted through
    the stage function), so (S - 1) / (M + S - 1) of the S * T stage slots
    stay idle."""
    calls = []

    def counting_stage(params, x):
        calls.append(x.shape)
        return toy_stage(params, x)

    params, x, _ = _jax_toy(S, M, 4, 2, 7)
    gpipe_apply(counting_stage, params, x)
    ticks = schedule(S, M)
    assert len(ticks) == M + S - 1
    assert len(calls) == S * M == sum(len(t) for t in ticks)
    idle = 1.0 - len(calls) / (S * len(ticks))
    assert idle == pytest.approx((S - 1) / (S + M - 1), abs=1e-12)


def test_pipelined_lm_rope_no_table():
    """Rotary positions: no table, and the same contracts as learned."""
    _check_lm("rope")


def test_a_two_rank_pipe_gang_trains_as_one_process():
    """``PipelinedLM`` over a two-rank pipe gang (a stage of two blocks a
    rank, activations and their gradients handed over between ticks, the
    replicated parameters' gradients summed) for 2 AdamW steps: every
    rank's losses and the logits after them within 1e-5 of one process's
    on the same parameters and tokens, each rank's stage and the
    replicated parameters equal to one process's."""
    _, _, model, params, tokens = _lm_pair("learned", num_stages=2)
    t = torch.from_numpy(tokens)
    cfg = model.config
    ranks = spawn_gang(pipelined_lm_rank, 2, cfg, 2, params, t, 2)
    whole = {k: ({n: p.clone() for n, p in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
    with one_thread():
        losses, trained = pipelined_steps(model, whole, t, 2)
        logits = model.logits(trained, t[:, :-1]).detach()
    for rank, (got_losses, mine, got_logits) in enumerate(ranks):
        assert got_losses == pytest.approx(losses, rel=1e-5)
        torch.testing.assert_close(got_logits, logits, rtol=1e-5,
                                   atol=1e-5)
        for name, value in mine["blocks"].items():
            torch.testing.assert_close(value[0],
                                       trained["blocks"][name][rank].detach(),
                                       rtol=1e-5, atol=1e-6, msg=name)
        for key in ("embedding", "positional", "ln_f_scale", "ln_f_bias"):
            torch.testing.assert_close(mine[key], trained[key].detach(),
                                       rtol=1e-5, atol=1e-6, msg=key)
