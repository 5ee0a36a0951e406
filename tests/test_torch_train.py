"""The port's training program against the JAX package's, on the CPU.

Both ``build_family("Transformer")`` loops start from the JAX
initialisation (carried over with ``params_from_jax``) and draw their
batches from the same ``np.random.default_rng(seed)``, so their loss
trajectories must agree. Float32; the tolerance 1e-4 relative covers the
summation-order differences of the forward (1e-5, see
test_torch_transformer.py) grown through two AdamW steps at lr 1e-3.
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from shockwave_tpu.models.train import build_family as jax_build_family
from shockwave_tpu_torch.models import train
from shockwave_tpu_torch.models.convert import (
    family_params_from_jax,
    params_from_jax,
)

TINY_ARGS = ["--model", "Transformer", "--batch_size", "2", "--vocab_size",
             "256", "--d_model", "64", "--num_heads", "2", "--num_layers",
             "2", "--seq_len", "128", "--attention", "flash", "--device",
             "cpu"]


def test_three_steps_track_the_jax_loop():
    args = train.parse_args(TINY_ARGS + ["-n", "3"])
    variables, jax_step, opt_state, jax_batch = jax_build_family(
        "Transformer", args, mesh=None)
    jax_step = jax.jit(jax_step)
    model, step_fn, _, batch_fn = train.build_family(
        "Transformer", args, torch.device("cpu"))
    params = jax.tree.map(np.asarray,
                          flax_nn.meta.unbox(variables)["params"])
    model.load_state_dict(params_from_jax(params))

    jax_rng = np.random.default_rng(args.seed)
    port_rng = np.random.default_rng(args.seed)
    jax_losses, port_losses = [], []
    for _ in range(3):
        variables, opt_state, loss = jax_step(variables, opt_state,
                                              jax_batch(jax_rng))
        jax_losses.append(float(loss))
        port_losses.append(float(step_fn(batch_fn(port_rng))))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)


def test_checkpoint_resume_restores_before_the_first_step(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = train.main(TINY_ARGS + ["-n", "2", "--checkpoint_dir", ckpt])
    assert first["steps"] == 2 and not first["resumed"]
    assert (tmp_path / "ckpt" / train.CHECKPOINT_NAME).exists()
    assert not (tmp_path / "ckpt" / (train.CHECKPOINT_NAME + ".tmp")).exists()
    second = train.main(TINY_ARGS + ["-n", "1", "--checkpoint_dir", ckpt])
    assert second["resumed"]
    # The resumed run sees the first batch again, now with trained
    # weights: its loss is below the fresh run's first loss.
    assert second["losses"][0] < first["losses"][0]
    state = torch.load(tmp_path / "ckpt" / train.CHECKPOINT_NAME,
                       weights_only=True)
    steps = {s["step"] for s in state["opt"]["state"].values()}
    assert steps == {3}
    out = capsys.readouterr().out
    assert "[Transformer] steps=2 loss=" in out
    assert "[Transformer] steps=1 loss=" in out


def test_phase_timings_line(monkeypatch, capsys):
    monkeypatch.setenv("SHOCKWAVE_PHASE_TIMINGS", "1")
    result = train.main(TINY_ARGS + ["-n", "1"])
    assert set(result["phases"]) == {"build", "restore",
                                     "first_step_compile", "train", "save"}
    assert capsys.readouterr().out.startswith("PHASES build=")


@pytest.mark.parametrize(
    "extra",
    [
        ["--model", "ResNet-18"],
        ["--model", "LM"],
        ["--model", "Recommendation"],
        ["--model", "A3C"],
        ["--model", "CycleGAN"],
        ["--distributed_addr", "localhost:1234", "--num_workers", "2",
         "--model_parallel", "2"],
        ["--model_parallel", "2"],
        ["--ckpt_backend", "orbax"],
        ["--attention", "ulysses"],
        ["--num_experts", "2"],
        ["--remat"],
        ["--logit_chunk", "64"],
    ],
)
def test_unported_paths_raise(extra, tmp_path):
    """Every case is ported. ``--model_parallel 2`` in a gang of two runs
    (one head, half the MLP and the vocabulary a rank), its losses within
    1e-5 of one process's on the same seed
    (tests/test_torch_gang_model.py holds it to the JAX program); without
    a gang it raises the JAX program's error, one device not divisible
    over the model axis. Every other case: ``train.main`` runs it
    (``--ckpt_backend orbax`` saves a directory checkpoint and resumes
    from it), and its loop from the JAX initialisation tracks the JAX
    program's: the first loss within 1e-5, the second within 1e-4
    (ResNet's float32 steps part by more on BatchNorm over two images;
    test_torch_families.py holds them in float64). ``--attention
    ulysses`` runs on a one-shard seq mesh of each package."""
    if "--distributed_addr" in extra:
        from test_torch_gang import run_gang

        flags = TINY_ARGS[TINY_ARGS.index("--vocab_size"):-2]
        codes, outs, ranks = run_gang(2, "Transformer", steps=2, batch=2,
                                      extra=flags + ["--model_parallel", "2"],
                                      threads=1)
        assert codes == [0, 0], outs[0][-3000:]
        assert ranks[0] == ranks[1], ranks
        alone = train.main(TINY_ARGS + ["-n", "2"])
        np.testing.assert_allclose(ranks[0][1], alone["losses"], rtol=1e-5)
        return
    if "--model_parallel" in extra:
        with pytest.raises(ValueError,
                           match="1 devices not divisible by model=2"):
            train.main(TINY_ARGS + ["-n", "1"] + extra)
        return
    from shockwave_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from shockwave_tpu_torch.parallel.mesh import make_mesh

    ckpt = ["--checkpoint_dir", str(tmp_path)]
    result = train.main(TINY_ARGS + ["-n", "1"] + extra + ckpt)
    assert len(result["losses"]) == 1 and np.isfinite(result["losses"][0])
    if "orbax" in extra:
        assert (tmp_path / "orbax_state").is_symlink()
        assert train.main(TINY_ARGS + ["-n", "1"] + extra + ckpt)["resumed"]
    args = train.parse_args(TINY_ARGS + ["-n", "2"] + extra)
    variables, jax_step, opt_state, jax_batch = jax_build_family(
        args.model, args,
        mesh=jax_make_mesh((1, 1, 1), devices=jax.devices()[:1]))
    jax_step = jax.jit(jax_step)
    model, step_fn, _, batch_fn = train.build_family(
        args.model, args, torch.device("cpu"),
        make_mesh((1, 1, 1), devices=["cpu"]))
    model.load_state_dict(family_params_from_jax(args.model, jax.tree.map(
        np.asarray, flax_nn.meta.unbox(variables))))
    jax_rng = np.random.default_rng(args.seed)
    port_rng = np.random.default_rng(args.seed)
    jax_losses, port_losses = [], []
    for _ in range(2):
        variables, opt_state, loss = jax_step(variables, opt_state,
                                              jax_batch(jax_rng))
        jax_losses.append(float(loss))
        port_losses.append(float(step_fn(batch_fn(port_rng))))
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-5)
    if not args.model.startswith("ResNet"):
        np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)


def test_leased_iterator_raises_only_under_a_job(monkeypatch, tmp_path):
    """The leased iterator is ported and raises nowhere now: under a job
    (``SHOCKWAVE_JOB_ID`` set) the batches come through it, its lease of
    3 steps ends the run before ``-n``, the checkpoint is saved with the
    steps taken and the progress line is written; without a job the flag
    changes nothing."""
    from shockwave_tpu_torch.runtime.rpc import iterator_client

    class Lease:
        def __init__(self, *args):
            pass

        def init(self):
            return 3, 1e6, 0.0

        def update_lease(self, steps, duration, max_steps, max_duration):
            return max_steps, max_duration, 0.0

    log = tmp_path / "iterator.log"
    monkeypatch.setattr(iterator_client, "IteratorRpcClient", Lease)
    for key, value in (("SHOCKWAVE_JOB_ID", "7"), ("SHOCKWAVE_WORKER_ID", "0"),
                       ("SHOCKWAVE_SCHED_ADDR", "127.0.0.1"),
                       ("SHOCKWAVE_SCHED_PORT", "1"),
                       ("SHOCKWAVE_LOG_FILE", str(log))):
        monkeypatch.setenv(key, value)
    ckpt = tmp_path / "ckpt"
    leased = train.main(TINY_ARGS + ["-n", "10", "--enable_shockwave_iterator",
                                     "--checkpoint_dir", str(ckpt)])
    assert leased["steps"] == 3
    assert "steps=3 duration=" in log.read_text()
    state = torch.load(ckpt / train.CHECKPOINT_NAME, weights_only=True)
    assert state["step"] == 3
    resumed = train.main(TINY_ARGS + ["-n", "10", "--enable_shockwave_iterator",
                                      "--checkpoint_dir", str(ckpt)])
    assert resumed["resumed"] and resumed["start_step"] == 3
    monkeypatch.delenv("SHOCKWAVE_JOB_ID")
    free = train.main(TINY_ARGS + ["-n", "2", "--enable_shockwave_iterator"])
    assert free["steps"] == 2


def test_unknown_family_and_missing_card(monkeypatch):
    with pytest.raises(ValueError):
        train.main(TINY_ARGS + ["-n", "1", "--model", "GPT-9"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(TINY_ARGS + ["-n", "1", "--device", "cuda"])
