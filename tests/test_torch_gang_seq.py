"""Sequence parallelism across a gang's processes: ring and Ulysses
attention over a two-rank gloo gang on the CPU, each rank holding one
sequence shard, against the port's one-process run over a two-place mesh
on the same global batch (the one-process bodies are themselves held to
the JAX package's ``shard_map`` ring and Ulysses,
``tests/test_torch_ring_attention.py``, ``tests/test_torch_ulysses.py``).

The bodies alone: output and q/k/v gradients within 1e-5. Training
(``python -m shockwave_tpu_torch.models.train`` ranks): losses within
1e-5 at every step, every parameter within 1e-5 after 2 steps, and the
ranks' parameters equal. And from the JAX program's seed-0 parameters,
the gang against the JAX program over a two-device seq mesh in one
process (the JAX package's own two-process seq gang reads an inconsistent
batch, so it is shown to differ, in a slow test).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.models import train
from shockwave_tpu_torch.parallel.mesh import make_mesh
from shockwave_tpu_torch.parallel.ring_attention import ring_attention
from shockwave_tpu_torch.parallel.ulysses import ulysses_attention
from test_torch_gang import run_gang
from torch_gang_runs import (
    attention_inputs,
    attention_rank,
    one_thread,
    spawn_gang,
)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
CPU = torch.device("cpu")


def _one_process_attention(kind, inner, shape, places=2):
    q, k, v, g = attention_inputs(**shape)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    mesh = make_mesh((1, 1, places, 1), [CPU] * places)
    with one_thread():
        if kind == "ring":
            out = ring_attention(q, k, v, mesh, inner=inner)
        else:
            out = ulysses_attention(q, k, v, mesh, local_attention=inner)
        out.backward(g)
    return [t.detach() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("kind,inner,shape", [
    ("ring", "flash", dict(B=2, S=256, H=4, Hkv=2, D=16)),
    ("ring", "dense", dict(B=2, S=64, H=4, Hkv=2, D=16)),
    ("ulysses", "flash", dict(B=2, S=256, H=4, Hkv=4, D=16)),
    ("ulysses", "dense", dict(B=2, S=64, H=4, Hkv=2, D=16)),
])
def test_each_rank_equals_its_shard_of_the_one_process_body(kind, inner,
                                                            shape):
    """Each rank's output and q/k/v gradients are its sequence shard's of
    the one-process body over a two-place mesh: the hops' K/V blocks (and
    their gradients, the other way) or the all-to-alls cross processes."""
    ranks = spawn_gang(attention_rank, 2, kind, inner, shape)
    ref = _one_process_attention(kind, inner, shape)
    s = shape["S"] // 2
    for rank, got in enumerate(ranks):
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            torch.testing.assert_close(a, b[:, rank * s:(rank + 1) * s],
                                       rtol=TOL, atol=TOL, msg=name)


def test_a_four_rank_ring_equals_the_one_process_body():
    """Four shards: hops of blocks two and three places back, and dead
    hops on the first ranks, whose backward still takes part in every
    exchange."""
    shape = dict(B=1, S=512, H=2, Hkv=2, D=16)
    ranks = spawn_gang(attention_rank, 4, "ring", "flash", shape)
    ref = _one_process_attention("ring", "flash", shape, places=4)
    for rank, got in enumerate(ranks):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b[:, rank * 128:(rank + 1) * 128],
                                       rtol=TOL, atol=TOL)


def _seq_argv(attention, seq_len, positional="learned"):
    return ["--d_model", "64", "--num_layers", "2", "--num_heads", "4",
            "--vocab_size", "128", "--seq_len", str(seq_len), "--attention",
            attention, "--seq_parallel", "2", "--positional", positional]


def _one_process_run(extra, steps=2, batch=2):
    args = train.parse_args(["--model", "Transformer", "-n", str(steps),
                             "--batch_size", str(batch), "--device", "cpu",
                             *extra])
    mesh = make_mesh((1, 1, 2, 1), [CPU, CPU])
    model, step_fn, _, batch_fn = train.build_family("Transformer", args,
                                                     CPU, mesh)
    rng = np.random.default_rng(args.seed)
    with one_thread():
        losses = [float(step_fn(batch_fn(rng))) for _ in range(steps)]
    return losses, model.state_dict()


@pytest.mark.parametrize("attention,seq_len,positional", [
    ("ring", 256, "learned"),
    ("ring", 64, "rope"),
    ("ulysses", 256, "learned"),
    ("ulysses", 64, "rope"),
])
def test_a_two_rank_seq_gang_trains_as_one_process(tmp_path, attention,
                                                   seq_len, positional):
    """``train --seq_parallel 2`` over two processes: both ranks draw the
    global batch and keep their sequence shard, take their tokens' global
    positions, and step as one process over a two-place mesh on that
    batch (losses and parameters within 1e-5, the ranks equal)."""
    extra = _seq_argv(attention, seq_len, positional)
    codes, outs, ranks = run_gang(2, "Transformer", steps=2, batch=2,
                                  extra=extra, checkpoint_dir=tmp_path,
                                  threads=1)
    for code, out in zip(codes, outs):
        assert code == 0, out[-3000:]
        assert re.search(r"^MESH backend=gloo rank=\d world=2 mesh=\{'data': "
                         r"1, 'model': 1, 'seq': 2, 'pipe': 1\} device=cpu$",
                         out, re.M), out[-2000:]
    assert ranks[0] == ranks[1], ranks
    losses, state = _one_process_run(extra)
    assert ranks[0][1] == pytest.approx(losses, rel=TOL, abs=TOL)
    saved = torch.load(tmp_path / train.CHECKPOINT_NAME)["model"]
    assert saved.keys() == state.keys()
    for name, value in state.items():
        torch.testing.assert_close(saved[name], value, rtol=TOL, atol=TOL,
                                   msg=name)


def test_a_sequence_sharded_over_processes_needs_ring_or_ulysses():
    from shockwave_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from shockwave_tpu_torch.parallel.mesh import ProcessMesh

    mesh = ProcessMesh((1, 1, 2, 1), 0, 2, {}, {})
    with pytest.raises(ValueError, match="ring or ulysses"):
        TransformerLM(TransformerConfig(attention="flash"), mesh=mesh)


def test_the_process_mesh_places_ranks_row_major():
    """Four ranks with ``--seq_parallel 2``: two data groups of two seq
    shards, rank r at (r // 2, r % 2), each axis's group its line."""

    places = spawn_gang(_mesh_rank, 4)
    for rank, (sizes, data, seq, members) in enumerate(places):
        assert sizes == {"data": 2, "model": 1, "seq": 2, "pipe": 1}
        assert (data, seq) == (rank // 2, rank % 2)
        assert members == {"data": [rank % 2, rank % 2 + 2],
                           "seq": [rank - rank % 2, rank - rank % 2 + 1]}


def _mesh_rank(rank, world, addr):
    import torch.distributed as dist

    from shockwave_tpu_torch.parallel.mesh import make_process_mesh
    from torch_gang_runs import init_gloo

    init_gloo(rank, world, addr)
    mesh = make_process_mesh(seq_parallel=2)
    place = (mesh.sizes, mesh.index("data"), mesh.index("seq"), mesh.members)
    # Every group carries a sum over its line.
    for axis in ("data", "seq"):
        total = torch.tensor([float(rank)])
        dist.all_reduce(total, group=mesh.groups[axis])
        assert float(total) == sum(mesh.members[axis])
    dist.destroy_process_group()
    return place


# -- against the JAX package ---------------------------------------------


def _jax_seq_run(extra, steps, batch, feed=None):
    """The JAX program's ``build_family`` over a (1, 1, 2, 1) mesh of two
    CPU devices: its seed-0 parameters, and its losses and parameters
    after ``steps`` steps. ``feed(i, batch_fn)`` gives step i's batch
    (default: one draw from ``--seed``, as one process feeds it)."""
    import flax.linen as flax_nn
    import jax

    from shockwave_tpu.models.train import build_family as jax_build_family
    from shockwave_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from shockwave_tpu_torch.models.convert import params_from_jax

    args = train.parse_args(["--model", "Transformer", "-n", str(steps),
                             "--batch_size", str(batch), *extra])
    mesh = jax_make_mesh((1, 1, 2, 1), devices=jax.devices()[:2])
    variables, step, opt_state, batch_fn = jax_build_family(
        "Transformer", args, mesh)

    def params(tree):
        return params_from_jax(jax.tree.map(
            np.asarray, flax_nn.meta.unbox(tree)["params"]))

    start = params(variables)
    rng = np.random.default_rng(args.seed)
    step = jax.jit(step)
    losses = []
    for i in range(steps):
        batch = feed(i, batch_fn, mesh) if feed else batch_fn(rng)
        variables, opt_state, loss = step(variables, opt_state, batch)
        losses.append(float(loss))
    return start, losses, params(variables)


def _port_checkpoint(directory, extra, state):
    """A step-0 checkpoint of the port's program holding ``state``."""
    args = train.parse_args(["--model", "Transformer", "-n", "1", "--device",
                             "cpu", *extra])
    args.seq_parallel = 1
    model, _, opt, _ = train.build_family("Transformer", args, CPU)
    model.load_state_dict(state)
    train.FileCheckpoint(str(directory)).save(model, opt, 0)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_a_two_rank_seq_gang_tracks_the_jax_program(tmp_path, attention):
    """The port's two-process ``--seq_parallel 2`` gang, started from the
    JAX program's seed-0 parameters (a step-0 checkpoint), against the JAX
    program over a two-device seq mesh in one process on the same seed:
    losses within 1e-5 relative at each step, and every parameter after 2
    steps within 1e-4 (an AdamW step at lr 1e-3 moves a parameter by about
    1e-3 whatever its gradient's size, so where a gradient is near zero
    the two summation orders move it apart; 1.5e-5 measured). The JAX
    gang of two processes is not the reference: its batch is
    inconsistent (ROADMAP.md, queue 3, and the slow test below)."""
    extra = _seq_argv(attention, 64)
    start, jax_losses, jax_params = _jax_seq_run(extra, 2, 2)
    _port_checkpoint(tmp_path, extra, start)
    codes, outs, ranks = run_gang(2, "Transformer", steps=2, batch=2,
                                  extra=extra, checkpoint_dir=tmp_path,
                                  threads=1)
    assert codes == [0, 0], outs[0][-3000:]
    assert all("RESUMED" in out for out in outs)
    assert ranks[0] == ranks[1], ranks
    assert ranks[0][1] == pytest.approx(jax_losses, rel=TOL)
    saved = torch.load(tmp_path / train.CHECKPOINT_NAME)["model"]
    for name, value in jax_params.items():
        torch.testing.assert_close(saved[name], value, rtol=0, atol=1e-4,
                                   msg=name)


def _inconsistent_feed(seeds):
    """Step i's batch as the JAX gang globalises it: one ``P("data")``
    array over the mesh whose copy on device p is the draw from seed p."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rngs = [np.random.default_rng(s) for s in seeds]

    def feed(i, batch_fn, mesh):
        draws = [np.asarray(batch_fn(r)) for r in rngs]
        copies = [jax.device_put(d, dev)
                  for d, dev in zip(draws, mesh.devices.flat)]
        return jax.make_array_from_single_device_arrays(
            draws[0].shape, NamedSharding(mesh, P("data")), copies)

    return feed


def _per_shard_draw_losses(extra, state, steps, batch):
    """The port's model over a two-place mesh from ``state``, each
    sequence shard's inputs and next tokens taken from its own draw (shard
    s from ``--seed + s``): a rank-per-draw feed."""
    from shockwave_tpu_torch.models.small_models import token_xent

    args = train.parse_args(["--model", "Transformer", "-n", str(steps),
                             "--batch_size", str(batch), "--device", "cpu",
                             *extra])
    mesh = make_mesh((1, 1, 2, 1), [CPU, CPU])
    model, _, opt, _ = train.build_family("Transformer", args, CPU, mesh)
    model.load_state_dict(state)
    rngs = [np.random.default_rng(args.seed + s) for s in range(2)]
    L = args.seq_len // 2
    losses = []
    with one_thread():
        for _ in range(steps):
            draws = [r.integers(0, args.vocab_size, (batch, args.seq_len + 1))
                     for r in rngs]
            inputs, targets = (torch.from_numpy(np.concatenate(
                [d[:, s * L + o:(s + 1) * L + o] for s, d in enumerate(draws)],
                axis=1)) for o in (0, 1))
            opt.zero_grad(set_to_none=True)
            x, _ = model.trunk(inputs)
            loss = token_xent(model.head(x), targets)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    return losses


@pytest.mark.slow
def test_the_jax_seq_gang_reads_an_inconsistent_replicated_batch():
    """Why the JAX package's two-process ``--seq_parallel 2`` gang is not
    the port's reference (ROADMAP.md, queue 3): each process draws from
    ``--seed + process_index`` and ``host_local_array_to_global_array``
    declares the batch replicated across "seq" (``P("data")``, data axis
    1), so the array's two copies differ, which a JAX array's replicas
    must not. Its printed loss is the JAX program's in one process fed
    such an array; and it is no consistent batch's: not the one-process
    run from seed 0 or 1, nor the feed where each sequence shard takes its
    own rank's draw."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    extra = _seq_argv("ring", 64)
    from shockwave_tpu_torch.runtime.testing import free_port

    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shockwave_tpu.models.train", "--model",
         "Transformer", "-n", "2", "--batch_size", "4", *extra,
         "--distributed_addr", addr, "--num_workers", "2", "--worker_rank",
         str(rank)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gang = {float(re.search(r"steps=2 loss=([0-9.]+)", o).group(1))
            for o in outs}
    assert len(gang) == 1, outs
    (jax_gang,) = gang
    start, inconsistent, _ = _jax_seq_run(extra, 2, 4,
                                          _inconsistent_feed((0, 1)))
    assert abs(inconsistent[-1] - jax_gang) <= 5e-5  # printed to 4 places
    consistent = [_jax_seq_run(extra + ["--seed", str(seed)], 2, 4)[1][-1]
                  for seed in (0, 1)]
    consistent.append(_per_shard_draw_losses(extra, start, 2, 4)[-1])
    assert all(abs(jax_gang - c) > 1e-3 for c in consistent), (
        jax_gang, consistent)
