"""Gang data parallelism of the port's training program over gloo: the
counterparts of ``tests/test_multihost.py``, each rank a real ``python -m
shockwave_tpu_torch.models.train`` process on the CPU.

The JAX program's gang draws a ``--batch_size`` batch on each rank from
``--seed + rank`` and steps on the global batch (each rank's batch one
shard of it along the mesh's data axis: the loss and BatchNorm's
statistics are the global batch's). So a two-rank gang's losses must
equal one process's on the two ranks' batches stacked.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.models import train
from shockwave_tpu_torch.runtime.testing import free_port

ROOT = Path(__file__).resolve().parent.parent
# ResNet's float32 BatchNorm over 2-image shards sums the moments in
# another order than one process over 4 images: the first step's loss is
# equal to the bit, later ones drift by float32 noise (2.6e-4 measured).
RESNET_RTOL = 1e-3
OTHER_RTOL = 1e-5
_GANG = re.compile(r"^GANG rank=(\d+) world=(\d+) params=(\w+) "
                   r"losses=(\[.*\])$", re.M)


def run_gang(num_ranks, model, steps=3, batch=2, extra=(), timeout_s=240,
             checkpoint_dir=None, threads=2):
    """``num_ranks`` ranks of the training program on the CPU, each with
    ``threads`` CPU threads; returns (exit codes, outputs, per-rank (params
    digest, losses))."""
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=str(ROOT))
    command = [sys.executable, "-m", "shockwave_tpu_torch.models.train",
               "--model", model, "-n", str(steps), "--batch_size",
               str(batch), "--device", "cpu", "--distributed_addr", addr,
               "--num_workers", str(num_ranks), *extra]
    if checkpoint_dir:
        command += ["--checkpoint_dir", str(checkpoint_dir)]
    procs = [subprocess.Popen(command + ["--worker_rank", str(rank)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(num_ranks)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout_s)[0])
    finally:
        # A failed rendezvous leaves the other ranks blocked: never leak
        # them past the test.
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = {}
    for out in outs:
        m = _GANG.search(out)
        if m:
            ranks[int(m.group(1))] = (m.group(3), json.loads(m.group(4)))
    return [p.returncode for p in procs], outs, ranks


def one_process_losses(model, num_ranks, steps=3, batch=2):
    """One process's losses on the ranks' batches stacked (rank r's from
    ``np.random.default_rng(seed + r)``), the weights from the seed."""
    args = train.parse_args(["--model", model, "-n", str(steps),
                             "--batch_size", str(batch * num_ranks),
                             "--device", "cpu"])
    _, step_fn, _, _ = train.build_family(model, args, torch.device("cpu"))
    shard_args = train.parse_args(["--model", model, "-n", str(steps),
                                   "--batch_size", str(batch), "--device",
                                   "cpu"])
    _, _, _, shard_fn = train.build_family(model, shard_args,
                                           torch.device("cpu"))
    rngs = [np.random.default_rng(args.seed + r) for r in range(num_ranks)]
    losses = []
    for _ in range(steps):
        shards = [shard_fn(rng) for rng in rngs]
        if isinstance(shards[0], tuple):
            batch_ = tuple(torch.cat(parts) for parts in zip(*shards))
        else:
            batch_ = torch.cat(shards)
        losses.append(float(step_fn(batch_)))
    return losses


def _assert_in_sync(codes, outs, ranks, num_ranks, steps):
    for rank, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert re.search(rf"steps={steps} loss=\S+ .* device=cpu$", out,
                         re.M), out[-2000:]
    assert sorted(ranks) == list(range(num_ranks))
    digests = {digest for digest, _ in ranks.values()}
    losses = [losses for _, losses in ranks.values()]
    # Every rank holds the same parameters and reports the same losses,
    # though each trained on its own shard.
    assert len(digests) == 1, ranks
    assert all(x == losses[0] for x in losses), ranks
    return losses[0]


@pytest.mark.parametrize("model,rtol", [("ResNet-18", RESNET_RTOL),
                                        ("LM", OTHER_RTOL)])
def test_two_process_gang_equals_one_process_on_the_global_batch(model,
                                                                  rtol):
    """Two ranks at batch 2 train as one process at batch 4 on the two
    ranks' draws: the same losses (ResNet's first bit for bit)."""
    codes, outs, ranks = run_gang(2, model)
    losses = _assert_in_sync(codes, outs, ranks, 2, 3)
    ref = one_process_losses(model, 2)
    assert losses[0] == pytest.approx(ref[0], rel=1e-6)
    assert losses == pytest.approx(ref, rel=rtol)


@pytest.mark.parametrize("backend,name", [
    ("msgpack", train.CHECKPOINT_NAME),
    ("orbax", train.DIRECTORY_CHECKPOINT_NAME)])
def test_gang_checkpoint_is_written_by_rank_zero_and_resumed_by_all(
        tmp_path, backend, name):
    """Rank 0 writes the gang's checkpoint (a file, or a directory outside
    the gang's process group); both ranks resume from it at the step it
    holds and stay in step."""
    extra = ("--ckpt_backend", backend)
    codes, outs, ranks = run_gang(2, "Recommendation", steps=2, batch=16,
                                  extra=extra, checkpoint_dir=tmp_path)
    _assert_in_sync(codes, outs, ranks, 2, 2)
    assert (tmp_path / name).exists()
    codes, outs, ranks = run_gang(2, "Recommendation", steps=1, batch=16,
                                  extra=extra, checkpoint_dir=tmp_path)
    _assert_in_sync(codes, outs, ranks, 2, 1)
    for out in outs:
        assert "RESUMED from" in out and "at step 2" in out


def test_rendezvous_timeout_fails_fast():
    """A rank whose rank 0 never arrives exits nonzero after its
    ``--distributed_timeout`` (rounded up to whole seconds), not on the
    default's 300 s."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    started = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "shockwave_tpu_torch.models.train", "--model",
         "Recommendation", "-n", "2", "--batch_size", "8", "--device", "cpu",
         "--distributed_addr", f"127.0.0.1:{free_port()}", "--num_workers",
         "2", "--worker_rank", "1", "--distributed_timeout", "2.2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert time.time() - started < 100
    assert "GANG" not in proc.stdout


@pytest.mark.parametrize("extra,what", [
    (["--model_parallel", "2"], "'model': 2"),
])
def test_what_a_gang_cannot_do_raises_naming_item_8(extra, what):
    """What once raised (item 8) runs: a two-rank Transformer gang with
    ``--model_parallel 2`` builds a mesh of that model axis, and both
    ranks report the same losses and the same whole parameters (the
    digest of their shares gathered)."""
    codes, outs, ranks = run_gang(
        2, "Transformer", steps=1, batch=2, threads=1,
        extra=["--d_model", "32", "--num_heads", "2", "--vocab_size", "64",
               "--seq_len", "16", *extra])
    for code, out in zip(codes, outs):
        assert code == 0, out[-3000:]
        assert "NotImplementedError" not in out
        assert re.search(rf"^MESH backend=gloo .*{what}", out, re.M), out
    assert sorted(ranks) == [0, 1] and ranks[0] == ranks[1], ranks


@pytest.mark.slow
def test_four_process_gang_trains_in_sync():
    """Four ranks (Recommendation, as the JAX test), one global batch:
    equal losses and parameters, equal to one process on the four
    shards."""
    codes, outs, ranks = run_gang(4, "Recommendation", steps=2, batch=8,
                                  timeout_s=300)
    losses = _assert_in_sync(codes, outs, ranks, 4, 2)
    assert losses == pytest.approx(
        one_process_losses("Recommendation", 4, steps=2, batch=8),
        rel=OTHER_RTOL)


@pytest.mark.slow
def test_gang_rank_death_fails_round_then_recovers(tmp_path):
    """A gang member dying mid-round fails the whole micro-task, the gang
    is retried next round and completes; a gang that always crashes is
    dropped at the failure cap (the JAX test's scenario on the port's
    localhost cluster)."""
    import threading

    from shockwave_tpu_torch.core.scheduler import MAX_FAILED_ATTEMPTS
    from shockwave_tpu_torch.runtime.testing import (
        distinct_rounds_launched,
        make_synthetic_job,
        start_local_cluster,
    )

    def gang_job(total_steps, crash_attempts=0):
        extra = f" --crash_attempts {crash_attempts}" if crash_attempts else ""
        return make_synthetic_job(total_steps, scale_factor=2,
                                  extra_args=extra)

    sched = start_local_cluster("fifo", 2, run_dir=str(tmp_path / "run"),
                                checkpoint_dir=str(tmp_path / "ckpt"))
    try:
        flaky = sched.add_job(gang_job(400, crash_attempts=1))
        doomed = sched.add_job(gang_job(400, crash_attempts=-1))
        runner = threading.Thread(target=sched.run,
                                  kwargs={"max_rounds": 25})
        runner.start()
        runner.join(timeout=250)
        assert not runner.is_alive(), "gang-failure round loop wedged"
        run_dir = tmp_path / "run"
        assert sched._job_completion_times.get(flaky) is not None
        assert sched._total_steps_run[flaky] >= 400
        assert len(distinct_rounds_launched(run_dir, flaky.integer)) >= 2
        assert sched._job_completion_times.get(doomed) is None
        assert doomed not in sched._jobs
        doomed_rounds = distinct_rounds_launched(run_dir, doomed.integer)
        assert 2 <= len(doomed_rounds) <= MAX_FAILED_ATTEMPTS
    finally:
        sched.shutdown()
