"""The port's simulator checkpoints against the JAX package's, on the CPU.

A run that saves its state once N jobs were admitted and runs on, and a
fresh scheduler resumed from that file, must both end where the port's
unbroken run ends, in every digit and in the same round count; and the
port's unbroken run must be within 1e-3 of the JAX package's unbroken run
of the same trace (tests/test_simulator.py:159-260, under a Gavel policy
and under the flat Shockwave planner, and here also under the pdhg
backend and the two-cell market). The JAX package's checkpoint leaves out
the worker-type shuffle's RNG, and so does the port's: a resumed run on
a cluster of several types draws that stream from the seed again, and
ends where the JAX package's resumed run ends
(tests/test_torch_hetero.py). The pickle holds the port's own job types,
so only the port reads its checkpoints back.
"""

import os
import pickle

import pytest
import torch

from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
from shockwave_tpu.data.default_oracle import generate_oracle as ref_oracle
from shockwave_tpu.data.profiles import synthesize_profiles as ref_profiles
from shockwave_tpu.policies import get_policy as ref_get_policy
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.profiles import synthesize_profiles
from shockwave_tpu_torch.policies import get_policy
from test_simulator import tiny_trace

TOLERANCE = 1e-3
JOB_FIELDS = ("job_type", "command", "working_directory", "num_steps_arg",
              "total_steps", "duration", "mode", "scale_factor",
              "priority_weight", "SLO", "needs_data_dir")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_jobs(jobs):
    """The JAX package's Jobs as the port's, field by field."""
    return [Job(**{f: getattr(j, f) for f in JOB_FIELDS}) for j in jobs]


def run(package, policy, trace, cluster, config=None, seed=0, **simulate):
    """One package's simulation of ``trace`` (a (jobs, arrivals) pair of
    the JAX package's Jobs) on ``cluster`` under ``policy``, with
    ``config`` as the Shockwave planner's config; the port's device
    solves on the CPU."""
    jobs, arrivals = trace
    if package == "port":
        jobs = port_jobs(jobs)
        oracle = generate_oracle()
        sched = Scheduler(
            get_policy(policy, device="cpu", seed=seed), throughputs=oracle,
            seed=seed, time_per_iteration=120,
            profiles=synthesize_profiles(jobs, oracle),
            shockwave_config=config)
    else:
        oracle = ref_oracle()
        sched = RefScheduler(
            ref_get_policy(policy, seed=seed), throughputs=oracle, seed=seed,
            time_per_iteration=120, profiles=ref_profiles(jobs, oracle),
            shockwave_config=config)
    makespan = sched.simulate(dict(cluster), list(arrivals), list(jobs),
                              **simulate)
    return sched, makespan


def metrics(sched, makespan) -> dict:
    ftf, _ = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf) if ftf else None,
                rounds=sched._num_completed_rounds,
                jcts={j.integer: t
                      for j, t in sched._job_completion_times.items()})


def assert_near(ours: dict, ref: dict) -> None:
    for key in ("makespan", "avg_jct", "worst_ftf", "rounds"):
        if ref[key] is None:
            assert ours[key] is None, key
        else:
            assert abs(ours[key] - ref[key]) <= TOLERANCE, (key, ours, ref)
    assert ours["jcts"].keys() == ref["jcts"].keys()
    for j, t in ref["jcts"].items():
        assert abs(ours["jcts"][j] - t) <= TOLERANCE, j


def check_resume(tmp_path, policy, trace_fn, cluster, config=None, seed=0,
                 threshold=4):
    """The port's unbroken run, held to the JAX package's; the port's run
    that saves at ``threshold`` admitted jobs and its resumed run, each
    equal to the port's unbroken run in every digit. Returns the
    checkpoint's path and the three schedulers."""
    ckpt = str(tmp_path / f"{policy}.ckpt")
    ref = metrics(*run("jax", policy, trace_fn(), cluster, config, seed))
    unbroken = run("port", policy, trace_fn(), cluster, config, seed)
    assert_near(metrics(*unbroken), ref)
    saving = run("port", policy, trace_fn(), cluster, config, seed,
                 checkpoint_threshold=threshold, checkpoint_file=ckpt)
    assert os.path.exists(ckpt)
    resumed = run("port", policy, trace_fn(), cluster, config, seed,
                  checkpoint_file=ckpt)
    for other in (saving, resumed):
        assert metrics(*other) == metrics(*unbroken)
    with open(ckpt, "rb") as f:
        saved = pickle.load(f)
    # The resumed run replays only the suffix.
    assert saved["fields"]["_num_completed_rounds"] > 0
    assert saved["fields"]["_job_id_counter"] >= threshold
    return ckpt, unbroken[0], saving[0], resumed[0]


def shockwave_config(num_gpus, **extra):
    return {"num_gpus": num_gpus, "time_per_iteration": 120,
            "future_rounds": 8, "lambda": 5.0, "k": 10.0, **extra}


def test_checkpoint_save_load_continue_determinism(tmp_path):
    """tests/test_simulator.py:159 under max_min_fairness, seed 3: the
    allocation state travels with the checkpoint."""
    def trace():
        return tiny_trace(num_jobs=8, epochs=2, arrival_gap=200.0)

    _, unbroken, _, resumed = check_resume(
        tmp_path, "max_min_fairness", trace, {"v100": 4}, seed=3,
        threshold=5)
    assert resumed.num_allocations == unbroken.num_allocations
    assert resumed._allocation == unbroken._allocation


def test_checkpoint_resume_shockwave(tmp_path):
    """tests/test_simulator.py:206 under shockwave_tpu: the planner's
    state (round cursor, plan cache, predictor metadata, finish-time
    history) travels with the scheduler's fields."""
    def trace():
        return tiny_trace(num_jobs=6, epochs=2, arrival_gap=200.0)

    ckpt, unbroken, _, resumed = check_resume(
        tmp_path, "shockwave_tpu", trace, {"v100": 2}, shockwave_config(2),
        seed=3)
    with open(ckpt, "rb") as f:
        assert pickle.load(f)["shockwave"] is not None
    assert resumed._shockwave.round_index == unbroken._shockwave.round_index
    assert (len(resumed._shockwave.solve_records)
            == len(unbroken._shockwave.solve_records))


def test_checkpoint_resume_pdhg(tmp_path):
    """Under shockwave_tpu_pdhg (kernel A's plain version on the CPU), a
    run with arrivals on either side of the save."""
    def trace():
        return tiny_trace(num_jobs=8, epochs=2, arrival_gap=150.0,
                          scale_factors=[1, 2, 1, 1, 2, 1, 1, 1])

    _, unbroken, _, resumed = check_resume(
        tmp_path, "shockwave_tpu_pdhg", trace, {"v100": 4},
        shockwave_config(4))
    assert [r["backend"] for r in resumed._shockwave.solve_records] == [
        r["backend"] for r in unbroken._shockwave.solve_records]


def test_checkpoint_resume_cells(tmp_path):
    """The two-cell market (its ``cell_set`` state) resumes on the device
    of the resuming scheduler's planner."""
    from shockwave_tpu_torch.cells.planner import CellPlanner

    def trace():
        return tiny_trace(num_jobs=8, epochs=2, arrival_gap=150.0)

    _, unbroken, _, resumed = check_resume(
        tmp_path, "shockwave_tpu_pdhg", trace, {"v100": 4},
        shockwave_config(4, cells=2))
    assert isinstance(resumed._shockwave, CellPlanner)
    assert str(resumed._shockwave.device) == "cpu"
    assert resumed._shockwave.job_cell == unbroken._shockwave.job_cell


def test_planner_state_into_a_gavel_scheduler_asserts(tmp_path):
    ckpt = str(tmp_path / "shockwave.ckpt")
    config = shockwave_config(2)
    run("port", "shockwave_tpu", tiny_trace(num_jobs=4, arrival_gap=200.0),
        {"v100": 2}, config, checkpoint_threshold=2, checkpoint_file=ckpt)
    with pytest.raises(AssertionError, match="policy is not Shockwave"):
        run("port", "max_min_fairness",
            tiny_trace(num_jobs=4, arrival_gap=200.0), {"v100": 2},
            checkpoint_file=ckpt)


def test_shockwave_from_a_planner_less_checkpoint_asserts(tmp_path):
    ckpt = str(tmp_path / "gavel.ckpt")
    run("port", "max_min_fairness", tiny_trace(num_jobs=4, arrival_gap=200.0),
        {"v100": 2}, checkpoint_threshold=2, checkpoint_file=ckpt)
    with pytest.raises(AssertionError, match="without planner state"):
        run("port", "shockwave_tpu",
            tiny_trace(num_jobs=4, arrival_gap=200.0), {"v100": 2},
            shockwave_config(2), checkpoint_file=ckpt)
