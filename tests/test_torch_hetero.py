"""The port's per-worker-type pool sets against the JAX package's, on the
CPU.

Every test of tests/test_hetero_shockwave.py, each run also run by the
JAX package and held to it within 1e-3 (makespan, average JCT, worst
FTF, rounds, every job's completion time and the pools' admissions): a
mixed cluster with ``"hetero_pools": true`` plans one pool a worker type
(``PoolSetPlanner``), a gang never lands in a pool too narrow for it, a
one-type cluster and the flag off keep the single planner, the pool set
beats the reference's v100-only planning on the JAX package's own A/B
trace (``traces/generated_120_dynamic.trace`` on v100:8 p100:4 k80:4,
scripts/analysis/hetero_pools_ab.py), and a pool set survives a
checkpoint. A ``pool_set`` state dict the JAX package wrote loads in the
port.
"""

import numpy as np
import pytest
import torch

from shockwave_tpu.policies.shockwave import PoolSetPlanner as RefPoolSet
from shockwave_tpu_torch.policies.shockwave import (
    PoolSetPlanner,
    ShockwavePlanner,
    planner_from_state,
)
from shockwave_tpu_torch.tools import bench_sim
from test_simulator import tiny_trace
from test_torch_checkpoint import assert_near, metrics, run

TRACE_120 = str(bench_sim.TRACE_120)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(cluster, hetero_pools=True, num_gpus=None, future_rounds=8):
    """tests/test_hetero_shockwave.py::run_hetero's planner config."""
    if num_gpus is None:
        num_gpus = (sum(cluster.values()) if hetero_pools
                    else cluster.get("v100", next(iter(cluster.values()))))
    return {"num_gpus": num_gpus, "time_per_iteration": 120,
            "future_rounds": future_rounds, "lambda": 5.0, "k": 10.0,
            "hetero_pools": hetero_pools}


def run_both(cluster, trace_fn, cfg, policy="shockwave_tpu", **simulate):
    """The port's run, after holding it to the JAX package's."""
    ref_sched, ref_mk = run("jax", policy, trace_fn(), cluster, cfg,
                            **simulate.pop("ref_simulate", {}))
    sched, mk = run("port", policy, trace_fn(), cluster, cfg, **simulate)
    assert_near(metrics(sched, mk), metrics(ref_sched, ref_mk))
    assert type(sched._shockwave).__name__ == type(
        ref_sched._shockwave).__name__
    assert dict(getattr(sched._shockwave, "assignments", {})) == dict(
        getattr(ref_sched._shockwave, "assignments", {}))
    assert sched._worker_time_so_far == pytest.approx(
        ref_sched._worker_time_so_far, abs=1e-3)
    return sched, mk


def contended():
    # Simultaneous arrivals: an uncontended cluster routes every job to
    # the fastest pool, so the pools show only under contention.
    return tiny_trace(num_jobs=8, epochs=3, arrival_gap=0.0)


@pytest.mark.parametrize("policy", ["shockwave_tpu", "shockwave_tpu_pdhg"])
def test_multi_type_cluster_plans_every_pool(policy):
    cluster = {"v100": 2, "k80": 2}
    sched, makespan = run_both(cluster, contended, config(cluster), policy)
    assert isinstance(sched._shockwave, PoolSetPlanner)
    assert set(sched._shockwave.pools) == {"v100", "k80"}
    assert len(sched._job_completion_times) == 8
    assert all(t is not None for t in sched._job_completion_times.values())
    assignments = sched._shockwave.assignments
    assert all(n > 0 for n in assignments.values()), assignments
    assert sched._worker_time_so_far["k80"] > 0
    assert sched._worker_time_so_far["v100"] > 0
    assert assignments["v100"] >= assignments["k80"]
    # Every pool's child solves on the planner's device.
    assert {str(c.device) for c in sched._shockwave.children.values()} == {
        "cpu"}
    pools = {r["pool"] for r in sched._shockwave.solve_records}
    assert pools == {"v100", "k80"}
    assert makespan > 0


def test_wide_gangs_never_assigned_to_narrow_pool():
    def trace():
        return tiny_trace(num_jobs=6, epochs=2, arrival_gap=60.0,
                          scale_factors=[2] * 6)

    cluster = {"v100": 4, "k80": 1}
    sched, _ = run_both(cluster, trace, config(cluster, num_gpus=5))
    assert len(sched._job_completion_times) == 6
    assert all(t is not None for t in sched._job_completion_times.values())
    assert sched._shockwave.assignments.get("k80", 0) == 0


def test_single_type_cluster_keeps_single_planner():
    cluster = {"v100": 2}
    sched, _ = run_both(cluster, contended, config(cluster))
    assert isinstance(sched._shockwave, ShockwavePlanner)


def test_flag_off_keeps_reference_parity_on_mixed_cluster():
    cluster = {"v100": 2, "k80": 2}
    sched, _ = run_both(cluster, contended, config(cluster, False))
    assert isinstance(sched._shockwave, ShockwavePlanner)
    assert float(sched._worker_time_so_far.get("k80", 0.0)) == 0.0


def test_hetero_beats_idle_pool_parity_on_reference_trace():
    """The JAX package's A/B trace and cluster (v100:8 p100:4 k80:4, 20
    future rounds): planning every pool beats planning the v100 pool
    alone, in both packages, and each port run is the JAX package's."""
    from shockwave_tpu.data import parse_trace as ref_parse

    cluster = bench_sim.POOLS_120_CLUSTER

    def trace():
        return ref_parse(TRACE_120)

    runs = {}
    for hetero in (True, False):
        cfg = config(cluster, hetero, num_gpus=16 if hetero else 8,
                     future_rounds=20)
        runs[hetero] = run_both(cluster, trace, cfg)[1]
    assert runs[True] < runs[False], runs


def test_hetero_checkpoint_resume(tmp_path):
    """The pool set (children, job-to-pool map, admissions) round-trips
    through the simulator checkpoint; the resumed run is the unbroken
    one, and the JAX package's resumed run (which redraws the
    worker-type shuffle from the seed, as the port's does) too."""
    ckpt, ref_ckpt = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    cluster = {"v100": 2, "k80": 2}
    cfg = config(cluster)
    unbroken, mk = run_both(cluster, contended, cfg)
    saving, mk_a = run_both(
        cluster, contended, cfg, checkpoint_threshold=4,
        checkpoint_file=ckpt,
        ref_simulate=dict(checkpoint_threshold=4, checkpoint_file=ref_ckpt))
    resumed, mk_b = run_both(cluster, contended, cfg, checkpoint_file=ckpt,
                             ref_simulate=dict(checkpoint_file=ref_ckpt))
    assert isinstance(resumed._shockwave, PoolSetPlanner)
    assert metrics(resumed, mk_b) == metrics(unbroken, mk)
    assert metrics(saving, mk_a) == metrics(unbroken, mk)
    assert resumed._pool_ftf_scale == unbroken._pool_ftf_scale


def test_jax_pool_set_state_loads_in_the_port():
    """A ``pool_set`` state dict of the JAX package's PoolSetPlanner
    restores in the port, key for key, on the device it is given, and
    plans the same rounds."""
    from test_pipelining import make_profile

    cfg = {"num_gpus": 6, "time_per_iteration": 120.0, "future_rounds": 4}
    ref = RefPoolSet(cfg, "tpu", {"v100": 4, "k80": 2})
    for i in range(5):
        ref.add_job(f"job{i}", make_profile([32] * 6, [200.0] * 6), 120.0,
                    1 + (i == 2), pool=("k80" if i % 2 else "v100"),
                    duration_scale=(2.5 if i % 2 else 1.0))
    ref.current_round_schedule()
    ref.increment_round()
    state = ref.state_dict()
    port = planner_from_state(state, device="cpu")
    assert isinstance(port, PoolSetPlanner)
    assert port.state_dict().keys() == state.keys()
    assert port.job_pool == ref.job_pool and port.pools == ref.pools
    assert port.assignments == ref.assignments
    for wt, child in port.children.items():
        assert child.device == torch.device("cpu")
        assert child.round_index == ref.children[wt].round_index
        assert dict(child.schedules) == dict(ref.children[wt].schedules)
    assert port.current_round_schedule_by_pool() == (
        ref.current_round_schedule_by_pool())
    assert np.isclose(
        sum(port.children["k80"].job_metadata["job1"].epoch_durations),
        sum(ref.children["k80"].job_metadata["job1"].epoch_durations))
