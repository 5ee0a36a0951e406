"""The port's Gavel round path against the JAX package's, on the CPU.

Gavel's policies drive the port's scheduler (the allocation, the
per-type priorities and deficits, the greedy pass in priority order):
``fifo`` and ``max_min_fairness`` on the committed 12-job trace give
tests/test_golden.py's metrics; every ported policy of
tests/test_policies_e2e.py's ``GENERAL_POLICIES`` completes its tiny trace
with the JAX package's completion times; and the 220-job trace on a
heterogeneous cluster (v100:16 p100:16 k80:16, 4 GPUs a server) gives the
JAX package's metrics under every policy of ``bench_sim.HETERO``, within
1e-3 and in the same number of rounds. The base-mode cells there
(``fifo``, ``max_min_fairness``) draw the worker-type shuffle from the
scheduler's seeded stream each round, and FIFO its worker types from its
own. The JAX package's side runs through tests/gavel_reference.py, which
also pins the constants ``chip_smoke.py`` holds the card's machine to, per
scipy version; the tests hold the runs to the pins of this host's scipy
(``bench_sim.pinned``), as the smoke does.
"""

import pytest
import scipy

import test_golden
from gavel_reference import gavel_cells, ref_run
from shockwave_tpu_torch.policies import get_available_policies
from shockwave_tpu_torch.tools import bench_sim
from test_policies_e2e import GENERAL_POLICIES
from test_simulator import run_sim as ref_run_sim
from test_simulator import tiny_trace as ref_tiny_trace
from test_torch_policies import run_sim, tiny_trace

METRICS = ("makespan", "avg_jct", "worst_ftf")


def assert_same_run(port: dict, ref: dict) -> None:
    assert bench_sim.check_run(port, {k: ref[k] for k in METRICS}) == []
    assert port["rounds"] == ref["rounds"]
    assert port["unfair_fraction"] == ref["unfair_fraction"]


@pytest.mark.parametrize("policy", sorted(bench_sim.GOLDEN_GAVEL))
def test_golden_metrics_of_the_gavel_baselines(policy):
    assert bench_sim.GOLDEN_GAVEL[policy] == test_golden.GOLDEN[policy]
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, "cpu")
    assert bench_sim.check_run(result, bench_sim.pinned(
        "GOLDEN_GAVEL", policy, scipy.__version__)) == []
    assert result["solves"] == {} and result["allocations"] > 0


@pytest.mark.parametrize("policy", GENERAL_POLICIES)
def test_policy_completes_the_tiny_trace_as_the_reference(policy):
    """tests/test_policies_e2e.py::test_policy_completes_trace on the port,
    with the JAX package's completion times."""
    assert policy in get_available_policies()
    jobs, arrivals = tiny_trace(num_jobs=5, epochs=2, arrival_gap=30.0)
    sched, makespan = run_sim(policy, jobs, arrivals, cluster={"v100": 2})
    assert len(sched._job_completion_times) == 5
    assert all(t is not None and t > 0
               for t in sched._job_completion_times.values())
    assert makespan > 0
    ref_jobs, ref_arrivals = ref_tiny_trace(num_jobs=5, epochs=2,
                                            arrival_gap=30.0)
    ref_sched, ref_makespan = ref_run_sim(policy, ref_jobs, ref_arrivals,
                                          cluster={"v100": 2})
    assert makespan == ref_makespan
    assert ({j.integer: t for j, t in sched._job_completion_times.items()}
            == {j.integer: t
                for j, t in ref_sched._job_completion_times.items()})


@pytest.mark.parametrize("policy", sorted(bench_sim.HETERO))
def test_heterogeneous_cluster_equals_the_reference(policy):
    result = bench_sim.run_trace(bench_sim.TRACE_220, policy, 16, "cpu",
                                 cluster=bench_sim.HETERO_CLUSTER,
                                 gpus_per_server=4)
    ref = ref_run(bench_sim.TRACE_220, policy, 16,
                  cluster=bench_sim.HETERO_CLUSTER, gpus_per_server=4)
    assert_same_run(result, ref)
    assert bench_sim.check_run(ref, bench_sim.pinned(
        "HETERO", policy, scipy.__version__)) == []


def test_scipy_pins_name_pinned_cells():
    """Every per-version pin names a pinned cell, and
    tests/gavel_reference.py runs every pinned Gavel and library cell."""
    cells = {(table, key) for table, key, _, _ in gavel_cells()}
    library = {(table, key) for table, key, _, _ in bench_sim.library_runs()}
    for pins in bench_sim.SCIPY_PINS.values():
        assert set(pins) <= cells | library
    assert cells == {("GOLDEN_GAVEL", p) for p in bench_sim.GOLDEN_GAVEL} | {
        ("FIGURE9", k) for k in bench_sim.FIGURE9
        if not k[0].startswith("shockwave")} | {
        ("HETERO", p) for p in bench_sim.HETERO} | {("TIER_2048_MMF", None)}
    assert library == {("GOLDEN_LIBRARY", p)
                       for p in bench_sim.GOLDEN_LIBRARY} | {
        ("GOLDEN_SLO", p) for p in bench_sim.GOLDEN_SLO} | {
        ("PACKED_220", p) for p in bench_sim.PACKED_220} | {
        ("ALLOX_SINGLE", None)}
