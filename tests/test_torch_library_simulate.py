"""The rest of the policy library through the port's scheduler against the
JAX package's, on the CPU.

The packed policies (pairs of jobs of one scale factor space-sharing a
worker, with the scheduler's pair throughputs, priorities and placement),
Gandiva, AlloX, the cost-normalized and SLO throughput sums and
``shockwave``, the exact MILP, drive both packages' schedulers on the
cells ``bench_sim`` pins (``bench_sim.library_runs``: the committed
12-job trace under each name, AlloX on its single-GPU jobs, the SLO
programs with deadlines, the 220-job trace on 64 GPUs under ``gandiva``
and ``max_min_fairness_packed``); each golden-trace run equals the JAX
package's live run in every printed metric, its rounds, SLO violations
and MILP statuses, and every run is within 1e-3 of its pin (the JAX
package's run) under this host's scipy. The e2e contracts of
tests/test_policies_e2e.py run on the port with the JAX package's
completion times, and where the JAX package fails (AlloX on multi-GPU
jobs, strategy-proof max-min in any run) the port fails too.
"""

import pytest
import scipy

from gavel_reference import ref_run
from shockwave_tpu_torch.tools import bench_sim
from test_simulator import run_sim as ref_run_sim
from test_simulator import tiny_trace as ref_tiny_trace
from test_torch_gavel_simulate import METRICS
from test_torch_policies import run_sim, tiny_trace

RUNS = {f"{table}-{key or args[1]}": (table, key, args, kwargs)
        for table, key, args, kwargs in bench_sim.library_runs()}


@pytest.mark.parametrize("cell", sorted(RUNS))
def test_library_run_equals_the_reference(cell):
    """The golden-trace cells against the JAX package's live run; the
    220-job cells (~7 s a run here) against its pinned run, which
    tests/gavel_reference.py reproduces."""
    table, key, args, kwargs = RUNS[cell]
    port = bench_sim.run_trace(*args, "cpu", **kwargs)
    if table != "PACKED_220":
        ref = ref_run(*args, **kwargs)
        assert bench_sim.check_run(port, {k: ref[k] for k in METRICS}) == []
        for k in ("rounds", "unfair_fraction", "slo_violations",
                  "milp_statuses"):
            assert port[k] == ref[k], k
    assert bench_sim.check_run(port, bench_sim.pinned(
        table, key, scipy.__version__)) == []
    if args[1] == "shockwave":
        # Every MILP call ended optimal within its gap: the run does not
        # hang on the clock.
        assert set(port["milp_statuses"]) == {0}
        assert port["solves"] == {"reference": port["milp_statuses"][0] // 2}
    else:
        assert port["solves"] == {} and port["allocations"] > 0
    assert not any(port["launches"].values()) and not port["device_solves"]


def same_completions(sched, ref_sched) -> None:
    assert ({j.integer: t for j, t in sched._job_completion_times.items()}
            == {j.integer: t
                for j, t in ref_sched._job_completion_times.items()})


@pytest.mark.parametrize("policy", ["fifo_packed", "max_min_fairness_packed",
                                    "gandiva"])
def test_packing_policy_completes_the_tiny_trace_as_the_reference(policy):
    """tests/test_policies_e2e.py::test_packing_policy_completes_trace on
    the port, with the JAX package's completion times."""
    jobs, arrivals = tiny_trace(num_jobs=6, epochs=2)
    sched, makespan = run_sim(policy, jobs, arrivals, cluster={"v100": 2})
    assert len(sched._job_completion_times) == 6
    assert all(t is not None and t > 0
               for t in sched._job_completion_times.values())
    ref_jobs, ref_arrivals = ref_tiny_trace(num_jobs=6, epochs=2)
    ref_sched, ref_makespan = ref_run_sim(policy, ref_jobs, ref_arrivals,
                                          cluster={"v100": 2})
    assert makespan == ref_makespan
    same_completions(sched, ref_sched)
    assert sched.get_cluster_utilization() == (
        ref_sched.get_cluster_utilization())


def test_allox_completes_single_gpu_jobs_as_the_reference():
    jobs, arrivals = tiny_trace(num_jobs=4, epochs=2)
    sched, makespan = run_sim("allox", jobs, arrivals, cluster={"v100": 2})
    assert len(sched._job_completion_times) == 4
    ref_jobs, ref_arrivals = ref_tiny_trace(num_jobs=4, epochs=2)
    ref_sched, ref_makespan = ref_run_sim("allox", ref_jobs, ref_arrivals,
                                          cluster={"v100": 2})
    assert makespan == ref_makespan
    same_completions(sched, ref_sched)


@pytest.mark.parametrize("slo, gpus", [(2.0, 2), (100.0, 2), (0.05, 1)])
def test_slo_deadlines_and_violations_equal_the_reference(slo, gpus):
    """tests/test_policies_e2e.py's SLO contracts (:58-104) on the port:
    the deadlines are kept after completion, generous SLOs are all met,
    and on one GPU an SLO of 0.05 x a 1000 s isolated duration is met by
    the first job only; the JAX package's counts and times."""
    policy = "max_sum_throughput_normalized_by_cost_perf_SLOs"
    runs = []
    for make, simulate in ((tiny_trace, run_sim),
                           (ref_tiny_trace, ref_run_sim)):
        jobs, arrivals = make(num_jobs=3, epochs=2)
        for job in jobs:
            job.SLO = slo
            job.duration = 1000.0
        runs.append(simulate(policy, jobs, arrivals,
                             cluster={"v100": gpus})[0])
    sched, ref_sched = runs
    assert len(sched._job_completion_times) == 3
    assert len(sched._slos) == 3
    assert {j.integer: d for j, d in sched._slos.items()} == {
        j.integer: d for j, d in ref_sched._slos.items()}
    violations = sched.get_num_SLO_violations()
    assert violations == ref_sched.get_num_SLO_violations()
    if slo == 100.0:
        assert violations == 0
    if slo == 0.05:
        assert violations >= 2
    same_completions(sched, ref_sched)


def test_packed_slo_run_stalls_as_the_reference():
    """Under SLO 1.5 on the golden trace the packed SLO program gives its
    whole share to a pair that cannot run, and both packages' runs stall
    with the same two jobs left: after 400 rounds their clocks, jobs and
    allocations are equal."""
    from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
    from shockwave_tpu.data import load_or_synthesize_profiles as ref_load
    from shockwave_tpu.data import parse_trace as ref_parse
    from shockwave_tpu.policies import get_policy as ref_get_policy
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data import (
        load_or_synthesize_profiles,
        parse_trace,
    )
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.policies import get_policy

    policy = "max_sum_throughput_normalized_by_cost_packed_SLOs"
    trace = str(bench_sim.GOLDEN_TRACE)
    states = []
    for parse, load, sched_cls, make in (
            (parse_trace, load_or_synthesize_profiles, Scheduler,
             lambda: get_policy(policy, device="cpu", seed=0)),
            (ref_parse, ref_load, RefScheduler,
             lambda: ref_get_policy(policy, seed=0))):
        jobs, arrivals = parse(trace)
        oracle = generate_oracle()
        profiles = load(trace, jobs, oracle, cache=False)
        for i, job in enumerate(jobs):
            job.duration = sum(profiles[i]["duration_every_epoch"])
            job.SLO = 1.5
        sched = sched_cls(make(), throughputs=oracle, seed=0,
                          time_per_iteration=120.0, profiles=profiles)
        clock = sched.simulate({"v100": 8}, arrivals, jobs, max_rounds=400)
        states.append((clock, sorted(j.integer for j in sched._jobs),
                       {tuple(j): v for j, v in sched._allocation.items()}))
    assert states[0] == states[1]
    assert len(states[0][1]) == 2


@pytest.mark.parametrize("num_jobs, gap", [(4, 0.0), (5, 30.0)])
def test_strategy_proof_fails_where_the_reference_fails(num_jobs, gap):
    """Strategy-proof max-min cannot drive a run in the JAX package: with
    every job there its allocation is (allocation, discounts), which the
    round path cannot take (a ValueError from numpy there), and with one
    job its leave-one-out sub-problem has none (an AttributeError). The
    port raises a ValueError and a RuntimeError naming the cause."""
    policy = "max_min_fairness_strategy_proof"
    jobs, arrivals = tiny_trace(num_jobs=num_jobs, epochs=2, arrival_gap=gap)
    expected = (ValueError, "discount") if gap == 0.0 else (
        RuntimeError, "leave-one-out")
    with pytest.raises(expected[0], match=expected[1]):
        run_sim(policy, jobs, arrivals, cluster={"v100": 2})
    ref_jobs, ref_arrivals = ref_tiny_trace(num_jobs=num_jobs, epochs=2,
                                            arrival_gap=gap)
    with pytest.raises(ValueError if gap == 0.0 else AttributeError):
        ref_run_sim(policy, ref_jobs, ref_arrivals, cluster={"v100": 2})


def test_allox_fails_on_the_golden_trace_as_the_reference():
    with pytest.raises(ValueError, match="scale factor 1"):
        bench_sim.run_trace(bench_sim.GOLDEN_TRACE, "allox", 8, "cpu")
    with pytest.raises(ValueError, match="scale factor 1"):
        ref_run(bench_sim.GOLDEN_TRACE, "allox", 8)
