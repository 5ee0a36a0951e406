"""The port's fault injection (``shockwave_tpu_torch/runtime/faults.py``)
and the scheduler's fault application, against the JAX package's on the
same seeded inputs: the plan generators, victim selection, the
injector's queues and pairing, and simulations with worker crashes,
reclaims, re-adds and scheduler kills (the simulation half of
tests/test_faults.py)."""

import functools
import json

import pytest

from shockwave_tpu.runtime import faults as ref_faults
from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.tools import bench_sim

SEEDS = (0, 1, 7)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _plans(module, seed):
    return {
        "churn": module.generate_churn_plan(
            seed, horizon_s=24000.0, num_workers=64, target_events=60,
            solver_faults=4, scheduler_faults=2),
        "churn_defaults": module.generate_churn_plan(seed, 5000.0, 8),
        "streaming": module.generate_streaming_plan(
            seed, num_jobs=50, horizon_s=8000.0, num_workers=16,
            target_churn_events=30)[1],
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["churn", "churn_defaults", "streaming"])
def test_plans_are_the_reference_plans(kind, seed):
    """Every generator's plan is JSON-equal to the JAX package's."""
    ours = _plans(faults, seed)[kind]
    ref = _plans(ref_faults, seed)[kind]
    assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    again = faults.FaultPlan.from_json(ours.to_json())
    assert again.to_json() == ours.to_json()


@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_campaign_is_the_reference_campaign(seed):
    assert faults.generate_arrival_campaign(seed, 200, 9000.0) == (
        ref_faults.generate_arrival_campaign(seed, 200, 9000.0))
    arrivals, _ = faults.generate_streaming_plan(seed, 40, 3000.0, 8)
    assert arrivals == ref_faults.generate_streaming_plan(
        seed, 40, 3000.0, 8)[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_select_victims_is_the_reference_choice(seed):
    """Victims are sampled from the sorted live ids, clamped to the plan's
    floor, seeded by (plan seed, event id): the same in both packages on
    every event of a churn plan."""
    plan = faults.generate_churn_plan(seed, 24000.0, 64, target_events=80)
    ref_plan = ref_faults.FaultPlan.from_json(plan.to_json())
    live = {w: "v100" for w in range(3, 40)}
    for event, ref_event in zip(plan.events, ref_plan.events):
        if event.kind in ("worker_crash", "capacity_reclaim"):
            assert faults.select_victims(plan, event, live) == (
                ref_faults.select_victims(ref_plan, ref_event, live))
    tight = faults.FaultPlan(seed=seed, min_capacity=5)
    event = faults.FaultEvent(3, "worker_crash", count=4)
    assert faults.select_victims(tight, event, range(7)) == (
        ref_faults.select_victims(
            ref_faults.FaultPlan(seed=seed, min_capacity=5),
            ref_faults.FaultEvent(3, "worker_crash", count=4), range(7)))
    assert len(faults.select_victims(tight, event, range(7))) == 2


def _rpc_plan(module):
    return module.FaultPlan(seed=2, events=[
        module.FaultEvent(0, "rpc_error", method="Done", count=2),
        module.FaultEvent(1, "rpc_delay", method="Done", delay_s=0.5),
        module.FaultEvent(2, "rpc_drop", method="SubmitJobs"),
        module.FaultEvent(3, "worker_crash", at_s=10.0),
        module.FaultEvent(4, "worker_add", at_s=5.0),
        module.FaultEvent(5, "solver_timeout", round=1),
    ])


def _drive(module):
    """One fixed sequence of injector calls; what each returned."""
    injector = module.configure(_rpc_plan(module))
    out = [[e.event_id for e in injector.due_cluster_events(4.0)],
           [e.event_id for e in injector.due_cluster_events(20.0)]]
    sleeps = []
    for method in ("Done", "Done", "Done", "Done", "SubmitJobs"):
        try:
            module.check_rpc(method, sleep=sleeps.append,
                             kinds=("rpc_error", "rpc_delay"))
            out.append(("ok", method))
        except module.InjectedRpcError as e:
            out.append((e.kind, e.event_id, e.method))
    out.append(injector.rpc_fault("SubmitJobs", kinds=("rpc_drop",))
               .event_id)
    module.note_rpc_success("Done")
    out.append(injector.next_solver_fault(0))
    out.append(injector.next_solver_fault(1).event_id)
    out.append(sleeps)
    out.append(injector.summary())
    out.append(sorted(injector.recovered))
    return out


def test_injector_queues_and_rpc_matching_are_the_reference():
    """Cluster events pop in time order, RPC faults are matched call by
    call (restricted by kind), a success pairs the applied RPC faults
    with recoveries, and the summary is the JAX package's."""
    assert _drive(faults) == _drive(ref_faults)


def test_injector_off_is_a_noop():
    assert faults.active() is None
    faults.check_rpc("Done")
    faults.note_rpc_success("Done")


# ----------------------------------------------------------------------
# Simulations (tests/test_faults.py:231, :269, :300 without the decision
# log), through both packages.
# ----------------------------------------------------------------------
def _sim_jobs(job_cls, steps_per_epoch, n, epochs=2, gap=60.0):
    jobs, arrivals = [], []
    for i in range(n):
        model, bs = [("ResNet-18", 32), ("ResNet-50", 64)][i % 2]
        jobs.append(job_cls(job_type=f"{model} (batch size {bs})",
                            command="python3 main.py",
                            total_steps=steps_per_epoch(model, bs) * epochs,
                            scale_factor=1, mode="static"))
        arrivals.append(i * gap)
    return jobs, arrivals


SIM_CASES = {
    "crash_and_reclaim": (
        lambda m: m.FaultPlan(seed=5, min_capacity=2, events=[
            m.FaultEvent(0, "worker_crash", at_s=250.0, count=1),
            m.FaultEvent(1, "capacity_reclaim", at_s=450.0, count=1)]),
        "max_min_fairness", 5, 3),
    "reclaim_then_add": (
        lambda m: m.FaultPlan(seed=6, min_capacity=1, max_capacity=4,
                              events=[
            m.FaultEvent(0, "capacity_reclaim", at_s=200.0, count=2),
            m.FaultEvent(1, "worker_add", at_s=500.0, count=2,
                         worker_type="v100")]),
        "max_min_fairness", 4, 2),
    "shockwave_crash": (
        lambda m: m.FaultPlan(seed=7, min_capacity=2, events=[
            m.FaultEvent(0, "worker_crash", at_s=300.0, count=1),
            m.FaultEvent(1, "solver_timeout", round=2)]),
        "shockwave_tpu", 4, 2),
}


def _simulate(package: str, case: str):
    plan_of, policy, n, epochs = SIM_CASES[case]
    if package == "jax":
        from shockwave_tpu.core.job import Job
        from shockwave_tpu.core.scheduler import Scheduler
        from shockwave_tpu.data.default_oracle import generate_oracle
        from shockwave_tpu.data.profiles import synthesize_profiles
        from shockwave_tpu.data.workload_info import steps_per_epoch
        from shockwave_tpu.policies import get_policy
        module, policy_obj = ref_faults, get_policy(policy)
    else:
        from shockwave_tpu_torch.core.job import Job
        from shockwave_tpu_torch.core.scheduler import Scheduler
        from shockwave_tpu_torch.data.default_oracle import generate_oracle
        from shockwave_tpu_torch.data.profiles import synthesize_profiles
        from shockwave_tpu_torch.data.workload_info import steps_per_epoch
        from shockwave_tpu_torch.policies import get_policy
        module, policy_obj = faults, get_policy(policy, device="cpu")
    injector = module.configure(plan_of(module))
    jobs, arrivals = _sim_jobs(Job, steps_per_epoch, n, epochs)
    oracle = generate_oracle()
    config = None
    if policy.startswith("shockwave"):
        config = {"num_gpus": 4, "time_per_iteration": 120,
                  "future_rounds": 6, "lambda": 2.0, "k": 1e-3,
                  "plan_deadline_s": 30.0}
    sched = Scheduler(policy_obj, throughputs=oracle, seed=0,
                      time_per_iteration=120,
                      profiles=synthesize_profiles(jobs, oracle),
                      shockwave_config=config)
    makespan = sched.simulate({"v100": 4}, arrivals, jobs)
    module.reset()
    return makespan, sched, injector


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulated_faults_match_the_reference(case):
    """The same worker ids survive, the injector's summary and recovery
    records are equal, no job is lost or charged a failed attempt, and
    the metrics are the JAX package's."""
    ours, sched, injector = _simulate("port", case)
    ref, ref_sched, ref_injector = _simulate("jax", case)
    assert ours == pytest.approx(ref, abs=1e-9)
    assert sched._worker_ids == ref_sched._worker_ids
    assert sched._cluster_spec == ref_sched._cluster_spec
    assert injector.summary() == ref_injector.summary()
    assert injector.summary()["unrecovered"] == []
    assert injector.recovered == ref_injector.recovered
    assert {j.integer: t for j, t in sched._job_completion_times.items()
            } == pytest.approx({j.integer: t for j, t in
                                ref_sched._job_completion_times.items()})
    assert all(t is not None for t in sched._job_completion_times.values())
    assert all(c < 5 for c in sched._num_failures_per_job.values())
    assert sched.get_num_preemptions() == ref_sched.get_num_preemptions()
    if case == "shockwave_crash":
        assert sched._shockwave.num_gpus == 3
        degraded = [r for r in sched._shockwave.solve_records
                    if r.get("degraded")]
        assert degraded and degraded[0]["fallback_from"] == "tpu"


def _golden_churn(module, scheduler_only=False):
    plan = module.generate_churn_plan(
        3, horizon_s=13000.0, num_workers=8, target_events=14,
        solver_faults=1, scheduler_faults=2)
    if scheduler_only:
        plan.events = [e for e in plan.events
                       if e.kind in module.SCHEDULER_KINDS]
    return plan


def _ref_golden(policy, plan=None):
    from shockwave_tpu.core.scheduler import Scheduler
    from shockwave_tpu.data import load_or_synthesize_profiles, parse_trace
    from shockwave_tpu.data.default_oracle import generate_oracle
    from shockwave_tpu.policies import get_policy

    trace = str(bench_sim.GOLDEN_TRACE)
    jobs, arrivals = parse_trace(trace)
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(trace, jobs, oracle, cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    injector = ref_faults.configure(plan) if plan is not None else None
    sched = Scheduler(get_policy(policy), throughputs=oracle, seed=0,
                      time_per_iteration=120.0, profiles=profiles,
                      shockwave_config={"num_gpus": 8,
                                        "time_per_iteration": 120.0,
                                        "future_rounds": 20, "lambda": 5.0,
                                        "k": 10.0})
    makespan = sched.simulate({"v100": 8}, arrivals, jobs)
    ref_faults.reset()
    ftf, _ = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), rounds=sched._num_completed_rounds,
                **bench_sim.sim_features(sched, injector))


@functools.lru_cache(maxsize=None)
def _churned(policy: str, package: str) -> dict:
    """The golden trace under ``_golden_churn``, run once a process."""
    if package == "jax":
        return _ref_golden(policy, _golden_churn(ref_faults))
    return bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, "cpu",
                               fault_plan=_golden_churn(faults))


@pytest.mark.parametrize("policy", ["shockwave_tpu_level",
                                    "shockwave_tpu_pdhg"])
def test_golden_churn_is_within_the_reference(policy):
    """The golden trace with a churn plan (crashes, reclaims, re-adds, a
    solver timeout and two scheduler kills): within 1e-3 of the JAX
    package in its rounds, the same survivors, recoveries and round log,
    every scheduler kill a bit-exact round trip."""
    r, ref = _churned(policy, "port"), _churned(policy, "jax")
    assert bench_sim.check_run(r, {k: ref[k] for k in (
        "makespan", "avg_jct", "worst_ftf", "rounds")}) == []
    assert r["faults"] == ref["faults"]
    assert r["faults"]["unrecovered"] == []
    assert r["worker_ids"] == ref["worker_ids"]
    # No job is lost to the churn: the one job the unfaulted golden run
    # leaves unfinished (LM, gns) is the only one here too.
    assert r["lost_jobs"] == ref["lost_jobs"] == [2]
    assert r["admitted"] == ref["admitted"] == 12
    assert r["dropped_jobs"] == ref["dropped_jobs"]
    kills = [v for v in r["recoveries"].values()
             if v["how"].startswith("journal_state_restored")]
    assert len(kills) == 4 and all(v["roundtrip_exact"] for v in kills)
    assert bench_sim.recoveries_without_hashes(r["recoveries"]) == (
        bench_sim.recoveries_without_hashes(ref["recoveries"]))
    assert bench_sim.round_log_misses(r["round_log"], ref["round_log"],
                                      bench_sim.TOLERANCE) == []


def test_scheduler_kills_alone_leave_the_unfaulted_digits():
    """A plan holding only scheduler kills round-trips the whole control
    plane through the codec's JSON twice, and the run gives the unfaulted
    run's digits and round log exactly."""
    plan = _golden_churn(faults, scheduler_only=True)
    assert [e.kind for e in plan.events] == [
        "scheduler_crash", "scheduler_restart"] * 2
    r = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, "shockwave_tpu_level",
                            8, "cpu", fault_plan=plan)
    clean = bench_sim.run_trace(bench_sim.GOLDEN_TRACE,
                                "shockwave_tpu_level", 8, "cpu")
    for k in ("makespan", "avg_jct", "worst_ftf", "rounds", "lost_jobs",
              "dropped_jobs"):
        assert r[k] == clean[k]
    assert r["round_log"] == clean["round_log"]
    assert r["faults"]["applied"] == 4
    assert all(v["roundtrip_exact"] for v in r["recoveries"].values())
    assert bench_sim.check_run(clean, bench_sim.GOLDEN[
        "shockwave_tpu_level"]) == []


def test_fault_plan_cli_prints_the_injector_counts(tmp_path, capsys):
    """``simulate --fault-plan`` arms the plan before the scheduler exists
    and prints the reference's ``Faults:`` line."""
    from shockwave_tpu_torch import simulate

    path = tmp_path / "plan.json"
    path.write_text(_golden_churn(faults).to_json())
    result = simulate.main([
        "-t", str(bench_sim.GOLDEN_TRACE), "-p", "shockwave_tpu_level", "-c",
        "v100=8", "--time_per_iteration", "120", "--device", "cpu",
        "--no_profile_cache", "--fault-plan", str(path)])
    summary = result["faults"]
    out = capsys.readouterr().out
    assert (f"Faults: {summary['applied']} applied, "
            f"{summary['recovered']} recovered, 0 unrecovered") in out
    ref = _churned("shockwave_tpu_level", "jax")
    assert summary == ref["faults"]
    assert result["makespan"] == pytest.approx(ref["makespan"], abs=1e-3)


def test_the_reference_inexact_round_trips_differ_only_in_set_order(
        monkeypatch):
    """The JAX package reports some scheduler kills of the golden churn
    plan as inexact: its capture lists each set in iteration order, and a
    set rebuilt from that list can iterate in another. Its captures
    before and after every kill are equal once the sets are sorted, as
    the port's capture lists them, and the port's kills are all exact."""
    from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
    from shockwave_tpu.obs.recorder import encode

    pairs = []
    real = RefScheduler._sim_scheduler_restart_roundtrip

    def capturing(self, running_jobs, queued_jobs=None):
        def canonical():
            state = self.ha_state_dict()
            state["sets"] = {f: sorted(v) for f, v in state["sets"].items()}
            return json.dumps(encode(state), sort_keys=True)

        before = canonical()
        out = real(self, running_jobs, queued_jobs)
        pairs.append((out["roundtrip_exact"], before == canonical()))
        return out

    monkeypatch.setattr(RefScheduler, "_sim_scheduler_restart_roundtrip",
                        capturing)
    ref = _ref_golden("shockwave_tpu_level", _golden_churn(ref_faults))
    assert len(pairs) == 4
    assert [exact for exact, _ in pairs].count(False) >= 1
    assert all(canonical_equal for _, canonical_equal in pairs)
    r = _churned("shockwave_tpu_level", "port")
    assert all(v["roundtrip_exact"] for v in r["recoveries"].values()
               if "roundtrip_exact" in v)
    assert r["makespan"] == pytest.approx(ref["makespan"], abs=1e-3)
