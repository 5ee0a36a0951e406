"""The port's plan-ahead speculation against the JAX package's, on the CPU.

The cases of tests/test_pipelining.py outside its flight-recorder halves
(``TestReplayExactness`` and ``TestRecorderOverlay`` wait for the
recorder's writer): no-churn runs equal to serial ones for the flat
planner and the two-cell market, churned runs that repair or miss and
lose nothing, repair solves tagged and on the pdhg backend, the
fingerprints and the reconcile state machine, a clone that shares no
mutable state (tensors included), and the Dirichlet change-point
reweight. Every run is also run by the JAX package on the same inputs,
and its rounds, metrics, hit / repair / miss counts and fingerprints
must equal it. Then the port's own divergence: a device fault (a
``KernelError``) in a speculative solve is raised at the reconcile, not
counted as a miss, and one in a repair solve is raised, not fallen back
from; other errors keep the JAX package's miss and fallback. The
daemon-thread path (``background=True``) runs here as well.
"""

import dataclasses

import numpy as np
import pytest
import torch

from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
from shockwave_tpu.data.default_oracle import generate_oracle as ref_oracle
from shockwave_tpu.data.generate import smoke_trace_jobs as ref_smoke
from shockwave_tpu.data.profiles import synthesize_profiles as ref_profiles
from shockwave_tpu.policies import get_policy as ref_get_policy
from shockwave_tpu.policies import speculation as ref_spec
from shockwave_tpu.policies.shockwave import (
    ShockwavePlanner as RefPlanner,
)
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.generate import smoke_trace_jobs
from shockwave_tpu_torch.data.profiles import synthesize_profiles
from shockwave_tpu_torch.ops._build import KernelError
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.policies import speculation as spec_mod
from shockwave_tpu_torch.policies.shockwave import ShockwavePlanner
from shockwave_tpu_torch.policies.speculation import (
    SpecOutcome,
    clone_planner,
    diff_fingerprints,
    planner_fingerprint,
)
from test_pipelining import make_profile


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_smoke_trace_is_the_reference():
    for gap in (0.0, 60.0):
        ours, ref = smoke_trace_jobs(6, 2, gap), ref_smoke(6, 2, gap)
        assert ours[1] == ref[1]
        assert [dataclasses.asdict(j) for j in ours[0]] == [
            {f: getattr(j, f) for f in dataclasses.asdict(ours[0][0])}
            for j in ref[0]]


def sim_config(speculate, cells=None):
    config = {"num_gpus": 4, "time_per_iteration": 120, "future_rounds": 6,
              "lambda": 2.0, "k": 1e-3, "speculate": speculate}
    if cells:
        config["cells"] = cells
    return config


def record_rounds(sched):
    """Wrap the scheduler's round dispatch to log every round's
    assignment (the port keeps no round log)."""
    rounds = []
    dispatch = sched._schedule_jobs_on_workers

    def logged():
        assignments = dispatch()
        rounds.append({str(j): len(w) for j, w in assignments.items()})
        return assignments

    sched._schedule_jobs_on_workers = logged
    return rounds


def run_sim(package, speculate, arrival_gap=0.0,
            policy="shockwave_tpu_pdhg", cells=None):
    """tests/test_pipelining.py::run_sim in ``package``."""
    config = sim_config(speculate, cells)
    if package == "port":
        jobs, arrivals = smoke_trace_jobs(6, 2, arrival_gap)
        oracle = generate_oracle()
        sched = Scheduler(get_policy(policy, device="cpu"),
                          throughputs=oracle, seed=0, time_per_iteration=120,
                          profiles=synthesize_profiles(jobs, oracle),
                          shockwave_config=config)
    else:
        jobs, arrivals = ref_smoke(6, 2, arrival_gap)
        oracle = ref_oracle()
        sched = RefScheduler(get_policy_ref(policy), throughputs=oracle,
                             seed=0, time_per_iteration=120,
                             profiles=ref_profiles(jobs, oracle),
                             shockwave_config=config)
    rounds = record_rounds(sched)
    makespan = sched.simulate({"v100": 4}, arrivals, jobs)
    return sched, makespan, rounds


def get_policy_ref(policy):
    return ref_get_policy(policy)


def run_both(speculate, **kw):
    """The port's run, after holding its rounds, makespan, completion
    times, reconcile counts and solve records to the JAX package's."""
    ref, ref_mk, ref_rounds = run_sim("jax", speculate, **kw)
    ours, mk, rounds = run_sim("port", speculate, **kw)
    assert rounds == ref_rounds
    assert mk == ref_mk
    assert {j.integer: t for j, t in ours._job_completion_times.items()} == {
        j.integer: t for j, t in ref._job_completion_times.items()}
    assert ours._shockwave.spec_stats == ref._shockwave.spec_stats
    keys = ("backend", "ok", "round", "num_jobs", "repair")
    assert [{k: r.get(k) for k in keys}
            for r in ours._shockwave.solve_records] == [
        {k: r.get(k) for k in keys} for r in ref._shockwave.solve_records]
    return ours, mk, rounds


class TestNoChurnBitIdentity:
    @pytest.mark.parametrize("policy", ["shockwave_tpu_pdhg",
                                        "shockwave_tpu"])
    def test_flat_planner_identical_to_serial(self, policy):
        serial, mk0, rounds0 = run_both(False, policy=policy)
        pipelined, mk1, rounds1 = run_both(True, policy=policy)
        assert mk1 == mk0
        assert rounds1 == rounds0
        stats = pipelined._shockwave.spec_stats
        assert stats["hit"] >= 1
        assert stats["repair"] == 0 and stats["miss"] == 0
        assert len(pipelined._shockwave.solve_records) == len(
            serial._shockwave.solve_records)

    def test_cells_identical_to_serial(self):
        _, mk0, rounds0 = run_both(False, policy="shockwave_tpu_cells",
                                   cells=2)
        pipelined, mk1, rounds1 = run_both(
            True, policy="shockwave_tpu_cells", cells=2)
        assert mk1 == mk0
        assert rounds1 == rounds0
        assert pipelined._shockwave.spec_stats["hit"] >= 1


class TestReconcileUnderChurn:
    @pytest.mark.parametrize("policy,cells", [
        ("shockwave_tpu_pdhg", None), ("shockwave_tpu", None),
        ("shockwave_tpu_cells", 2)])
    def test_arrivals_repair_or_miss_and_lose_nothing(self, policy, cells):
        serial, _, _ = run_both(False, arrival_gap=60.0, policy=policy,
                                cells=cells)
        pipelined, _, _ = run_both(True, arrival_gap=60.0, policy=policy,
                                   cells=cells)
        stats = pipelined._shockwave.spec_stats
        assert stats["repair"] + stats["miss"] >= 1
        completed = sum(1 for t in pipelined._job_completion_times.values()
                        if t is not None)
        assert completed == 6
        assert len(pipelined._shockwave.solve_records) <= len(
            serial._shockwave.solve_records)

    def test_repair_solves_are_tagged(self):
        """Under shockwave_tpu (its configured backend the host greedy or
        the level solve) a repair solve goes through pdhg: kernel A on a
        card."""
        pipelined, _, _ = run_both(True, arrival_gap=60.0,
                                   policy="shockwave_tpu")
        stats = pipelined._shockwave.spec_stats
        repairs = [r for r in pipelined._shockwave.solve_records
                   if r.get("repair")]
        assert len(repairs) == stats["repair"] >= 1
        assert all(r["backend"] == "pdhg" for r in repairs)


def make_planner(package="port", num_jobs=3, num_gpus=4, **config):
    cfg = {"num_gpus": num_gpus, "time_per_iteration": 120.0,
           "future_rounds": 4, **config}
    planner = (ShockwavePlanner(cfg, backend="pdhg", device="cpu")
               if package == "port" else RefPlanner(cfg, backend="pdhg"))
    for i in range(num_jobs):
        planner.add_job(f"job{i}", make_profile([32] * 6, [200.0] * 6),
                        120.0, 1)
    return planner


def both_planners(**config):
    return make_planner("port", **config), make_planner("jax", **config)


def fingerprints(port, ref):
    ours = planner_fingerprint(port)
    assert ours == ref_spec.planner_fingerprint(ref)
    return ours


class TestFingerprints:
    def test_matching_states_diff_empty(self):
        port, ref = both_planners()
        fp = fingerprints(port, ref)
        assert diff_fingerprints(fp, fingerprints(port, ref), 0) == {}

    def test_arrival_departure_drift_capacity(self):
        port, ref = both_planners()
        fp = fingerprints(port, ref)

        def diff(port, ref, tolerance=0):
            live = fingerprints(port, ref)
            ours = diff_fingerprints(fp, live, tolerance)
            assert ours == ref_spec.diff_fingerprints(fp, live, tolerance)
            return ours

        for planner in (port, ref):
            planner.add_job("late", make_profile([32] * 6, [200.0] * 6),
                            120.0, 1)
        assert any("arrived" in r for rs in diff(port, ref).values()
                   for r in rs)
        for planner in (port, ref):
            planner.remove_job("late")
            planner.remove_job("job0")
        assert any("departed" in r for rs in diff(port, ref).values()
                   for r in rs)
        port, ref = both_planners()
        for planner in (port, ref):
            planner.set_progress("job1", 2)
        assert any("progress" in r for rs in diff(port, ref).values()
                   for r in rs)
        assert diff(port, ref, 2) == {}
        port, ref = both_planners()
        for planner in (port, ref):
            planner.set_capacity(2)
        assert any("capacity" in r for rs in diff(port, ref).values()
                   for r in rs)

    def test_completed_jobs_leave_the_fingerprint(self):
        port, ref = both_planners()
        for planner in (port, ref):
            planner.set_progress("job0", 6)
        assert "job0" not in fingerprints(port, ref)["progress"]


def outcome(planner, cls=SpecOutcome, **kw):
    return cls(
        target_round=kw.pop("target_round", planner.round_index + 1),
        progress=kw.pop("progress", {}),
        throughputs=kw.pop("throughputs", []),
        completions=kw.pop("completions", []),
        capacity=kw.pop("capacity", planner.num_gpus),
    )


def advance(planner):
    planner.current_round_schedule()
    planner.increment_round()


def drive(steps, **config):
    """Run ``steps(planner, outcome_cls)`` on a port planner and on a JAX
    planner; the two must end with equal counts, solve backends and repair
    tags, and equal plan caches. Returns the port's planner."""
    port, ref = both_planners(**config)
    steps(port, SpecOutcome)
    steps(ref, ref_spec.SpecOutcome)
    assert port.spec_stats == ref.spec_stats
    keys = ("backend", "ok", "round", "num_jobs", "repair")
    assert [{k: r.get(k) for k in keys} for r in port.solve_records] == [
        {k: r.get(k) for k in keys} for r in ref.solve_records]
    assert dict(port.schedules) == dict(ref.schedules)
    return port


class TestReconcileStateMachine:
    def test_hit_installs_without_a_boundary_solve(self):
        def steps(planner, cls):
            advance(planner)
            spec = planner.speculate_next_round(outcome(planner, cls))
            assert spec.ok
            planner._solves_before = len(planner.solve_records)
            planner.increment_round()
            planner.current_round_schedule()

        port = drive(steps)
        assert port.spec_stats["hit"] == 1
        assert len(port.solve_records) == port._solves_before

    def test_round_skew_is_a_miss(self):
        def steps(planner, cls):
            advance(planner)
            planner.speculate_next_round(outcome(planner, cls))
            planner.increment_round()
            planner.increment_round()
            planner.current_round_schedule()

        assert drive(steps).spec_stats["miss"] == 1

    def test_join_timeout_is_a_miss(self):
        def steps(planner, cls):
            advance(planner)
            spec = planner.speculate_next_round(outcome(planner, cls))
            spec.done.clear()  # a background solve still running
            planner._speculation = spec
            planner.increment_round()
            planner.current_round_schedule()

        assert drive(steps, speculate_join_s=0.0).spec_stats["miss"] == 1

    def test_churn_on_cache_valid_boundary_discards(self):
        def steps(planner, cls):
            advance(planner)
            planner.speculate_next_round(outcome(planner, cls))
            planner.add_job("late", make_profile([32] * 6, [200.0] * 6),
                            120.0, 1)
            planner.increment_round()
            planner._solves_before = len(planner.solve_records)
            planner.current_round_schedule()

        port = drive(steps)
        assert port.spec_stats["miss"] == 1
        assert len(port.solve_records) == port._solves_before

    def test_churn_on_stale_boundary_repairs_through_pdhg(self):
        def steps(planner, cls):
            advance(planner)
            planner.speculate_next_round(outcome(planner, cls))
            planner.add_job("late", make_profile([32] * 6, [200.0] * 6),
                            120.0, 1)
            planner.set_recompute_flag()
            planner.increment_round()
            planner.current_round_schedule()

        port = drive(steps)
        assert port.spec_stats["repair"] == 1
        assert port.solve_records[-1].get("repair") is True
        assert port.solve_records[-1]["backend"] == "pdhg"

    def test_repair_under_the_ladder_leads_with_pdhg(self):
        """With a planning deadline the solve runs down the degradation
        ladder; a repair puts the pdhg rung first, ahead of the
        configured ``tpu`` backend, as in the JAX package."""
        def planner_of(package):
            cfg = {"num_gpus": 4, "time_per_iteration": 120.0,
                   "future_rounds": 4, "plan_deadline_s": 60.0}
            planner = (ShockwavePlanner(cfg, backend="tpu", device="cpu")
                       if package == "port" else RefPlanner(cfg, "tpu"))
            for i in range(3):
                planner.add_job(f"job{i}", make_profile([32] * 6, [200.0] * 6),
                                120.0, 1)
            return planner

        records = []
        for package, cls in (("port", SpecOutcome),
                             ("jax", ref_spec.SpecOutcome)):
            planner = planner_of(package)
            advance(planner)
            planner.speculate_next_round(outcome(planner, cls))
            planner.add_job("late", make_profile([32] * 6, [200.0] * 6),
                            120.0, 1)
            planner.set_recompute_flag()
            planner.increment_round()
            planner.current_round_schedule()
            assert planner.spec_stats["repair"] == 1
            records.append({k: planner.solve_records[-1].get(k)
                            for k in ("backend", "repair", "degraded")})
        assert records[0] == records[1] == {
            "backend": "pdhg", "repair": True, "degraded": None}

    def test_background_speculation_reconciles_as_inline(self):
        """``background=True`` runs the clone's solve on a daemon thread;
        ``reconcile_at_boundary`` (the physical round loop's entry) joins
        it, installs the plan an inline speculation installs and records
        the exposed time; nothing is left pending for the boundary."""
        inline, threaded = make_planner(), make_planner()
        for planner, background in ((inline, False), (threaded, True)):
            advance(planner)
            planner.set_recompute_flag()
            spec = planner.speculate_next_round(
                outcome(planner, progress={"job0": 1}), background=background)
            assert spec.done.wait(30.0)
            planner.set_progress("job0", 1)
            planner.increment_round()
            planner.recompute_flag = False
            exposed = len(planner.exposed_plan_times)
            assert planner.reconcile_at_boundary() == "hit"
            assert len(planner.exposed_plan_times) == exposed + 1
            assert planner.reconcile_at_boundary() is None
            planner.current_round_schedule()
        assert spec.solved
        assert threaded.spec_stats == inline.spec_stats == {
            "hit": 1, "repair": 0, "miss": 0}
        assert dict(threaded.schedules) == dict(inline.schedules)

    def test_speculative_clone_shares_no_mutable_state(self):
        planner = make_planner()
        advance(planner)
        clone = clone_planner(planner)
        clone.record_round_throughput("job0", 1, 5.0, 32)
        clone.set_progress("job0", 3)
        clone.job_metadata["job0"].dirichlet[32] = 999.0
        assert planner.job_metadata["job0"].throughput_schedule == {}
        assert planner.job_metadata["job0"].completed_epochs == 0
        assert planner.job_metadata["job0"].dirichlet[32] != 999.0
        assert clone.device == planner.device
        assert_no_shared_mutables(planner, clone)

    def test_cells_clone_shares_no_mutable_state(self):
        from shockwave_tpu_torch.cells.planner import CellPlanner

        planner = CellPlanner({"num_gpus": 4, "time_per_iteration": 120.0,
                               "future_rounds": 4, "cells": 2},
                              backend="pdhg", device="cpu")
        for i in range(4):
            planner.add_job(f"job{i}", make_profile([32] * 6, [200.0] * 6),
                            120.0, 1)
        advance(planner)
        clone = clone_planner(planner)
        assert str(clone.device) == "cpu"
        assert_no_shared_mutables(planner, clone)


def walk(obj, path, seen, found):
    """Every mutable object reachable from ``obj`` (containers, numpy
    arrays, tensors, objects with a ``__dict__``): id -> (object, the
    attribute path it was first reached by)."""
    if id(obj) in seen or isinstance(
            obj, (str, bytes, int, float, bool, type(None), torch.device,
                  torch.dtype, np.generic)):
        return
    seen.add(id(obj))
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        found[id(obj)] = (obj, path)
    elif isinstance(obj, dict):
        found[id(obj)] = (obj, path)
        for k, v in obj.items():
            walk(v, f"{path}[{k!r}]", seen, found)
    elif isinstance(obj, (list, set)):
        found[id(obj)] = (obj, path)
        for i, v in enumerate(obj):
            walk(v, f"{path}[{i}]", seen, found)
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            walk(v, f"{path}[{i}]", seen, found)
    elif hasattr(obj, "__dict__"):
        found[id(obj)] = (obj, path)
        for k, v in vars(obj).items():
            walk(v, f"{path}.{k}", seen, found)


# What a planner and its clone share, as in the JAX package
# (policies/speculation.py, clone_planner): each JobMetadata's profile
# arrays and lists and its duration cache, which no code of the port
# writes in place (each is only ever rebound).
READ_ONLY = ("epoch_batch_sizes", "epoch_mem_reqs", "epoch_gpu_reqs",
             "epoch_durations", "estimated_epoch_durations", "regimes",
             "_bs_durations_cache")


def assert_no_shared_mutables(planner, clone):
    """The planner and its clone reach no common mutable object but the
    profiles' read-only arrays, and neither holds a tensor: the port's
    planners keep none between solves (kernel A's packs are built per
    launch, ``solver/eg_pdhg.py::solve_lanes``)."""
    live, cloned = {}, {}
    walk(planner, "planner", set(), live)
    walk(clone, "clone", set(), cloned)
    tensors = [p for o, p in list(live.values()) + list(cloned.values())
               if isinstance(o, torch.Tensor)]
    assert tensors == []
    for i in live.keys() & cloned.keys():
        _, path = live[i]
        assert path.rsplit(".", 1)[-1] in READ_ONLY, path


class TestDeviceFaults:
    """The port's divergence: a broken kernel or card is raised."""

    def test_kernel_error_in_a_speculative_solve_raises_at_reconcile(
            self, monkeypatch):
        planner = make_planner()
        advance(planner)
        planner.set_recompute_flag()  # the clone's boundary will solve

        def broken(*args, **kwargs):
            raise KernelError("planted: kernel A did not launch")

        monkeypatch.setattr(ShockwavePlanner, "_solve_backend", broken)
        spec = planner.speculate_next_round(outcome(planner))
        assert isinstance(spec.error, KernelError)
        planner.increment_round()
        with pytest.raises(KernelError, match="planted"):
            planner.current_round_schedule()
        assert planner.spec_stats == {"hit": 0, "repair": 0, "miss": 0}

    def test_other_error_in_a_speculative_solve_is_a_miss(self, monkeypatch):
        planner = make_planner()
        advance(planner)
        planner.set_recompute_flag()
        solve = ShockwavePlanner._solve_backend

        def broken(self, *args, **kwargs):
            if getattr(self, "_speculative", False):
                raise ValueError("planted solver error")
            return solve(self, *args, **kwargs)

        monkeypatch.setattr(ShockwavePlanner, "_solve_backend", broken)
        planner.speculate_next_round(outcome(planner))
        planner.increment_round()
        planner.current_round_schedule()
        assert planner.spec_stats["miss"] == 1

    def arm_repair(self, backend):
        planner = ShockwavePlanner(
            {"num_gpus": 4, "time_per_iteration": 120.0, "future_rounds": 4},
            backend=backend, device="cpu")
        for i in range(3):
            planner.add_job(f"job{i}", make_profile([32] * 6, [200.0] * 6),
                            120.0, 1)
        advance(planner)
        planner.speculate_next_round(outcome(planner))
        planner.add_job("late", make_profile([32] * 6, [200.0] * 6), 120.0, 1)
        planner.set_recompute_flag()
        planner.increment_round()
        return planner

    def test_kernel_error_in_a_repair_solve_is_not_fallen_back_from(
            self, monkeypatch):
        planner = self.arm_repair("tpu")
        solve = ShockwavePlanner._solve_backend
        used = []

        def broken(self, backend, *args, **kwargs):
            used.append(backend)
            if backend == "pdhg":
                raise KernelError("planted: kernel A did not launch")
            return solve(self, backend, *args, **kwargs)

        monkeypatch.setattr(ShockwavePlanner, "_solve_backend", broken)
        with pytest.raises(KernelError, match="planted"):
            planner.current_round_schedule()
        assert used == ["pdhg"]
        assert planner.spec_stats["repair"] == 1
        assert planner.solve_records[-1]["ok"] is False

    def test_other_error_in_a_repair_solve_falls_back(self, monkeypatch):
        planner = self.arm_repair("tpu")
        solve = ShockwavePlanner._solve_backend
        used = []

        def broken(self, backend, *args, **kwargs):
            used.append(backend)
            if backend == "pdhg":
                raise ValueError("planted solver error")
            return solve(self, backend, *args, **kwargs)

        monkeypatch.setattr(ShockwavePlanner, "_solve_backend", broken)
        planner.current_round_schedule()
        assert used == ["pdhg", "tpu"]
        assert planner.solve_records[-1]["ok"] is True
        assert planner.solve_records[-1]["repair"] is True


class TestDirichletChangepoint:
    """tests/test_pipelining.py::TestDirichletChangepoint on the port's
    predictor, each remaining-runtime estimate equal to the JAX
    package's."""

    def fixture(self, metadata):
        md = metadata.JobMetadata(
            make_profile([32] * 30 + [64] * 30, [100.0] * 30 + [50.0] * 30),
            round_duration=60.0)
        for r in (1, 2, 3):
            md.record_round_throughput(r, 5.0, 32)
        for r in (4, 5, 6):
            md.record_round_throughput(r, 9.0, 64)
        return md

    def both(self):
        import shockwave_tpu.predictor.metadata as ref_meta

        import shockwave_tpu_torch.predictor.metadata as meta

        return self.fixture(meta), self.fixture(ref_meta)

    def test_static_job_posterior_unchanged(self):
        from shockwave_tpu_torch.predictor.metadata import JobMetadata

        def md():
            m = JobMetadata(make_profile([32, 32, 64, 64], [100, 100, 50, 50]),
                            round_duration=60)
            m.complete(1)
            m.record_round_throughput(1, 5.0, 32)
            m.record_round_throughput(2, 5.0, 32)
            return m

        assert md().remaining_runtime() == md().remaining_runtime()

    def test_measured_switch_reanchors_remaining_runtime(self):
        md, ref = self.both()
        md.complete(20)
        ref.complete(20)
        assert md.remaining_runtime() == ref.remaining_runtime()
        durations = md.bs_epoch_durations()
        truth = (md.total_epochs - (md.completed_epochs + 1)) * durations[64]
        ape = abs(md.remaining_runtime() - truth) / truth
        assert ape < 0.10

    def test_changepoint_is_pure_function_of_schedule(self):
        from shockwave_tpu_torch.predictor.metadata import JobMetadata

        md, _ = self.both()
        md.complete(20)
        predicted = md.remaining_runtime()
        assert JobMetadata.from_state(md.state_dict()).remaining_runtime() == (
            predicted)


def test_clone_runs_on_the_planners_device():
    planner = make_planner()
    assert spec_mod.clone_planner(planner).device == torch.device("cpu")
