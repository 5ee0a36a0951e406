"""The port's simulation path against the JAX package's, on the CPU.

The golden metrics of the committed 12-job trace (tests/test_golden.py),
and the 220-job trace on 256 GPUs (Figure 9's largest cluster): every
planning problem the JAX package's run solves gives equal counts in the
port, and the port's run of the same configuration gives the same
makespan, average JCT and worst finish-time fairness within 1e-3.

The first-order backends on the golden trace: every problem the JAX
package's planner solves under ``shockwave_tpu_pdhg`` and
``shockwave_tpu_relaxed``, solved by the port's plain versions of kernels
A and B within the limits of two summation orders (tests/test_pdhg.py:
377-398), and the whole run's metrics within 1e-3; and the degradation
ladder (tests/test_pdhg.py:286-375).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_golden
from test_preemption_aware import MEASURED_OVERHEADS
from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
from shockwave_tpu.data import load_or_synthesize_profiles, parse_trace
from shockwave_tpu.data.default_oracle import generate_oracle
from shockwave_tpu.policies import get_policy as ref_get_policy
from shockwave_tpu.solver import eg_jax
from shockwave_tpu.solver import eg_pdhg as ref_pdhg
from shockwave_tpu_torch import simulate
from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.ops import _build
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.policies.shockwave import ShockwavePlanner
from shockwave_tpu_torch.solver import eg_level, eg_pdhg, eg_relaxed
from shockwave_tpu_torch.tools import bench_sim
from test_torch_pdhg import assert_matches, rounded_objective
from test_torch_solver import port_problem

TRACE_220 = bench_sim.TRACES / "generated_220_dynamic.trace"
ORACLE = bench_sim.ROOT / "results" / "measured_oracle_tpu.json"
OVERHEADS = json.dumps(MEASURED_OVERHEADS)
# The CLI options of the preemption-aware path and of the run's set-up,
# each run on the 12-job trace by both packages' simulate CLIs.
CLI_CASES = {
    "measured_overheads": [
        "-p", "shockwave_tpu", "-c", "v100=2", "--time_per_iteration", "60",
        "--preemption_overheads", OVERHEADS],
    "autosized_round": [
        "-p", "shockwave_tpu", "-c", "v100=2", "--time_per_iteration", "60",
        "--preemption_overheads", OVERHEADS,
        "--round_overhead_fraction", "0.25"],
    "level_with_overheads": [
        "-p", "shockwave_tpu_level", "-c", "v100=4",
        "--time_per_iteration", "60", "--preemption_overheads", OVERHEADS],
    "window_config_oracle": [
        "-p", "shockwave_tpu", "-c", "tpu_v5e=4", "--time_per_iteration",
        "120", "--throughputs_file", str(ORACLE), "--config", "CONFIG",
        "-s", "2", "-e", "9"],
}
CLI_METRICS = ("makespan", "avg_jct", "worst_ftf", "unfair_fraction",
               "num_preemptions", "effective_round_s")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_golden_constants_are_the_reference_tests():
    for policy, expected in bench_sim.GOLDEN.items():
        assert expected == test_golden.GOLDEN[policy]


@pytest.mark.parametrize("policy", sorted(bench_sim.GOLDEN))
def test_golden_metrics_on_the_cpu(policy):
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, "cpu")
    assert bench_sim.check_run(result, bench_sim.GOLDEN[policy]) == []
    if policy == "shockwave_tpu_level":
        assert result["solves"] == {"level": 16}
        assert result["device_solves"] == {"cpu": 16}


def _ref_run(trace, policy, num_gpus, plans=None):
    """The JAX package's run; ``plans``, where given, receives (round,
    schedule) of every solve."""
    jobs, arrivals = parse_trace(str(trace))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(str(trace), jobs, oracle,
                                           cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = {"num_gpus": num_gpus, "time_per_iteration": 120,
              "future_rounds": 20, "lambda": 5.0, "k": 10.0}
    sched = RefScheduler(ref_get_policy(policy, seed=0), throughputs=oracle,
                         seed=0, time_per_iteration=120, profiles=profiles,
                         shockwave_config=config)
    if plans is not None:
        planner = sched._shockwave
        solve = planner._solve

        def capturing(problem):
            Y, used = solve(problem)
            plans.append((planner.round_index, Y.copy(), problem))
            return Y, used

        planner._solve = capturing
    makespan = sched.simulate({"v100": num_gpus}, arrivals, jobs)
    ftf, _ = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), rounds=sched._num_completed_rounds)


def test_every_problem_of_the_220_job_run_gives_equal_counts(monkeypatch):
    captured = []
    solve = eg_jax.solve_level_counts

    def capture(problem):
        counts, obj = solve(problem)
        captured.append((problem, counts, obj))
        return counts, obj

    monkeypatch.setattr(eg_jax, "solve_level_counts", capture)
    reference = _ref_run(TRACE_220, "shockwave_tpu_level", 256)
    assert len(captured) > 50
    for problem, ref_counts, ref_obj in captured:
        counts, obj = eg_level.solve_level_counts(port_problem(problem),
                                                  "cpu")
        np.testing.assert_array_equal(counts, ref_counts)
        assert obj == pytest.approx(ref_obj, rel=1e-6)

    result = bench_sim.run_trace(TRACE_220, "shockwave_tpu_level", 256, "cpu")
    assert bench_sim.check_run(result, reference) == []
    assert result["solves"] == {"level": len(captured)}


def test_cli_prints_the_golden(capsys):
    result = simulate.main([
        "-t", str(bench_sim.GOLDEN_TRACE), "-p", "shockwave_native",
        "-c", "v100=8", "--time_per_iteration", "120", "--device", "cpu",
        "--no_profile_cache"])
    assert bench_sim.check_run(result, bench_sim.GOLDEN["shockwave_native"]) == []
    assert "Makespan: 12976.464 s" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [
    ["--metrics-out", "m.json"], ["--trace-out", "t.json"],
    ["--decision-log", "d.jsonl"], ["--watchdog"]])
def test_cli_telemetry_flags_are_not_ported(flag, tmp_path):
    """Each of the JAX package's telemetry flags runs in the port's CLI
    and gives what the JAX package's CLI gives on the same run (the
    golden trace under ``shockwave_tpu``): the metrics dump in every
    deterministic series, the trace's events, the decision log record for
    record (wall-clock fields for presence), the watchdog's summary but
    for the wall-clock rule (tests/telemetry_reference.py)."""
    import re

    import telemetry_reference as ref

    paths = {}
    for side in ("port", "jax"):
        paths[side] = [str(tmp_path / f"{side}-{x}")
                       if x.endswith((".json", ".jsonl")) else x
                       for x in flag]
    args = ["-t", str(bench_sim.GOLDEN_TRACE), "-p", "shockwave_tpu",
            "-c", "v100=8", "--time_per_iteration", "120"]
    simulate.main(args + ["--device", "cpu", "--no_profile_cache",
                          *paths["port"]])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ref.ROOT))
    proc = subprocess.run(
        [sys.executable, "scripts/simulate.py", *args, *paths["jax"]],
        cwd=ref.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    if flag[0] == "--metrics-out":
        with open(paths["port"][1]) as f, open(paths["jax"][1]) as g:
            assert ref.metric_differences(json.load(f), json.load(g)) == []
    elif flag[0] == "--trace-out":
        assert (ref.trace_events(paths["port"][1])
                == ref.trace_events(paths["jax"][1]))
    elif flag[0] == "--decision-log":
        ours, theirs = (ref.records(p[1]) for p in paths.values())
        assert len(ours) == len(theirs) > 0
        assert ref.without_wall(ours) == ref.without_wall(theirs)
    else:
        rerun = subprocess.run(
            [sys.executable, "-m", "shockwave_tpu_torch.simulate", *args,
             "--device", "cpu", "--no_profile_cache", "--watchdog"],
            cwd=ref.ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        assert rerun.returncode == 0, rerun.stderr[-4000:]

        def rules(text):
            line = re.search(r"Scheduler health: .*", text).group(0)
            return sorted(r for r in re.findall(r"(\w+) x\d+", line)
                          if r != "solver_time"), [
                m for m in re.findall(r"(\w+ x\d+)", line)
                if not m.startswith("solver_time")]

        assert rules(rerun.stdout) == rules(proc.stdout)
        assert rules(proc.stdout)[0]


def test_cli_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        simulate.main(["-t", str(bench_sim.GOLDEN_TRACE), "-p",
                       "shockwave_native", "--device", "cuda"])


def test_the_sharded_policy_runs_the_golden_trace_as_level():
    """``shockwave_tpu_sharded`` (a one-place solve mesh on the CPU)
    gives the golden metrics of ``shockwave_tpu_level``, every solve
    through the sharded backend."""
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE,
                                 "shockwave_tpu_sharded", 8, "cpu")
    assert bench_sim.check_run(
        result, bench_sim.GOLDEN["shockwave_tpu_level"]) == []
    assert set(result["solves"]) == {"sharded"}


# Speculation and hetero_pools are ported (tests/test_torch_speculation.py,
# tests/test_torch_hetero.py), and so is online throughput estimation
# (tests/test_torch_estimator.py), which a Shockwave policy never turns
# on, in either package. Physical mode is ported
# (tests/test_torch_physical.py), and so is its HA plane
# (tests/test_torch_ha.py, tests/test_torch_failover.py); so is the cell
# mesh, which with one device visible takes no mesh, in the simulator or
# in physical mode, as the JAX package with one device.
@pytest.mark.parametrize("config, kwargs", [
    ({"cells": 4, "cell_mesh": True}, {}),
    ({"cells": 4, "cell_mesh": True}, {"physical": True}),
    ({"cells": 2, "cell_mesh": True}, {}),
    ({"cells": 2, "cell_mesh": True},
     {"physical": True, "profiling_percentage": 0.5}),
])
def test_cell_mesh_options_build_a_planner(config, kwargs):
    from shockwave_tpu_torch.cells.planner import CellPlanner
    from shockwave_tpu_torch.core.physical import PhysicalScheduler

    from shockwave_tpu_torch.runtime.testing import free_port

    shockwave_config = {"num_gpus": 8, "time_per_iteration": 120, **config}
    kwargs = dict(kwargs)
    physical = kwargs.pop("physical", False)
    if physical:
        kwargs["port"] = free_port()
    cls = PhysicalScheduler if physical else Scheduler
    sched = cls(get_policy("shockwave_tpu_level", device="cpu"),
                throughputs=generate_oracle(),
                shockwave_config=shockwave_config, **kwargs)
    try:
        planner = sched._shockwave
        assert isinstance(planner, CellPlanner) and planner.use_mesh
        assert len(planner.cells) == config["cells"]
        assert planner._mesh() is None
    finally:
        if physical:
            sched.shutdown()


def test_sharded_scale_with_several_cards_shards(monkeypatch):
    """At the dispatch threshold with more than one device visible the
    tpu dispatch shards the solve over them."""
    from shockwave_tpu_torch.parallel import mesh
    from shockwave_tpu_torch.policies import shockwave

    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device: [torch.device("cpu")] * 2)
    monkeypatch.setattr(shockwave, "SHARDED_DISPATCH_MIN_JOBS", 2)
    planner = ShockwavePlanner({"num_gpus": 8, "time_per_iteration": 120},
                               backend="tpu", device="cpu")
    problem = bench_sim.seeded_problem(4, num_gpus=8)
    Y, used = planner._solve_backend("tpu", problem)
    assert used == "sharded" and planner._attempted_backend == "sharded"
    problem.audit_schedule(np.asarray(Y))


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_options_match_the_reference_cli(case, tmp_path, monkeypatch):
    """Measured relaunch overheads (the switching-cost bonus and the
    stickiness pass, through the native greedy and through the level
    solve), round auto-sizing, a window of jobs, a JSON config and an
    oracle file: the port's CLI gives the JAX package's scripts/simulate.py
    metrics within 1e-3, and the same preemptions."""
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"future_rounds": 10, "lambda": 2.0,
                                  "k": 1e-3}))
    args = ["-t", str(bench_sim.GOLDEN_TRACE), "--no_profile_cache",
            *[str(config) if a == "CONFIG" else a for a in CLI_CASES[case]]]
    ref_out = tmp_path / "reference.pkl"
    subprocess.run(
        [sys.executable, "scripts/simulate.py", *args, "--output_pickle",
         str(ref_out)], cwd=bench_sim.ROOT, check=True, capture_output=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    with open(ref_out, "rb") as f:
        reference = pickle.load(f)

    bonus_solves = []
    solve = eg_level.solve_level_counts

    def record(problem, device):
        bonus_solves.append(bool(np.any(problem.switch_bonus() > 0)))
        return solve(problem, device)

    monkeypatch.setattr(eg_level, "solve_level_counts", record)
    result = simulate.main([*args, "--device", "cpu"])
    for key in CLI_METRICS:
        assert abs(result[key] - reference[key]) <= bench_sim.TOLERANCE, key
    assert result["num_preemptions"] == reference["num_preemptions"]
    if case == "level_with_overheads":
        assert any(bonus_solves) and result["solves"] == {
            "level": len(bonus_solves)}
    if case == "autosized_round":
        assert result["effective_round_s"] > 60


# -- the first-order backends on the golden trace -------------------------

# The planner's objective gap where the port's plan of a round differs from
# the JAX package's: none on the golden trace (measured 0.0 under both
# backends: every plan equal); the metrics are held to TOLERANCE.
FIRST_ORDER = ("shockwave_tpu_pdhg", "shockwave_tpu_relaxed")


def test_every_pdhg_problem_of_the_golden_run_matches(monkeypatch):
    """Each PDHG solve the JAX planner makes on the golden trace (problem,
    warm start and tolerance as it passed them) against the port's plain
    version of kernel A, to the limits of two summation orders."""
    captured = []
    solve = ref_pdhg.solve_pdhg_relaxed

    def capture(problem, s0=None, **kwargs):
        out = solve(problem, s0=s0, **kwargs)
        captured.append((problem, s0, kwargs, out))
        return out

    monkeypatch.setattr(ref_pdhg, "solve_pdhg_relaxed", capture)
    _ref_run(bench_sim.GOLDEN_TRACE, "shockwave_tpu_pdhg", 8)
    assert len(captured) >= 10
    assert sum(s0 is not None for _, s0, _, _ in captured) >= 5
    for problem, s0, kwargs, (ref_s, ref_obj, ref_info) in captured:
        s, obj, info = eg_pdhg.solve_pdhg_relaxed(
            port_problem(problem), s0=s0, device="cpu", **kwargs)
        assert_matches(problem, s, obj, ref_s, ref_obj)


def _relaxed_objective(problem, s):
    """The reference's relaxed objective (eg_jax._objective, hard max) of
    ``s`` on the problem's padded float32 arrays."""
    import jax.numpy as jnp

    slots = eg_jax.num_slots_for(problem.num_jobs)
    pk = eg_jax.pad_problem(problem, slots)
    x = np.zeros(slots, np.float32)
    x[:problem.num_jobs] = s
    return float(eg_jax._objective(
        jnp.asarray(x), pk["active"], pk["priorities"], pk["completed"],
        pk["total"], jnp.maximum(pk["epoch_dur"], eg_jax._EPS),
        pk["remaining"], jnp.sum(pk["active"]),
        float(problem.round_duration), int(problem.future_rounds),
        float(problem.regularizer), switch_bonus=pk.get("switch_bonus")))


def _assert_feasible(problem, s):
    """``s`` lies in the solve's feasible set: 0 <= s <= R for a job that
    fits the cluster (0 for one that does not), and w . s <= budget."""
    s = np.asarray(s, np.float64)
    nworkers = np.asarray(problem.nworkers, np.float64)
    R = float(problem.future_rounds)
    s_max = np.where(nworkers <= problem.num_gpus, R, 0.0)
    assert np.all(s >= 0.0) and np.all(s <= s_max * (1 + 1e-6))
    assert nworkers @ s <= problem.num_gpus * R * (1 + 1e-6)


def test_every_relaxed_problem_of_the_golden_run_matches(monkeypatch):
    """Each relaxed solve the JAX planner makes on the golden trace (PGD,
    then the PDHG polish) against the port's: the relaxed objective of
    each ``s`` (the reference's) and the rounded objective within their
    limits, and ``s`` within 5e-3 except where the two objectives are
    equal to the last bit, i.e. the float32 objective cannot tell the
    points apart. That is one of the 15 (8 jobs on 8 GPUs, its objective
    ~6.3e4, one float32 step 0.004): job 0 sits past its finish cap at
    6.64 and 8.14 rounds, where its utility and lateness are flat, and the
    polish's iterates wander there; the plans the planner makes of both
    are equal (test_first_order_golden_run_matches_the_reference). Such a
    pair is held to the feasible set instead (``_assert_feasible``)."""
    captured = []
    solve = eg_jax.solve_eg_jax

    def capture(problem, **kwargs):
        s = solve(problem, **kwargs)
        captured.append((problem, kwargs, s))
        return s

    monkeypatch.setattr(eg_jax, "solve_eg_jax", capture)
    _ref_run(bench_sim.GOLDEN_TRACE, "shockwave_tpu_relaxed", 8)
    assert len(captured) >= 10
    flat = 0
    for problem, kwargs, ref_s in captured:
        s = eg_relaxed.solve_eg_relaxed(port_problem(problem), device="cpu",
                                        **kwargs)
        obj = _relaxed_objective(problem, s)
        ref_obj = _relaxed_objective(problem, ref_s)
        if obj == ref_obj and not np.allclose(s, ref_s, rtol=5e-3,
                                              atol=5e-3):
            flat += 1
            _assert_feasible(problem, s)
            _assert_feasible(problem, ref_s)
            o = rounded_objective(problem, s)
            ref_o = rounded_objective(problem, ref_s)
            assert abs(o - ref_o) <= 2e-3 * (1.0 + abs(ref_o))
            continue
        assert_matches(problem, s, obj, ref_s, ref_obj)
    assert flat <= 1


@pytest.mark.parametrize("policy", FIRST_ORDER)
def test_first_order_golden_run_matches_the_reference(policy):
    """The whole golden run under the backend: metrics within
    ``bench_sim.TOLERANCE`` of the JAX package's run. A plan that differs
    is named by its round with its objective gap."""
    ref_plans, plans = [], []
    reference = _ref_run(bench_sim.GOLDEN_TRACE, policy, 8, plans=ref_plans)
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, "cpu",
                                 plans=plans)
    backend = policy.rsplit("_", 1)[1]
    assert result["solves"] == {backend: len(ref_plans)}
    assert result["launches"] == {"eg_pdhg": 0, "eg_relaxed": 0}
    differ = [
        (r, problem.objective_value(Y) - problem.objective_value(ref_Y))
        for (r, ref_Y, problem), (r2, Y) in zip(ref_plans, plans)
        if r != r2 or not np.array_equal(Y, ref_Y)]
    detail = (f"first differing plan at round {differ[0][0]}, objective "
              f"gap {differ[0][1]:.6g}" if differ else "every plan equal")
    assert bench_sim.check_run(result, reference) == [], detail


# -- the degradation ladder (tests/test_pdhg.py:286-375) ------------------

PROFILE = {
    "num_epochs": 4,
    "num_samples_per_epoch": 64,
    "scale_factor": 1,
    "bs_every_epoch": [32] * 4,
    "duration_every_epoch": [120.0] * 4,
}


@pytest.fixture
def no_faults():
    faults.reset()
    yield
    faults.reset()


def _tiny_planner(backend, plan_deadline_s=None, device="cpu"):
    config = {"num_gpus": 2, "time_per_iteration": 60.0, "future_rounds": 4,
              "lambda": 2.0, "k": 1e-3}
    if plan_deadline_s is not None:
        config["plan_deadline_s"] = plan_deadline_s
    planner = ShockwavePlanner(config, backend=backend, device=device)
    for j in range(3):
        planner.add_job(j, dict(PROFILE), 60.0, 1)
    return planner


def test_pdhg_backend_plans_and_warm_starts(no_faults):
    planner = _tiny_planner("pdhg")
    assert planner.current_round_schedule()
    assert planner.solve_records[-1]["backend"] == "pdhg"
    # The cached plan seeds the next replan's solution warm start.
    s0 = planner._solution_warm_start()
    assert s0 is not None and s0.sum() > 0
    planner.set_recompute_flag()
    assert planner.current_round_schedule()
    assert planner.solve_records[-1]["backend"] == "pdhg"


def test_replay_warm_start_is_consumed_once(no_faults):
    """A replayed planner's recorded warm start is used for one solve and
    dropped; one that no longer fits the problem rows is ignored."""
    planner = _tiny_planner("pdhg")
    planner.current_round_schedule()
    planner._replay_warm_start = [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(planner._solution_warm_start(),
                                  [1.0, 2.0, 3.0])
    assert planner._replay_warm_start is None
    live = planner._solution_warm_start()
    planner._replay_warm_start = [1.0]
    np.testing.assert_array_equal(planner._solution_warm_start(), live)


def test_ladder_falls_back_to_pdhg_rung(no_faults):
    plan = faults.FaultPlan(
        seed=0, events=[faults.FaultEvent(0, "solver_timeout", round=0)])
    injector = faults.configure(plan)
    planner = _tiny_planner("tpu", plan_deadline_s=10.0)
    assert planner.current_round_schedule(), "ladder fallback produced no plan"
    record = planner.solve_records[-1]
    assert record["ok"] and record["degraded"] is True
    assert record["fallback_from"] == "tpu"
    assert record["ladder"][0]["outcome"] == "timeout_injected"
    assert record["ladder"][1] == {"backend": "pdhg", "outcome": "ok"}
    assert record["backend"] == "pdhg"
    assert injector.summary()["unrecovered"] == []


def test_broken_pdhg_cannot_take_out_relaxed_rung(no_faults, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("pdhg kernel down")

    monkeypatch.setattr(eg_pdhg, "solve_pdhg_relaxed", boom)
    monkeypatch.setattr(eg_pdhg, "solve_eg_pdhg", boom)
    monkeypatch.setattr(eg_pdhg, "polish_relaxed", boom)
    planner = _tiny_planner("pdhg", plan_deadline_s=10.0)
    assert planner.current_round_schedule()
    record = planner.solve_records[-1]
    assert record["ok"] and record["degraded"] is True
    assert record["fallback_from"] == "pdhg"
    assert record["ladder"][0] == {"backend": "pdhg",
                                   "outcome": "RuntimeError"}
    # "relaxed", not "native": the relaxed rung ran without its polish.
    assert record["backend"] == "relaxed"


def test_failed_kernel_build_raises_through_the_ladder(no_faults, monkeypatch):
    """On a card the ladder builds its kernels before the clock starts; a
    build that fails raises instead of ending in the native rung's plan."""
    def no_build(name):
        raise _build.KernelError(f"nvcc failed for csrc/{name}.cu")

    monkeypatch.setattr(_build, "library", no_build)
    planner = _tiny_planner("tpu", plan_deadline_s=10.0, device="cuda")
    with pytest.raises(_build.KernelError, match="nvcc failed"):
        planner.current_round_schedule()
    assert planner.solve_records[-1]["ok"] is False


@pytest.mark.parametrize("error", [_build.KernelError, torch.AcceleratorError])
def test_device_fault_in_a_rung_is_not_stepped_past(no_faults, monkeypatch,
                                                   error):
    """A kernel that fails to launch, or a fault the card reports, ends the
    solve: the ladder steps past solver errors, not past a broken card."""
    def fault(*args, **kwargs):
        raise error("eg_pdhg: CUDA error 700 at launch")

    monkeypatch.setattr(eg_pdhg, "solve_eg_pdhg", fault)
    planner = _tiny_planner("pdhg", plan_deadline_s=10.0)
    with pytest.raises(error, match="CUDA error 700"):
        planner.current_round_schedule()
    record = planner.solve_records[-1]
    assert record["ok"] is False and record["backend"] == "pdhg"


def test_device_fault_of_an_abandoned_rung_raises_next_solve(no_faults,
                                                             monkeypatch):
    """A rung abandoned at its deadline that then hits a device fault
    fails the next ladder solve."""
    def fault(*args, **kwargs):
        raise _build.KernelError("eg_pdhg: CUDA error 700 at launch")

    monkeypatch.setattr(eg_pdhg, "solve_eg_pdhg", fault)
    faults.configure(faults.FaultPlan(seed=0, events=[
        faults.FaultEvent(0, "solver_slowdown", round=0, delay_s=0.3)]))
    planner = _tiny_planner("pdhg", plan_deadline_s=0.1)
    assert planner.current_round_schedule()
    assert planner.solve_records[-1]["ladder"][0] == {
        "backend": "pdhg", "outcome": "timeout"}
    for worker, _ in planner._abandoned:
        worker.join()
    planner.set_recompute_flag()
    with pytest.raises(_build.KernelError, match="CUDA error 700"):
        planner.current_round_schedule()


def test_spent_deadline_skips_to_the_final_rung(no_faults):
    """With no budget left every rung but the last is skipped_budget, and
    the final rung (native, host-only) still plans."""
    planner = _tiny_planner("tpu", plan_deadline_s=0.0)
    assert planner.current_round_schedule()
    record = planner.solve_records[-1]
    assert record["ok"] and record["backend"] == "native"
    assert [a["outcome"] for a in record["ladder"]] == [
        "skipped_budget"] * 3 + ["ok"]


def test_abandoned_rung_leaves_the_final_rung_running(no_faults):
    """A rung slowed past the deadline is abandoned (its thread runs on
    into the void) and the next rungs still plan: with every device rung
    slowed, the host-only native rung does."""
    plan = faults.FaultPlan(seed=0, events=[
        faults.FaultEvent(i, "solver_slowdown", round=0, delay_s=0.5)
        for i in range(3)])
    injector = faults.configure(plan)
    planner = _tiny_planner("pdhg", plan_deadline_s=0.2)
    assert planner.current_round_schedule()
    record = planner.solve_records[-1]
    assert record["ok"] and record["backend"] == "native"
    outcomes = [a["outcome"] for a in record["ladder"]]
    assert outcomes[0] == "timeout" and outcomes[-1] == "ok"
    assert set(outcomes[1:-1]) <= {"timeout", "skipped_budget"}
    assert injector.summary()["unrecovered"] == []


def test_golden_run_under_the_ladder(no_faults):
    """The golden trace with a planning deadline and one injected timeout
    at round 0: the first solve falls to the pdhg rung, the rest plan on
    the primary, and every plan is recorded."""
    faults.configure(faults.FaultPlan(
        seed=0, events=[faults.FaultEvent(0, "solver_timeout", round=0)]))
    result = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, "shockwave_tpu", 8,
                                 "cpu", config={"plan_deadline_s": 30.0})
    degraded = [r for r in result["records"] if r.get("degraded")]
    assert len(degraded) == 1
    assert degraded[0]["ladder"] == [
        {"backend": "tpu", "outcome": "timeout_injected"},
        {"backend": "pdhg", "outcome": "ok"}]
    assert result["solves"]["pdhg"] == 1
    assert all(r["ok"] for r in result["records"])


def test_fault_plans_of_the_scheduler_are_not_ported(no_faults):
    """The scheduler's fault kinds are ported now (tests/
    test_torch_faults.py): a plan holding one arms, and its event goes to
    the cluster queue the simulator pops, never to the ladder's solver
    queue."""
    injector = faults.configure(faults.FaultPlan(seed=0, events=[
        faults.FaultEvent(0, "worker_crash", at_s=10.0)]))
    assert injector.next_solver_fault(10**6) is None
    assert [e.event_id for e in injector.due_cluster_events(10.0)] == [0]


def test_fault_plan_round_trips_and_loads_from_the_environment(
        no_faults, tmp_path, monkeypatch):
    plan = faults.FaultPlan(seed=3, events=[
        faults.FaultEvent(0, "solver_slowdown", round=2, delay_s=0.25),
        faults.FaultEvent(1, "solver_timeout", round=1)])
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert faults.FaultPlan.from_file(str(path)) == plan
    monkeypatch.setattr(faults, "_ENV_CHECKED", False)
    monkeypatch.setenv("SHOCKWAVE_FAULTS", str(path))
    injector = faults.active()
    assert injector is not None and injector.plan == plan
    assert injector.next_solver_fault(0) is None
    assert injector.next_solver_fault(5).event_id == 1
    assert injector.summary()["pending_solver"] == 1
