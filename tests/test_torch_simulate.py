"""The port's simulation path against the JAX package's, on the CPU.

The golden metrics of the committed 12-job trace (tests/test_golden.py),
and the 220-job trace on 256 GPUs (Figure 9's largest cluster): every
planning problem the JAX package's run solves gives equal counts in the
port, and the port's run of the same configuration gives the same
makespan, average JCT and worst finish-time fairness within 1e-3.
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
from shockwave_tpu_torch import simulate
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.policies.shockwave import ShockwavePlanner
from shockwave_tpu_torch.solver import eg_level
from shockwave_tpu_torch.tools import bench_sim
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


def _ref_run(trace, policy, num_gpus):
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
def test_cli_telemetry_flags_are_not_ported(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        simulate.main(["-t", str(bench_sim.GOLDEN_TRACE), "--device", "cpu",
                       *flag])


def test_cli_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        simulate.main(["-t", str(bench_sim.GOLDEN_TRACE), "-p",
                       "shockwave_native", "--device", "cuda"])


@pytest.mark.parametrize("name", [
    "fifo", "max_min_fairness", "shockwave", "shockwave_tpu_pdhg",
    "shockwave_tpu_relaxed", "shockwave_tpu_sharded", "shockwave_tpu_cells"])
def test_policies_not_ported_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_policy(name, device="cpu")


@pytest.mark.parametrize("config, kwargs", [
    ({"speculate": True}, {}),
    ({"plan_deadline_s": 1.0}, {}),
    ({"hetero_pools": True}, {}),
    ({"cells": 4}, {}),
    ({}, {"simulate": False}),
    ({}, {"profiling_percentage": 0.5}),
])
def test_options_not_ported_raise(config, kwargs):
    shockwave_config = {"num_gpus": 8, "time_per_iteration": 120, **config}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Scheduler(get_policy("shockwave_tpu_level", device="cpu"),
                  throughputs=generate_oracle(),
                  shockwave_config=shockwave_config, **kwargs)


def test_sharded_scale_with_several_cards_raises(monkeypatch):
    """At the reference's sharded-dispatch scale with more than one card
    visible the tpu dispatch raises instead of solving on one card."""
    from shockwave_tpu_torch.policies import shockwave

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(shockwave, "SHARDED_DISPATCH_MIN_JOBS", 2)
    planner = ShockwavePlanner({"num_gpus": 8, "time_per_iteration": 120},
                               backend="tpu", device="cuda")
    problem = bench_sim.seeded_problem(4, num_gpus=8)
    with pytest.raises(NotImplementedError, match="sharded"):
        planner._solve_backend("tpu", problem)


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
