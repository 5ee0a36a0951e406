"""The simulator's remaining features in the port, against the JAX
package on the same seeded inputs: cost accounting with constant and
spot-price schedules, round logs and job timelines, lease extensions,
the HA state codec, checkpoints that carry the round log, the trace
generators, the job table and the simulate CLI's flags."""

import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from shockwave_tpu.core.job import Job as RefJob
from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
from shockwave_tpu.data import generate as ref_generate
from shockwave_tpu.data import spot_prices as ref_spot
from shockwave_tpu.data.default_oracle import generate_oracle as ref_oracle
from shockwave_tpu.data.job_table import build_job_table as ref_table
from shockwave_tpu.data.profiles import synthesize_profiles as ref_profiles
from shockwave_tpu.data.workload_info import steps_per_epoch
from shockwave_tpu.policies import get_policy as ref_policy
from shockwave_tpu_torch import simulate
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data import generate, spot_prices
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.job_table import build_job_table
from shockwave_tpu_torch.data.profiles import synthesize_profiles
from shockwave_tpu_torch.ha import codec
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.tools import bench_sim

ROOT = Path(__file__).resolve().parent.parent


def tiny_trace(job_cls, num_jobs=2, epochs=2, arrival_gap=0.0):
    """tests/test_simulator.py::tiny_trace."""
    jobs, arrivals = [], []
    for i in range(num_jobs):
        jobs.append(job_cls(
            job_type="ResNet-18 (batch size 32)",
            command="python3 main.py --data_dir=%s/cifar10 --batch_size 32",
            num_steps_arg="--num_steps",
            total_steps=steps_per_epoch("ResNet-18", 32) * epochs,
            scale_factor=1, mode="static"))
        arrivals.append(i * arrival_gap)
    return jobs, arrivals


def _pair(policy, prices=None, cluster=None, **kwargs):
    """The same tiny run through both packages: (port, reference)."""
    runs = []
    for job_cls, sched_cls, oracle, profiles, pol in (
            (Job, Scheduler, generate_oracle, synthesize_profiles,
             get_policy(policy, device="cpu")),
            (RefJob, RefScheduler, ref_oracle, ref_profiles,
             ref_policy(policy))):
        jobs, arrivals = tiny_trace(job_cls, **kwargs)
        o = oracle()
        sched = sched_cls(pol, throughputs=o, time_per_iteration=120,
                          profiles=profiles(jobs, o),
                          per_worker_type_prices=prices)
        sched.simulate(cluster or {"v100": 2}, arrivals, jobs)
        runs.append(sched)
    return runs


def test_cost_accounting_constant_and_spot_schedule():
    """tests/test_simulator.py:265 through the port, each total equal to
    the JAX package's: a constant price, and a schedule whose second
    breakpoint never comes."""
    schedules = {"v100": [[0.0, 3.0], [100.0, 1.0]]}
    for t, price in ((0.0, 3.0), (99.9, 3.0), (100.0, 1.0), (1e9, 1.0)):
        assert spot_prices.latest_price(schedules, "v100", t) == price
    assert spot_prices.latest_price({"v100": 0.5}, "v100", 50.0) == 0.5
    assert spot_prices.latest_price({}, "k80", 0.0) == 0.0
    flat, ref_flat = _pair("fifo", prices={"v100": 3.6})
    jobs, _ = tiny_trace(Job)
    expected = sum(sum(p["duration_every_epoch"]) for p in
                   synthesize_profiles(jobs, generate_oracle()).values()
                   ) * 3.6 / 3600.0
    assert flat.get_total_cost() == pytest.approx(expected, rel=0.05)
    assert flat.get_total_cost() == ref_flat.get_total_cost()
    spot, ref_spot_run = _pair("fifo",
                               prices={"v100": [[0.0, 3.6], [1e9, 999.0]]})
    assert spot.get_total_cost() == pytest.approx(flat.get_total_cost())
    assert spot.get_total_cost() == ref_spot_run.get_total_cost()
    free, _ = _pair("fifo")
    assert free.get_total_cost() == 0.0


def test_price_schedules_read_as_the_reference(tmp_path):
    path = tmp_path / "prices.json"
    path.write_text(json.dumps({"v100": [[3600, 0.69], [0, 0.74]],
                                "p100": 0.43}))
    assert spot_prices.read_price_schedules(str(path)) == (
        ref_spot.read_price_schedules(str(path)))
    with pytest.raises(ValueError, match="empty"):
        path.write_text(json.dumps({"v100": []}))
        spot_prices.read_price_schedules(str(path))


def test_spot_schedule_charges_by_the_price_at_completion():
    """A schedule that changes mid-run charges each micro-task at the
    price of its completion time, in both packages alike."""
    prices = {"v100": [[0.0, 2.0], [300.0, 5.0]]}
    ours, ref = _pair("max_min_fairness", prices=prices, num_jobs=3,
                      epochs=3, arrival_gap=60.0)
    assert ours.get_total_cost() == ref.get_total_cost()
    assert {j.integer: c for j, c in ours._job_cost_so_far.items()} == {
        j.integer: c for j, c in ref._job_cost_so_far.items()}
    assert ours.get_total_cost() > 0.0


@pytest.mark.parametrize("policy", ["fifo", "max_min_fairness",
                                    "max_min_fairness_packed"])
def test_round_log_and_lease_extensions_are_the_reference(policy, tmp_path):
    """On the host's policies the round log equals the JAX package's
    record for record, bit for bit, and so do the lease extensions, the
    completed steps and the file ``save_round_log`` writes."""
    ours, ref = _pair(policy, num_jobs=4, epochs=3, arrival_gap=100.0)
    assert ours._round_log == ref._round_log
    assert {r["event"] for r in ours._round_log} == {"job", "round",
                                                     "complete"}
    assert ours.get_num_lease_extensions() == (
        ref.get_num_lease_extensions())
    assert {j.integer: s for j, s in ours.get_completed_steps().items()} == {
        j.integer: s for j, s in ref.get_completed_steps().items()}
    ours.save_round_log(str(tmp_path / "ours.jsonl"))
    ref.save_round_log(str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "ours.jsonl").read_text() == (
        tmp_path / "ref.jsonl").read_text()


@pytest.mark.parametrize("policy", ["shockwave_tpu_level",
                                    "max_min_fairness"])
def test_golden_round_log_is_the_reference(policy):
    """The golden trace's round log: exact under Gavel's round path, 1e-3
    where the planner's device solve decides."""
    r = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, policy, 8, "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_faults as faults_tests

    ref = faults_tests._ref_golden(policy)
    tol = bench_sim.TOLERANCE if policy.startswith("shockwave") else 0.0
    assert bench_sim.round_log_misses(r["round_log"], ref["round_log"],
                                      tol) == []
    assert len(r["round_log"]) == len(ref["round_log"]) > 100


def test_job_timelines_are_written_as_the_reference(tmp_path):
    ours, ref = _pair("fifo")
    ours._job_timelines[next(iter(ours._job_timelines))][0].append("step 1")
    ref._job_timelines[next(iter(ref._job_timelines))][0].append("step 1")
    ours.save_job_timelines(str(tmp_path / "ours"))
    ref.save_job_timelines(str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ours")) == names == [
        "job_0.log", "job_1.log"]
    for name in names:
        assert (tmp_path / "ours" / name).read_text() == (
            tmp_path / "ref" / name).read_text()
    assert (tmp_path / "ours" / "job_0.log").read_text() == (
        "[rank 0] step 1\n")


def test_checkpoint_carries_the_round_log(tmp_path):
    """A run saved once 6 jobs were admitted and resumed from the file
    ends with the unbroken run's round log, costs and lease counts."""
    ckpt = str(tmp_path / "golden.ckpt")
    unbroken = bench_sim.run_trace(bench_sim.GOLDEN_TRACE,
                                   "max_min_fairness", 8, "cpu")
    bench_sim.run_trace(bench_sim.GOLDEN_TRACE, "max_min_fairness", 8,
                        "cpu", checkpoint_threshold=6, checkpoint_file=ckpt)
    resumed = bench_sim.run_trace(bench_sim.GOLDEN_TRACE,
                                  "max_min_fairness", 8, "cpu",
                                  checkpoint_file=ckpt)
    for k in ("makespan", "rounds", "round_log", "lease_extensions",
              "total_cost"):
        assert resumed[k] == unbroken[k], k
    import pickle

    with open(ckpt, "rb") as f:
        fields = pickle.load(f)["fields"]
    for field in ("_round_log", "_job_cost_so_far", "_job_timelines"):
        assert field in fields


def test_ha_state_restores_into_a_fresh_scheduler():
    """``ha_state_dict`` through the codec's JSON into a new scheduler of
    the same policy: every field, set, job and the planner come back,
    and a second capture hashes as the first."""
    jobs, arrivals = bench_sim.trace_jobs(bench_sim.GOLDEN_TRACE)
    oracle = generate_oracle()
    config = {"num_gpus": 8, "time_per_iteration": 120.0,
              "future_rounds": 20, "lambda": 5.0, "k": 10.0}

    def scheduler():
        return Scheduler(get_policy("shockwave_tpu_level", device="cpu"),
                         throughputs=oracle, seed=0,
                         time_per_iteration=120.0,
                         profiles=synthesize_profiles(jobs, oracle),
                         shockwave_config=config)

    sched = scheduler()
    sched.simulate({"v100": 8}, arrivals, jobs, max_rounds=30)
    state = sched.ha_state_dict()
    restored = scheduler()
    restored.restore_ha_state(codec.json_roundtrip(state))
    assert codec.state_fingerprint(restored.ha_state_dict()) == (
        codec.state_fingerprint(state))
    assert restored._shockwave.round_index == sched._shockwave.round_index
    assert list(restored._jobs) == list(sched._jobs)
    assert all(vars(restored._jobs[j]) == vars(sched._jobs[j])
               for j in sched._jobs)
    assert isinstance(restored._running_jobs, set)
    assert restored._worker_type_shuffler.getstate() == (
        sched._worker_type_shuffler.getstate())
    # The profiles it was built with are configuration; those synthesized
    # at admission travel in the state.
    assert state["profiles"] == {}
    bare = Scheduler(get_policy("shockwave_tpu_level", device="cpu"),
                     throughputs=oracle, seed=0, time_per_iteration=120.0,
                     shockwave_config=config)
    jobs, arrivals = bench_sim.trace_jobs(bench_sim.GOLDEN_TRACE)
    bare.simulate({"v100": 8}, arrivals, jobs, max_rounds=5)
    carried = codec.json_roundtrip(bare.ha_state_dict())["profiles"]
    assert sorted(carried) == sorted(bare._profiles) and len(carried) >= 1


def test_codec_helpers():
    job = Job(job_type="LM (batch size 10)", command="c", total_steps=3)
    job.arrival_time = 12.5
    back = codec.job_from_state(codec.json_roundtrip(codec.job_state(job)))
    assert vars(back) == vars(job)
    assert codec.restore_sets([3, 1]) == {1, 3}
    assert codec.restore_sets([3, 1], frozen=True) == frozenset({1, 3})
    assert codec.planner_state_or_none(object()) is None
    assert codec.state_fingerprint({"a": 1}) != codec.state_fingerprint(
        {"a": 2})


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("style", ["shockwave", "gavel"])
def test_generated_traces_are_the_reference(style, seed, tmp_path):
    """``generate_trace_jobs`` draws the JAX package's jobs and arrivals
    bit for bit, and ``generate_trace_file`` writes the same bytes."""
    kwargs = dict(lam=300.0, **generate.style_job_kwargs(style))
    ref_kwargs = dict(lam=300.0, **ref_generate.style_job_kwargs(style))
    if style == "shockwave":
        rng, ref_rng = (__import__("random").Random(seed + 9)
                        for _ in range(2))
        kwargs.update(priority_rng=rng)
        ref_kwargs.update(priority_rng=ref_rng)
    jobs, arrivals = generate.generate_trace_jobs(
        40, generate_oracle(), seed=seed, **kwargs)
    ref_jobs, ref_arrivals = ref_generate.generate_trace_jobs(
        40, ref_oracle(), seed=seed, **ref_kwargs)
    assert arrivals == ref_arrivals
    assert [j.to_trace_line() for j in jobs] == [
        j.to_trace_line() for j in ref_jobs]
    generate.generate_trace_file(str(tmp_path / "ours.trace"), 25,
                                 generate_oracle(), seed=seed, lam=60.0)
    ref_generate.generate_trace_file(str(tmp_path / "ref.trace"), 25,
                                     ref_oracle(), seed=seed, lam=60.0)
    assert (tmp_path / "ours.trace").read_bytes() == (
        tmp_path / "ref.trace").read_bytes()


def test_generated_slo_jobs_and_the_job_table_are_the_reference():
    import random

    job = generate.generate_job(
        generate_oracle(), *(random.Random(s) for s in range(4)),
        slo_rng=random.Random(5), priority_rng=random.Random(6))
    ref_job = ref_generate.generate_job(
        ref_oracle(), *(random.Random(s) for s in range(4)),
        slo_rng=random.Random(5), priority_rng=random.Random(6))
    assert job.to_trace_line() == ref_job.to_trace_line()
    with pytest.raises(ValueError, match="unknown workload style"):
        generate.style_job_kwargs("other")
    for gan_rl in (False, True):
        assert [vars(t) for t in build_job_table(gan_rl)] == [
            vars(t) for t in ref_table(gan_rl)]


def _reference_cli_flags() -> list:
    """Every option string of scripts/simulate.py's parser and of the
    JAX package's telemetry flags."""
    text = (ROOT / "scripts" / "simulate.py").read_text()
    flags = set(re.findall(r'"(--?[A-Za-z][\w-]*)"', text))
    obs_text = (ROOT / "shockwave_tpu" / "obs" / "__init__.py").read_text()
    start = obs_text.index("def add_telemetry_args")
    flags |= set(re.findall(r'"(--[A-Za-z][\w-]*)"', obs_text[start:]))
    return sorted(flags)


def test_every_reference_simulate_flag_parses():
    """Every flag of scripts/simulate.py (and the telemetry flags it
    adds) parses in the port's CLI."""
    flags = _reference_cli_flags()
    for flag in ("--fault-plan", "--round_log", "--profiling_percentage",
                 "--num_reference_models", "--solver", "--speculate"):
        assert flag in flags
    values = {"--solver": "scipy", "--cells": "2", "--seed": "0",
              "--time_per_iteration": "120", "--window-start": "0",
              "-s": "0", "--window-end": "3", "-e": "3",
              "--checkpoint_threshold": "4",
              "--num_reference_models": "4",
              "--profiling_percentage": "0.5",
              "--round_overhead_fraction": "0.25",
              "--metrics-port": "9100", "--metrics_port": "9100",
              "--policy": "fifo", "-p": "fifo"}
    for flag in flags:
        if flag in ("-t", "--trace_file"):
            continue
        args = ["-t", "x.trace", flag]
        if flag not in ("--no_profile_cache", "--speculate", "--watchdog"):
            args.append(values.get(flag, "x.json"))
        simulate.parse_args(args)


def test_new_flags_reach_the_scheduler(tmp_path, capsys):
    """``--round_log`` writes the JAX package's log of the golden fifo
    run; ``--profiling_percentage`` / ``--num_reference_models`` turn on
    estimation under a packed policy (its ALS on ``--device``)."""
    log = tmp_path / "log.jsonl"
    result = simulate.main([
        "-t", str(bench_sim.GOLDEN_TRACE), "-p", "fifo", "-c", "v100=8",
        "--time_per_iteration", "120", "--device", "cpu",
        "--no_profile_cache", "--round_log", str(log), "--seed", "0",
        "--solver", "scipy"])
    assert f"Wrote {log}" in capsys.readouterr().out
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert result["makespan"] == pytest.approx(
        bench_sim.GOLDEN_GAVEL["fifo"]["makespan"], abs=1e-3)
    assert records[0]["event"] == "job" and records[-1]["event"] in (
        "complete", "round")
    result = simulate.main([
        "-t", str(bench_sim.GOLDEN_TRACE), "-p", "max_min_fairness_packed",
        "-c", "v100=8", "--time_per_iteration", "120", "--device", "cpu",
        "--no_profile_cache", "--profiling_percentage", "0.5",
        "--num_reference_models", "4"])
    assert bench_sim.check_run(result, bench_sim.SIM_FEATURES[
        "estimate_p0.5_r4"]) == []
