"""The port's flight recorder against the JAX package's, on the CPU.

- The codec: ``encode`` gives the JAX package's bytes for the same state
  (exact).
- The fixture run (``results/flight_recorder/README.md``) in both
  packages with every plane on: the decision logs equal record for
  record, wall-clock fields (a solve's ``seconds``, ``wall_s``) compared
  for presence only; the metrics dumps equal in every deterministic
  series (exact) and in the sample counts of the wall-clock families;
  the traces' events equal but for the causal ids and wall readings.
- Against the committed fixture: 32 plan records, 419 round contexts,
  every plan window and the run's counters equal. The fixture predates
  the JAX package's current calibration scoring and its market plane;
  what differs is pinned to the JAX package's own current run (ROADMAP
  queue 3).
- Replay across the packages, every plan diff empty: the port replays
  both committed logs and its own; the JAX package replays the port's.
- The cells market: the golden ``--cells 2 --speculate`` run's log, with
  its ``cells_replay`` stamps and speculative records, replays exactly
  in both packages, and the run with the recorder on takes the JAX
  package's decisions (``bench_sim.PLANNER``) as it does with it off.
"""

import json
import os
import subprocess
import sys
from collections import Counter, OrderedDict

import numpy as np
import pytest

from shockwave_tpu.obs import recorder as jax_recorder
from shockwave_tpu_torch import obs
from shockwave_tpu_torch.obs import recorder
from shockwave_tpu_torch.tools import bench_sim

import telemetry_reference as ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("fixture_runs")
    return ref.port_run(base), ref.jax_run(base)


def _codec_cases():
    rng = np.random.default_rng(0)
    from shockwave_tpu.core.ids import JobId as JaxJobId
    from shockwave_tpu_torch.core.ids import JobId

    runs_arr = np.repeat(rng.normal(size=4), [20, 30, 9, 41])
    dense = rng.normal(size=40)
    cases = []
    for job_id in (JobId, JaxJobId):
        cases.append({
            "rle": runs_arr, "dense": dense,
            "ints": np.arange(12, dtype=np.int64), "short": np.ones(5),
            "tuple": (1, 2.5, "x", None, (3, np.float64(4.0))),
            "od": OrderedDict([(job_id(3), [1.0, 2]), (7, {"a": (1,)})]),
            "pair": job_id(2, 5), "set": {3}, "np_scalars": [
                np.int32(4), np.float32(0.5)],
        })
    return cases


def test_encode_gives_the_jax_packages_bytes():
    ours, theirs = _codec_cases()
    assert (json.dumps(recorder.encode(ours))
            == json.dumps(jax_recorder.encode(theirs)))
    # Real planner states: every committed plan record's state, decoded
    # by each package, encodes back to the same bytes in both.
    for record in ref.records(ref.FIXTURE / "decisions.jsonl")[:40]:
        if record["event"] not in ("plan", "job_profile"):
            continue
        field = "planner_state" if record["event"] == "plan" else "profile"
        a = json.dumps(recorder.encode(recorder.decode(record[field])))
        b = json.dumps(jax_recorder.encode(jax_recorder.decode(
            record[field])))
        assert a == b == json.dumps(record[field])


def test_fixture_run_decision_logs_are_equal_record_for_record(runs):
    port, jax = runs
    ours, theirs = ref.records(port["log"]), ref.records(jax["log"])
    assert len(ours) == len(theirs) == 496
    for i, (a, b) in enumerate(zip(ours, theirs)):
        present_a, present_b = set(), set()
        assert (ref.without_wall(a, present_a)
                == ref.without_wall(b, present_b)), f"record {i}"
        assert present_a == present_b
    assert Counter(r["event"] for r in ours) == {
        "header": 1, "job_profile": 12, "plan": 32, "attribution": 32,
        "round_context": 419}


def test_fixture_run_metrics_and_trace_equal_the_jax_packages(runs):
    port, jax = runs
    with open(port["metrics"]) as f:
        ours = json.load(f)
    with open(jax["metrics"]) as f:
        theirs = json.load(f)
    assert ours["schema"] == theirs["schema"] == "shockwave-metrics-v1"
    assert ref.metric_differences(ours, theirs) == []
    assert (ref.trace_events(port["trace"])
            == ref.trace_events(jax["trace"]))


def test_fixture_run_holds_to_the_committed_fixture(runs):
    port, _ = runs
    ours = ref.records(port["log"])
    committed = ref.records(ref.FIXTURE / "decisions.jsonl")
    plans = [r["plan"] for r in ours if r["event"] == "plan"]
    assert plans == [r["plan"] for r in committed if r["event"] == "plan"]
    assert len(plans) == 32
    contexts = [r for r in ours if r["event"] == "round_context"]
    assert contexts == [r for r in committed
                        if r["event"] == "round_context"]
    assert len(contexts) == 419
    with open(port["metrics"]) as f:
        metrics = json.load(f)
    with open(ref.FIXTURE / "metrics.json") as f:
        fixture = json.load(f)
    held = ["scheduler_rounds_total", "scheduler_jobs_admitted_total",
            "scheduler_jobs_completed_total", "scheduler_preemptions_total",
            "scheduler_lease_extensions_total", "scheduler_queue_depth",
            "scheduler_round_duration_seconds", "scheduler_scheduled_jobs",
            "run_makespan_seconds", "run_avg_jct_seconds",
            "run_utilization", "run_worst_ftf", "run_unfair_fraction_pct"]
    assert ref.metric_differences(metrics, fixture, held) == []
    for name in ("scheduler_job_jct_seconds", "scheduler_job_ftf"):
        a, b = (m["metrics"][name]["series"][0] for m in (metrics, fixture))
        assert a["count"] == b["count"] and a["buckets"] == b["buckets"]
        for f in ("sum", "min", "max"):
            assert a[f] == pytest.approx(b[f], rel=1e-12, abs=0)


def test_the_committed_fixture_predates_the_current_planes(runs):
    """The committed fixture is stale against the JAX package's own run
    today, in both packages alike: its calibration scored 4044 forecasts
    (MAPE 0.993), the current scoring 2971 (MAPE 1.158), and it has no
    market gauges nor the price_spike / fairness_drift alerts the market
    plane feeds. The port equals the current run (the test above); the
    deterministic alerts the fixture does hold (health.txt: worst_ftf
    x1, calibration_mape x2) are the port's too."""
    port, jax = runs
    with open(ref.FIXTURE / "metrics.json") as f:
        fixture = json.load(f)["metrics"]
    with open(port["metrics"]) as f:
        ours = json.load(f)["metrics"]

    def value(m, name):
        return m[name]["series"][0]["value"]

    assert value(fixture, "predictor_calibration_scored") == 4044.0
    assert value(ours, "predictor_calibration_scored") == 2971.0
    assert "market_price" not in fixture and "market_price" in ours
    health = (ref.FIXTURE / "health.txt").read_text()
    alerts = Counter(ref.health_alerts(port["trace"], deterministic=False))
    for rule in ("worst_ftf", "calibration_mape"):
        assert f"{rule:<18} x{alerts[rule]}" in health
    assert alerts["price_spike"] == 7 and alerts["fairness_drift"] == 4


def test_replay_across_the_packages_is_exact(runs):
    port, _ = runs
    for log in (ref.FIXTURE / "decisions.jsonl",
                ref.EXPLAIN / "decisions.jsonl", port["log"]):
        results = recorder.replay_log(str(log), device="cpu")
        assert results and all(r["diff"] == {} for r in results), log
    assert len(recorder.replay_log(
        str(ref.FIXTURE / "decisions.jsonl"), round_index=91,
        device="cpu")) == 1
    theirs = jax_recorder.replay_log(str(port["log"]))
    assert len(theirs) == 32 and all(r["diff"] == {} for r in theirs)


def test_recorder_cli_summary_replay_and_export_state(runs, tmp_path):
    port, _ = runs
    env = dict(os.environ, PYTHONPATH=str(ref.ROOT))

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "shockwave_tpu_torch.obs.recorder",
             *args], cwd=ref.ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        return proc.returncode, proc.stdout

    rc, out = cli("summary", str(port["log"]))
    summary = json.loads(out)
    assert rc == 0 and summary["plans"] == 32
    assert summary["round_contexts"] == 419
    assert summary == jax_recorder.summarize_log(str(port["log"]))
    rc, out = cli("replay", str(port["log"]), "--round", "91",
                  "--device", "cpu")
    assert rc == 0
    assert "replayed 1 plan record(s): 1 exact, 0 diverged" in out
    artifact = tmp_path / "state.json"
    rc, out = cli("export-state", str(port["log"]), "--round", "91",
                  "--out", str(artifact))
    assert rc == 0 and json.loads(out)["round"] == 91
    envelope = jax_recorder.load_exported_state(str(artifact))
    assert envelope["round"] == 91 and envelope["backend"] == "level"


def test_a_truncated_final_line_is_skipped(runs, tmp_path):
    port, _ = runs
    text = port["log"].read_text()
    cut = tmp_path / "cut.jsonl"
    cut.write_text(text[: text.rindex("\n", 0, len(text) - 1) + 1]
                   + text.splitlines()[-1][:40])
    assert (len(list(recorder.iter_records(str(cut))))
            == len(ref.records(port["log"])) - 1)
    bad = tmp_path / "bad.jsonl"
    lines = text.splitlines()
    bad.write_text("\n".join([lines[0], "{corrupt", *lines[1:]]) + "\n")
    with pytest.raises(ValueError, match="corrupt decision record"):
        list(recorder.iter_records(str(bad)))


def test_cells_speculate_log_replays_exactly_and_changes_no_decision(
        tmp_path):
    """The golden trace under ``shockwave_tpu_pdhg --cells 2 --speculate``
    with the recorder and metrics on (the counterpart of
    tests/test_pipelining.py::TestReplayExactness and
    TestRecorderOverlay): the run is the JAX package's
    (``bench_sim.PLANNER["speculate_golden_cells"]``, as with the planes
    off), its log holds cells plan records stamped ``cells_replay``,
    speculative records and speculation records, and it replays with
    every plan diff empty in both packages."""
    from shockwave_tpu_torch import simulate

    log = tmp_path / "cells.jsonl"
    result = simulate.main([
        "-t", str(bench_sim.GOLDEN_TRACE), "-p", "shockwave_tpu_pdhg",
        "-c", "v100=8", "--time_per_iteration", "120", "--cells", "2",
        "--speculate", "--device", "cpu", "--no_profile_cache",
        "--decision-log", str(log), "--metrics-out",
        str(tmp_path / "m.json")])
    expected = bench_sim.PLANNER["speculate_golden_cells"]
    assert bench_sim.check_run(result, expected) == []
    assert result["spec_stats"] == expected["spec_stats"]
    records = ref.records(log)
    plans = [r for r in records if r["event"] == "plan"]
    assert plans and all(r["backend"] == "cells" for r in plans)
    assert all("cells_replay" in recorder.decode(r["planner_state"])
               for r in plans)
    assert any(r.get("speculative") for r in plans)
    kinds = Counter(r["kind"] for r in records if r["event"] == "speculation")
    assert dict(kinds) == expected["spec_stats"]
    # Each attribution pairs with the plan record of its replan (a replan
    # whose stale cells hold no job prices nothing).
    atts = [r for r in records if r["event"] == "attribution"]
    keys = Counter((r["round"], bool(r.get("speculative"))) for r in plans)
    assert atts and len(atts) <= len(plans)
    assert all(keys[(a["round"], bool(a.get("speculative")))] for a in atts)
    assert all(set(a["jobs"]["cell"]) <= {"c00", "c01"} for a in atts)
    ours = recorder.replay_log(str(log), device="cpu")
    assert len(ours) == len(plans) and all(r["diff"] == {} for r in ours)
    theirs = jax_recorder.replay_log(str(log))
    assert len(theirs) == len(plans)
    assert all(r["diff"] == {} for r in theirs)
    assert not obs.get_recorder().enabled


def test_a_ladder_fallback_plan_replays_as_its_rung(tmp_path):
    """A deliberate divergence (ROADMAP queue 3): a plan the degradation
    ladder's relaxed rung made (the golden trace under pdhg, one injected
    solver timeout at round 20) was solved as a fallback, which skips the
    relaxed solve's PDHG polish. The port stamps that into the plan
    record (``replay_as_fallback``) and replays it exactly; the JAX
    package records no such flag and re-solves the rung as a primary, so
    its replay of the same record diverges (its own logs' too)."""
    from shockwave_tpu_torch import simulate
    from shockwave_tpu_torch.runtime import faults

    plan = tmp_path / "plan.json"
    plan.write_text(faults.FaultPlan(seed=0, events=[
        faults.FaultEvent(0, "solver_timeout", round=20)]).to_json())
    log = tmp_path / "d.jsonl"
    try:
        simulate.main(["-t", str(bench_sim.GOLDEN_TRACE), "-p",
                       "shockwave_tpu_pdhg", "-c", "v100=8",
                       "--time_per_iteration", "120", "--fault-plan",
                       str(plan), "--no_profile_cache", "--device", "cpu",
                       "--decision-log", str(log)])
    finally:
        faults.reset()
    degraded = [r for r in ref.records(log) if r["event"] == "plan"
                and r["backend"] == "relaxed"]
    assert [r["round"] for r in degraded] == [20]
    assert recorder.decode(degraded[0]["planner_state"])[
        "replay_as_fallback"] is True
    ours = recorder.replay_log(str(log), device="cpu")
    assert len(ours) == 15 and all(r["diff"] == {} for r in ours)
    theirs = jax_recorder.replay_log(str(log), round_index=20)
    assert len(theirs) == 1 and theirs[0]["diff"]
