"""The port's health watchdog and its reports against the JAX package's.

- The rules: ``DEFAULT_RULES`` and their overrides are the JAX package's.
- The rules' arithmetic: the same metrics, round by round, fire the same
  alerts in both packages (exact).
- The fixture run with ``--watchdog`` in both packages: the alerts of the
  rules whose inputs are deterministic equal the JAX package's round for
  round; ``solver_time`` reads wall seconds and is only reported.
- ``--watchdog-config`` overrides reach the rules as in the JAX package.
- The JAX package's analysis scripts read the port's dumps:
  ``scripts/analysis/health_report.py`` and ``report_run.py`` render the
  port's metrics dump as they render the JAX package's, but for the
  readings of the wall clock.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from shockwave_tpu import obs as jax_obs
from shockwave_tpu.obs import watchdog as j_wd
from shockwave_tpu_torch import obs
from shockwave_tpu_torch.obs import watchdog as p_wd

import telemetry_reference as ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("watchdog_runs")
    return ref.port_run(base), ref.jax_run(base)


@pytest.fixture(autouse=True)
def _reset_planes():
    obs.reset()
    jax_obs.reset()
    yield
    obs.reset()
    jax_obs.reset()


def test_default_rules_and_overrides_match():
    assert p_wd.DEFAULT_RULES == j_wd.DEFAULT_RULES
    overrides = {"worst_ftf": {"threshold": 1.5}, "straggler": False}
    assert p_wd.merge_rules(overrides) == j_wd.merge_rules(overrides)
    for mod in (p_wd, j_wd):
        with pytest.raises(ValueError, match="unknown watchdog rule"):
            mod.merge_rules({"nope": {}})


def test_rules_fire_the_same_alerts_on_the_same_rounds():
    """A seeded 60-round stream of the metrics the rules read (fairness,
    solve times, calibration, preemptions, degraded solves, worker
    deaths, prices, drift, job progress) through both packages' watchdog:
    the same alerts, round for round."""
    fired = []
    for planes, mod in ((obs, p_wd), (jax_obs, j_wd)):
        rng = np.random.default_rng(5)
        planes.configure(metrics=True, trace=True)
        wd = mod.Watchdog(enabled=True)
        steps = {j: 0 for j in range(6)}
        for r in range(60):
            planes.histogram("scheduler_job_ftf", "").observe(
                float(rng.gamma(2.0, 0.6)))
            planes.histogram("shockwave_solve_seconds", "").observe(
                float(rng.exponential(0.02) + (0.5 if r == 40 else 0.0)),
                backend="level", ok="True")
            planes.gauge("predictor_calibration_mape", "").set(
                float(rng.uniform(0.1, 0.9)))
            planes.gauge("predictor_calibration_scored", "").set(10.0 + r)
            planes.counter("scheduler_preemptions_total", "").inc(
                float(rng.integers(0, 3) if r != 30 else 20))
            if r in (12, 33):
                planes.counter("shockwave_solver_degraded_total", "").inc(
                    backend="pdhg")
            if r == 25:
                planes.counter("scheduler_worker_deaths_total", "").inc(
                    2, kind="worker_crash")
            planes.gauge("market_price", "").set(
                float(rng.uniform(0.9, 1.1) * (5.0 if r == 45 else 1.0)))
            planes.gauge("market_fairness_drift", "").set(
                float(0.4 if 20 <= r < 26 else 0.1))
            for j in steps:
                if j != 3 or r < 10:
                    steps[j] += int(rng.integers(1, 5))
            wd.check_round(r, 60.0 * r, job_steps=dict(steps),
                           scheduled=list(steps))
        fired.append((wd.alerts, wd.summary(), wd.format_summary()))
    assert fired[0] == fired[1]
    assert {a["rule"] for a in fired[0][0]} >= {
        "worst_ftf", "solver_degraded", "worker_death", "straggler",
        "fairness_drift"}


def test_fixture_run_alerts_match_round_for_round(runs):
    port, jax = runs
    ours = ref.health_alerts(port["trace"])
    assert ours == ref.health_alerts(jax["trace"])
    assert [a["rule"] for a in ours].count("calibration_mape") == 2
    everything = ref.health_alerts(port["trace"], deterministic=False)
    # Reported, not held: the wall-clock rule fires where this host's
    # solves were slow.
    print("solver_time alerts:", everything.count("solver_time"))
    assert "Scheduler health: DEGRADED" in jax["stdout"]


def test_watchdog_config_override_reaches_the_rules(tmp_path):
    """``--watchdog-config`` with worst_ftf at 1.5 and the market rules
    off, on the golden trace: the port's alerts are the JAX package's
    under the same override."""
    from shockwave_tpu_torch import simulate

    config = json.dumps({"worst_ftf": {"threshold": 1.5},
                         "price_spike": False, "fairness_drift": False})
    args = ["-t", "traces/small_12_dynamic.trace", "-p",
            "shockwave_tpu_level", "-c", "v100=8", "--time_per_iteration",
            "120"]
    trace = tmp_path / "t.json"
    cwd = os.getcwd()
    os.chdir(ref.ROOT)
    try:
        simulate.main(args + ["--device", "cpu", "--no_profile_cache",
                              "--watchdog-config", config, "--trace-out",
                              str(trace)])
    finally:
        os.chdir(cwd)
    j_trace = tmp_path / "jt.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ref.ROOT))
    proc = subprocess.run(
        [sys.executable, "scripts/simulate.py", *args, "--watchdog-config",
         config, "--trace-out", str(j_trace)], cwd=ref.ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ours = ref.health_alerts(trace)
    assert ours == ref.health_alerts(j_trace)
    assert any(a["rule"] == "worst_ftf" and a["threshold"] == 1.5
               for a in ours)
    assert not {"price_spike", "fairness_drift"} & set(
        ref.health_alerts(trace, deterministic=False))


def _script(name, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ref.ROOT))
    proc = subprocess.run(
        [sys.executable, f"scripts/analysis/{name}", *map(str, args)],
        cwd=ref.ROOT, env=env, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout


def test_health_report_renders_the_ports_dump(runs):
    port, jax = runs
    rc, ours = _script("health_report.py", port["metrics"])
    rc_j, theirs = _script("health_report.py", jax["metrics"])
    assert rc == rc_j == 0
    assert "=== Scheduler health: DEGRADED ===" in ours
    wall = ("shockwave_solve_seconds", "solver_backend",
            "shockwave_plan_", "effective_planning_overhead",
            "solver_time", "Alerts (")
    keep = [[line for line in text.splitlines()
             if not any(w in line for w in wall)] for text in (ours, theirs)]
    assert keep[0] == keep[1]


def test_report_run_renders_the_ports_dump(runs):
    port, jax = runs
    tables = []
    for run in (port, jax):
        rc, out = _script("report_run.py", run["metrics"], "--trace",
                          run["trace"], "--json")
        assert rc == 0
        tables.append(json.loads(out))
    ours, theirs = tables
    for key in ("overview", "market", "market_trail", "calibration",
                "worst_offenders", "ingest"):
        assert ours[key] == theirs[key], key
    for alerts in (ours["health_alerts"], theirs["health_alerts"]):
        alerts.pop("solver_time", None)
    assert ours["health_alerts"] == theirs["health_alerts"]
    assert [s["count"] for s in ours["solves"]] == [
        s["count"] for s in theirs["solves"]]
    for name, series in ours["history"].items():
        if name not in ref.WALL_FAMILIES:
            assert series == theirs["history"][name], name


def test_the_smoke_pins_are_the_jax_packages_run(runs):
    """``bench_sim.TELEMETRY_FIXTURE``, what chip_smoke.py holds the
    card's fixture run to, is the JAX package's run of today, and the
    port's CPU run meets it exactly."""
    from shockwave_tpu_torch.tools import bench_sim

    port, jax = runs
    pins = bench_sim.TELEMETRY_FIXTURE
    for run in (jax, port):
        got = ref.fixture_pins(run["metrics"], run["trace"])
        assert got == {k: pins[k] for k in got}
    assert bench_sim.check_run(port["result"], pins["run"]) == []
    with open(port["metrics"]) as f, open(ref.FIXTURE / "metrics.json") as g:
        assert ref.metric_differences(json.load(f), json.load(g),
                                      bench_sim.TELEMETRY_HELD) == []
