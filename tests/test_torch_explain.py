"""The port's explain plane against the JAX package's.

- ``narrative_from_records`` over the JAX package's committed campaign log
  (``results/explain/decisions.jsonl``) equals the committed
  ``narratives.json`` field for field (exact), as the JAX package's does.
- The campaign itself (scripts/ci/explain_smoke.py's: the 12-job trace on
  2 chips, 60 s rounds, ``shockwave_tpu_pdhg`` with speculation, measured
  relaunch overheads, two tenants) in the port, on the CPU (kernel A's
  plain version): every job has a market trail, committed attributions
  pair 1:1 with committed plans, a committed replan prices capacity, the
  price gauges land, and its narratives equal the committed ones in every
  field. Float fields there are held to 1e-12 relative: kernel A's plain
  version sums in another order than XLA, and 221 of the 3518 floats sit
  up to 4e-15 apart on the CPU; every other field is exact.
- With the recorder and metrics off, the campaign takes the same
  decisions (the counterpart of tests/test_explain.py::
  TestDisabledParity).
"""

import json

import pytest

from shockwave_tpu.obs import explain as jax_explain
from shockwave_tpu_torch import obs
from shockwave_tpu_torch.obs import explain, recorder

import telemetry_reference as ref

OVERHEADS = {"LM": 32.4, "Recommendation": 32.6, "ResNet-18": 92.8,
             "ResNet-50": 99.1, "Transformer": 31.8}
FLOAT_RTOL = 1e-12


def _campaign(log=None, metrics=False):
    """The explain campaign in the port on the CPU; returns (makespan,
    every round's schedule, the tenant spend gauge's series)."""
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data import parse_trace
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.policies import get_policy

    obs.reset()
    if log is not None:
        obs.configure_recorder(str(log))
    obs.configure(metrics=metrics)
    try:
        jobs, arrivals = parse_trace(
            str(ref.ROOT / "traces" / "small_12_dynamic.trace"))
        oracle = generate_oracle()
        profiles = synthesize_profiles(jobs, oracle)
        for i, job in enumerate(jobs):
            job.duration = sum(profiles[i]["duration_every_epoch"])
            job.tenant = "alpha" if i % 2 == 0 else "beta"
        sched = Scheduler(
            get_policy("shockwave_tpu_pdhg", device="cpu"),
            throughputs=oracle, seed=0, time_per_iteration=60,
            profiles=profiles, preemption_overheads=dict(OVERHEADS),
            shockwave_config={
                "num_gpus": 2, "time_per_iteration": 60, "future_rounds": 20,
                "lambda": 5.0, "k": 10.0, "solver_rel_gap": 1e-3,
                "solver_timeout": 15, "speculate": True},
            device="cpu")
        makespan = sched.simulate({"v100": 2}, list(arrivals), list(jobs))
        if log is not None:
            obs.get_recorder().close()
        names = set(obs.get_registry().snapshot()["metrics"])
        rounds = [r for r in sched._round_log if r["event"] == "round"]
        return makespan, rounds, names
    finally:
        obs.reset()


def _mismatches(ours, theirs, path="") -> list:
    if isinstance(ours, dict):
        if set(ours) != set(theirs):
            return [f"{path}: keys {sorted(set(ours) ^ set(theirs))}"]
        return [m for k in ours
                for m in _mismatches(ours[k], theirs[k], f"{path}.{k}")]
    if isinstance(ours, list):
        if len(ours) != len(theirs):
            return [f"{path}: {len(ours)} != {len(theirs)} entries"]
        return [m for i, (a, b) in enumerate(zip(ours, theirs))
                for m in _mismatches(a, b, f"{path}[{i}]")]
    if isinstance(ours, float) and isinstance(theirs, float):
        if ours != pytest.approx(theirs, rel=FLOAT_RTOL, abs=0):
            return [f"{path}: {ours!r} != {theirs!r}"]
        return []
    return [] if ours == theirs else [f"{path}: {ours!r} != {theirs!r}"]


def test_committed_log_narratives_equal_the_committed_narratives():
    log = str(ref.EXPLAIN / "decisions.jsonl")
    with open(ref.EXPLAIN / "narratives.json") as f:
        committed = json.load(f)
    ours = json.loads(json.dumps(explain.narrative_from_log(log)))
    assert ours == committed
    assert ours == json.loads(json.dumps(jax_explain.narrative_from_log(log)))
    one = explain.narrative_from_records(recorder.iter_records(log),
                                         job_id="7")
    assert json.loads(json.dumps(one)) == committed["jobs"]["7"]
    assert explain.narrative_from_records(recorder.iter_records(log),
                                          job_id="99") is None


def test_the_campaign_explains_every_job_as_committed(tmp_path):
    log = tmp_path / "decisions.jsonl"
    makespan, _, names = _campaign(log, metrics=True)
    assert makespan == pytest.approx(24988.067774929827, rel=1e-9)
    records = ref.records(log)
    plans = [r for r in records if r["event"] == "plan"
             and not r.get("speculative")]
    atts = [r for r in records if r["event"] == "attribution"
            and not r.get("speculative")]
    assert plans and len(atts) == len(plans)
    assert any(a["market"]["budget_dual"] > 0 for a in atts)
    assert {"market_price", "market_fairness_drift",
            "market_tenant_spend"} <= names
    narratives = explain.narrative_from_log(str(log))["jobs"]
    assert set(narratives) == {str(j) for j in range(12)}
    assert all(n["trail"] for n in narratives.values())
    assert any(n["preemptions"] for n in narratives.values())
    with open(ref.EXPLAIN / "narratives.json") as f:
        committed = json.load(f)
    assert _mismatches(json.loads(json.dumps({"jobs": narratives})),
                       committed) == []
    replayed = recorder.replay_log(str(log), device="cpu")
    assert replayed and all(r["diff"] == {} for r in replayed)


def test_disabled_planes_take_the_same_decisions(tmp_path):
    on = _campaign(tmp_path / "on.jsonl", metrics=True)
    off = _campaign()
    assert on[0] == off[0]
    assert on[1] == off[1]
    assert not off[2]
