"""The port's streaming soak (``tools/streaming_soak.py --smoke``, the
reduced campaign of ``scripts/ci/churn_smoke.py``) against the JAX
package's ``scripts/streaming_soak.main`` under the same arguments, both
on the CPU and both into ``tmp_path``: the same fault plan, the same
planned and applied events, admission events, submitter counts, replans
and exact replays, and the makespans and worst finish-time fairness
within 1e-3 relative."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from shockwave_tpu_torch.tools import streaming_soak

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-3


def _jax_soak():
    sys.path.insert(0, str(ROOT))
    path = ROOT / "scripts" / "streaming_soak.py"
    spec = importlib.util.spec_from_file_location("jax_streaming_soak", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Both packages' reduced campaigns: (JAX result, port result, their
    output directories)."""
    jax_soak = _jax_soak()
    out = tmp_path_factory.mktemp("streaming")
    jax_args = jax_soak.build_parser().parse_args(
        ["--out", str(out / "jax")])
    for key, value in streaming_soak.SMOKE.items():
        setattr(jax_args, key, value)
    assert jax_soak.main(jax_args) == 0
    port_args = streaming_soak.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--out", str(out / "port")])
    assert streaming_soak.main(port_args) == 0
    name = streaming_soak.SMOKE["result_name"]
    return (json.loads((out / "jax" / name).read_text()),
            json.loads((out / "port" / name).read_text()), out)


def test_the_fault_plans_are_equal(campaigns):
    _, _, out = campaigns
    plans = [json.loads((out / pkg / "churn_smoke_fault_plan.json")
                        .read_text()) for pkg in ("jax", "port")]
    assert plans[0] == plans[1]


@pytest.mark.parametrize("key", [
    "planned_fault_events", "applied_fault_events", "admission_events",
    "total_events", "submitter", "replan_count", "replayed_plans",
    "replay_exact", "watchdog_alert_rules"])
def test_the_counts_are_equal(campaigns, key):
    jax_result, port, _ = campaigns
    assert port[key] == jax_result[key]


@pytest.mark.parametrize("key", [
    "accepted_jobs", "rejected_batches", "deduped_batches", "depth",
    "closed"])
def test_the_admission_queues_agree(campaigns, key):
    jax_result, port, _ = campaigns
    assert port["admission"][key] == jax_result["admission"][key]


def test_every_invariant_holds_and_every_replay_is_exact(campaigns):
    _, port, _ = campaigns
    assert port["ok"] and port["failures"] == []
    assert port["replay_exact"] == port["replayed_plans"] > 0
    assert port["total_events"] >= streaming_soak.SMOKE["min_events"]
    assert port["admission"]["rejected_batches"] >= 1
    assert port["device"] == "cpu"


@pytest.mark.parametrize("run", ["baseline", "chaos"])
def test_makespan_and_worst_ftf_agree(campaigns, run):
    jax_result, port, _ = campaigns
    for key in ("makespan_s", "worst_ftf"):
        assert port[run][key] == pytest.approx(jax_result[run][key],
                                               rel=RTOL)
    assert port[run]["rounds"] == jax_result[run]["rounds"]
    assert port[run]["preemptions"] == jax_result[run]["preemptions"]


def test_a_violated_invariant_exits_nonzero(tmp_path, monkeypatch):
    """A campaign that admits a job twice fails the soak's exit code."""
    real = streaming_soak.run_stream

    def doubling(*args, **kwargs):
        result = real(*args, **kwargs)
        if kwargs.get("decision_log"):
            result["admitted"] += 1
        return result

    monkeypatch.setattr(streaming_soak, "run_stream", doubling)
    args = streaming_soak.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--out", str(tmp_path)])
    assert streaming_soak.main(args) == 1
    result = json.loads((tmp_path / "churn_smoke.json").read_text())
    assert any(f.startswith("ADMISSION MISCOUNT") for f in result["failures"])


def test_priced_admission_runs_through_the_pricer(tmp_path):
    """``--price_admission`` prices the stream's batches on ``--device``
    (the planner's state at each drain) and keeps every invariant."""
    args = streaming_soak.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--price_admission",
         "--price_budget_s", "30", "--out", str(tmp_path)])
    assert streaming_soak.main(args) == 0
    result = json.loads((tmp_path / "churn_smoke.json").read_text())
    assert result["ok"] and result["admission"]["accepted_jobs"] == 14
    adm = result["admission"]
    assert adm["priced_accepts"] + adm["priced_rejects"] >= 1, adm
