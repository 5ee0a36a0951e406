"""The port's chaos soak (``tools/chaos_soak.py --smoke``, the reduced
campaign of ``scripts/ci/chaos_smoke.py``) against the JAX package's
``scripts/chaos_soak.main`` under the same arguments, both on the CPU and
both into ``tmp_path``: the same fault plan, the same applied, recovered
and degraded counts, every replay exact, and the makespans and worst
finish-time fairness within 1e-3 relative."""

import importlib.util
import json
from pathlib import Path

import pytest

from shockwave_tpu_torch.tools import chaos_soak

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-3


def _jax_soak():
    import sys

    sys.path.insert(0, str(ROOT))
    path = ROOT / "scripts" / "chaos_soak.py"
    spec = importlib.util.spec_from_file_location("jax_chaos_soak", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Both packages' reduced campaigns: (JAX result, port result, their
    output directories)."""
    jax_soak = _jax_soak()
    out = tmp_path_factory.mktemp("chaos")
    jax_args = jax_soak.build_parser().parse_args(
        ["--out", str(out / "jax")])
    for key, value in chaos_soak.SMOKE.items():
        setattr(jax_args, key, value)
    assert jax_soak.main(jax_args) == 0
    port_args = chaos_soak.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--out", str(out / "port")])
    assert chaos_soak.main(port_args) == 0
    name = chaos_soak.SMOKE["result_name"]
    return (json.loads((out / "jax" / name).read_text()),
            json.loads((out / "port" / name).read_text()), out)


def test_the_fault_plans_are_equal(campaigns):
    _, _, out = campaigns
    plans = [json.loads((out / pkg / "chaos_smoke_fault_plan.json")
                        .read_text()) for pkg in ("jax", "port")]
    assert plans[0] == plans[1]


@pytest.mark.parametrize("key", [
    "planned_events", "applied_events", "recovered_events", "log_faults",
    "log_recoveries", "degraded_rounds", "replayed_plans", "replay_exact",
    "watchdog_alert_rules"])
def test_the_counts_are_equal(campaigns, key):
    jax_result, port, _ = campaigns
    assert port[key] == jax_result[key]


def test_every_invariant_holds_and_every_replay_is_exact(campaigns):
    _, port, _ = campaigns
    assert port["ok"] and port["failures"] == []
    assert port["replay_exact"] == port["replayed_plans"] > 0
    assert port["applied_events"] >= chaos_soak.SMOKE["min_events"]
    assert port["degraded_rounds"] >= 1
    assert port["device"] == "cpu"


@pytest.mark.parametrize("run", ["baseline", "chaos"])
def test_makespan_and_worst_ftf_agree(campaigns, run):
    jax_result, port, _ = campaigns
    for key in ("makespan_s", "worst_ftf"):
        assert port[run][key] == pytest.approx(jax_result[run][key],
                                               rel=RTOL)
    assert port[run]["rounds"] == jax_result[run]["rounds"]
    assert port[run]["preemptions"] == jax_result[run]["preemptions"]
    assert port["worst_ftf_delta"] == pytest.approx(
        jax_result["worst_ftf_delta"], abs=RTOL)


def test_a_violated_invariant_exits_nonzero(tmp_path, monkeypatch):
    """A campaign that loses a job fails the soak's exit code."""
    real = chaos_soak.run_sim

    def losing(*args, **kwargs):
        result = real(*args, **kwargs)
        if kwargs.get("decision_log"):
            result["completed"] -= 1
        return result

    monkeypatch.setattr(chaos_soak, "run_sim", losing)
    args = chaos_soak.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--out", str(tmp_path)])
    assert chaos_soak.main(args) == 1
    result = json.loads((tmp_path / "chaos_smoke.json").read_text())
    assert any(f.startswith("LOST JOBS") for f in result["failures"])
