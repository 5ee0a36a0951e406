"""``chip_smoke.py``'s deadlines: the phases that run to a deadline must
end within the driver's limit together.

Phase 17 (the physical plane) runs to its deadline, and phase 18 (the
failover drill, 63.6-84.2 s on the card) runs after it. Phase 17's
deadline must leave phase 18 its measured time and the smoke its exit
margin; phase 18's waits are bounded by what is left.
"""

import importlib.util
import inspect
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# The longest phase 18 on the card (PERF.md section 6, PR 15).
PHASE18_MEASURED_S = 84.2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_phase_17_leaves_phase_18_its_time_and_the_exit_margin():
    smoke = _chip_smoke()
    started = 1000.0
    deadlines = smoke.phase_deadlines(started)
    end = started + smoke.SMOKE_LIMIT_S
    assert smoke.SMOKE_LIMIT_S == 1200.0
    assert smoke.FAILOVER_RESERVE_S >= PHASE18_MEASURED_S
    # Phase 17 run to its deadline, then phase 18 for its reserve, still
    # leaves the exit margin before the driver's limit.
    assert (deadlines["physical"] + smoke.FAILOVER_RESERVE_S
            + smoke.EXIT_MARGIN_S <= end)
    assert deadlines["failover"] + smoke.EXIT_MARGIN_S <= end
    assert deadlines["physical"] < deadlines["failover"]


@pytest.mark.parametrize("reserves,expected", [
    ((("a", 0.0),), {"a": 140.0}),
    ((("a", 0.0), ("b", 30.0)), {"a": 110.0, "b": 140.0}),
    ((("a", 0.0), ("b", 30.0), ("c", 20.0)),
     {"a": 90.0, "b": 120.0, "c": 140.0}),
])
def test_each_deadline_reserves_every_later_phase(reserves, expected):
    smoke = _chip_smoke()
    assert smoke.phase_deadlines(0.0, limit=200.0, reserves=reserves,
                                 margin=60.0) == expected


def test_phase_18_waits_are_bounded_by_what_is_left(monkeypatch, tmp_path):
    """``run_failover`` hands its deadline to each arm, and an arm's wait
    never outlasts it: with 5 s left, the leader's lease wait gives up
    after about 5 s, not its own 120."""
    smoke = _chip_smoke()
    assert "deadline" in inspect.signature(smoke.run_failover).parameters
    from shockwave_tpu_torch.tools import ha_smoke

    class Drill:
        procs = []

        def __init__(self, *args):
            pass

        def node(self, *args, **kwargs):
            return None

        def agent(self, *args):
            pass

        def stop(self):
            pass

    waits = []

    def wait_leader(ha_dir, timeout_s, what, port=None):
        waits.append(timeout_s)
        raise TimeoutError(what)

    monkeypatch.setattr(ha_smoke, "Drill", Drill)
    monkeypatch.setattr(ha_smoke, "_wait_leader", wait_leader)
    monkeypatch.setattr(ha_smoke, "_crash_plan_file", lambda tmp: None)
    with pytest.raises(TimeoutError):
        ha_smoke.failover_arm(str(tmp_path), "hot", True,
                              deadline=time.time() + 5.0)
    assert len(waits) == 1 and 1.0 <= waits[0] <= 5.0
    with pytest.raises(TimeoutError):
        ha_smoke.failover_arm(str(tmp_path), "hot", True)
    assert waits[1] == 120


def test_a_failure_names_its_phase_and_the_seconds_since_the_start(
        capsys):
    """``fail`` (and an exception out of ``main``) says which phase was
    running and how far into the smoke, so a failed run on the card tells
    where it stopped."""
    smoke = _chip_smoke()
    smoke.PROGRESS["started"] = time.time() - 12.5
    smoke.enter("17 (the physical control plane)")
    with pytest.raises(SystemExit) as e:
        smoke.fail("a job never completed")
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert err.startswith("chip_smoke: FAILED in phase 17 (the physical "
                          "control plane), 12.")
    assert " s after the start: a job never completed" in err
    # Every phase the smoke runs is entered by name before it starts.
    source = inspect.getsource(smoke)
    for number in (2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18,
                   19, 20, 21, 22, 23):
        assert f'enter("{number} (' in source, number
