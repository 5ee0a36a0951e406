"""How ``chip_smoke.py`` phase 17's planner label decides whether the
Shockwave planner rotates its three jobs.

Runs the phase's cluster on the port's ``PhysicalScheduler`` under the
scripted clock of ``tests/test_torch_physical.py`` (``run_phase17``) for
each planner label, round length, micro-task start-up and training rate
of the grid, and prints each run's rounds, each job's attempts and the
scheduler's preemptions by job, then, for each label, the runs in which
every job ran in two attempts or more. On the CPU, in about a minute:

    JAX_PLATFORMS=cpu python tests/physical_rotation.py
"""

import itertools
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_physical import run_phase17  # noqa: E402

LABELS = ("Transformer (batch size 128)", "Transformer (batch size 16)")
ROUNDS_S = (22, 25)
STARTUPS_S = (15.0, 17.0, 19.0)
RATES = (14.0, 16.5)


def main() -> None:
    rotated = {}
    for label, round_s, startup_s, rate in itertools.product(
            LABELS, ROUNDS_S, STARTUPS_S, RATES):
        patch = pytest.MonkeyPatch()
        try:
            run = run_phase17(patch, round_s, startup_s, rate, job_type=label)
        finally:
            patch.undo()
        every = all(run["attempts"].get(j, 0) >= 2 for j in "012")
        rotated.setdefault(label, []).append(every)
        print(json.dumps({"label": label, "round_s": round_s,
                          "startup_s": startup_s, "rate": rate, **run,
                          "every_job_resumed": every}), flush=True)
    for label, runs in rotated.items():
        print(f"{label}: every job resumed in {sum(runs)} of {len(runs)} "
              "runs")


if __name__ == "__main__":
    main()
