"""Whether the Shockwave planner rotates ``chip_smoke.py`` phase 17's three
jobs when it plans from the card's own rate.

Runs the phase's cluster on the port's ``PhysicalScheduler`` under the
scripted clock of ``tests/test_torch_physical.py`` (``run_phase17``: one
``h100`` agent, jobs sized by the card driver from a one-row oracle) for
each job length (in rounds), planning window, round length, micro-task
start-up, training rate and oracle rate of the grid, and prints each run's
rounds, each job's attempts and the scheduler's preemptions by job, then,
for each job length and window, the runs in which every job ran in two
attempts or more. On the CPU, in a few minutes:

    JAX_PLATFORMS=cpu python tests/physical_rotation.py
"""

import itertools
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_physical import phase17_oracle, run_phase17  # noqa: E402

# (job length in epochs, the planner's future rounds): one-epoch jobs, as
# phase 17's were before the card's oracle, longer ones, and its own
# (1.4, 3).
SHAPES = ((0.9, 2), (1.3, 3), (1.4, 2), (1.4, 3), (1.55, 3))
ROUNDS_S = (22, 25, 28)
STARTUPS_S = (14.0, 21.0, 28.0)
RATES = (10.0, 12.5, 15.0)  # a payload's steps/s at its share
# The payload's steps/s alone, phase 20's row (23.3 on an H100 at 700 W).
ORACLE_RATES = (23.3,)


def main() -> None:
    rotated = {}
    for (epochs, window), round_s, startup_s, rate, orate in itertools.product(
            SHAPES, ROUNDS_S, STARTUPS_S, RATES, ORACLE_RATES):
        patch = pytest.MonkeyPatch()
        try:
            run = run_phase17(patch, round_s, startup_s, rate,
                              oracle=phase17_oracle(orate), epochs=epochs,
                              config={"future_rounds": window})
        finally:
            patch.undo()
        every = all(run["attempts"].get(j, 0) >= 2 for j in "012")
        rotated.setdefault((epochs, window), []).append(every)
        print(json.dumps({"epochs": epochs, "future_rounds": window,
                          "round_s": round_s, "startup_s": startup_s,
                          "rate": rate, "oracle_rate": orate, **run,
                          "every_job_resumed": every}), flush=True)
    for (epochs, window), runs in rotated.items():
        print(f"{epochs} epochs a job, {window} future rounds: every job "
              f"resumed in {sum(runs)} of {len(runs)} runs")


if __name__ == "__main__":
    main()
