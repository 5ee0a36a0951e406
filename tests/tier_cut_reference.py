"""The JAX package's run of the cut 2048-job pdhg tier the port is held to.

    python tests/tier_cut_reference.py [--rounds R ...] [--out FILE]

``chip_smoke.py`` phase 9 runs the 2048-job trace on 256 GPUs, 120 s
rounds, under ``shockwave_tpu_pdhg`` for its first
``bench_sim.TIER_2048_PDHG_CUT["rounds"]`` rounds, not to its end. This
runs the JAX package's scheduler, on the CPU, on that prefix, driven as
the port's ``bench_sim.run_trace(..., max_rounds=R)`` drives the port's
(the arguments of ``tests/planner_reference.py::ref_run``), and prints
one JSON line a cut: the metrics ``bench_sim.TIER_2048_PDHG_CUT`` pins,
the PDHG solves and the wall seconds, and whether the run is within
``bench_sim.TOLERANCE`` of the pin. No run calls scipy's HiGHS.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from shockwave_tpu.core.scheduler import Scheduler  # noqa: E402
from shockwave_tpu.data import (  # noqa: E402
    load_or_synthesize_profiles,
    parse_trace,
)
from shockwave_tpu.data.default_oracle import generate_oracle  # noqa: E402
from shockwave_tpu.policies import get_policy  # noqa: E402
from shockwave_tpu_torch.tools import bench_sim  # noqa: E402


def ref_cut(rounds) -> dict:
    """The JAX package's run of the tier's first ``rounds`` rounds."""
    start = time.perf_counter()
    jobs, arrivals = parse_trace(str(bench_sim.TRACE_2048))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(bench_sim.TRACE_2048), jobs, oracle, worker_type="v100",
        cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = {"num_gpus": 256, "time_per_iteration": bench_sim.ROUND_S,
              "future_rounds": 20, "lambda": 5.0, "k": 10.0}
    sched = Scheduler(get_policy("shockwave_tpu_pdhg", seed=0),
                      throughputs=oracle, seed=0,
                      time_per_iteration=bench_sim.ROUND_S,
                      profiles=profiles, shockwave_config=config)
    makespan = sched.simulate({"v100": 256}, arrivals, jobs,
                              max_rounds=rounds)
    ftf, _ = sched.get_finish_time_fairness()
    solves: dict = {}
    for record in sched._shockwave.solve_records:
        solves[record["backend"]] = solves.get(record["backend"], 0) + 1
    r = dict(makespan=makespan, avg_jct=sched.get_average_jct(),
             worst_ftf=max(ftf), rounds=sched._num_completed_rounds,
             completed=sum(1 for t in sched._job_completion_times.values()
                           if t is not None),
             solves=solves, wall_s=time.perf_counter() - start)
    pin = bench_sim.TIER_2048_PDHG_CUT
    r["within_pin"] = (pin["rounds"] == rounds
                       and bench_sim.check_run(r, pin) == [])
    return r


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    pin = getattr(bench_sim, "TIER_2048_PDHG_CUT", None)
    parser.add_argument("--rounds", type=int, nargs="+",
                        default=[pin["rounds"]] if pin else [160])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    rows = []
    for rounds in args.rounds:
        r = ref_cut(rounds)
        print(json.dumps(r), flush=True)
        rows.append(r)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
