"""The JAX package's runs of the cut 2048-job tiers the port is held to.

    python tests/tier_cut_reference.py [--rounds R ...] [--out FILE]
    python tests/tier_cut_reference.py --cells [--rounds R ...]
    python tests/tier_cut_reference.py --policy shockwave_tpu [--rounds R ...]

``chip_smoke.py`` phase 9 runs the 2048-job trace on 256 GPUs, 120 s
rounds, under ``shockwave_tpu_pdhg`` for its first
``bench_sim.TIER_2048_PDHG_CUT["rounds"]`` rounds, not to its end. This
runs the JAX package's scheduler, on the CPU, on that prefix, driven as
the port's ``bench_sim.run_trace(..., max_rounds=R)`` drives the port's
(the arguments of ``tests/planner_reference.py::ref_run``), and prints
one JSON line a cut: the metrics ``bench_sim.TIER_2048_PDHG_CUT`` pins,
the PDHG solves and the wall seconds, and whether the run is within
``bench_sim.TOLERANCE`` of the pin. No run calls scipy's HiGHS.

``--cells`` runs the JAX package's ``scripts/simulate.py`` on phase 12's
cells tier (``bench_sim.TIER_2048_CELLS_ARGS``: ``--cells 4`` on 256
GPUs under ``shockwave_tpu_pdhg``) for its first R rounds, the pin of
``bench_sim.TIER_2048_CELLS_CUT``. ``--policy shockwave_tpu`` runs
phase 8's tier (``shockwave_tpu``) for its first R rounds, the pin of
``bench_sim.TIER_2048_CUT``.
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


def ref_cut(rounds, policy: str = "shockwave_tpu_pdhg") -> dict:
    """The JAX package's run of the tier's first ``rounds`` rounds under
    ``policy``."""
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
    sched = Scheduler(get_policy(policy, seed=0),
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
    pin = (bench_sim.TIER_2048_PDHG_CUT if policy == "shockwave_tpu_pdhg"
           else getattr(bench_sim, "TIER_2048_CUT", None))
    r["within_pin"] = bool(pin) and (pin["rounds"] == rounds
                                     and bench_sim.check_run(r, pin) == [])
    return r


def ref_cells_cut(rounds) -> dict:
    """The JAX package's ``scripts/simulate.py`` run of the cells tier
    (``bench_sim.TIER_2048_CELLS_ARGS``) for its first ``rounds`` rounds:
    the CLI itself, its ``Scheduler.simulate`` told to stop there."""
    import functools
    import runpy

    from shockwave_tpu.core.scheduler import Scheduler as JaxScheduler

    start = time.perf_counter()
    real = JaxScheduler.simulate
    JaxScheduler.simulate = functools.partialmethod(real, max_rounds=rounds)
    argv, sys.argv = sys.argv, ["simulate.py", *bench_sim.TIER_2048_CELLS_ARGS,
                                "--no_profile_cache"]
    captured = {}
    real_init = JaxScheduler.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        captured["sched"] = self

    JaxScheduler.__init__ = init
    try:
        runpy.run_path(str(ROOT / "scripts" / "simulate.py"),
                       run_name="__main__")
    finally:
        JaxScheduler.simulate, JaxScheduler.__init__ = real, real_init
        sys.argv = argv
    sched = captured["sched"]
    ftf, _ = sched.get_finish_time_fairness()
    r = dict(makespan=sched.get_current_timestamp(),
             avg_jct=sched.get_average_jct(), worst_ftf=max(ftf),
             rounds=sched._num_completed_rounds,
             completed=sum(1 for t in sched._job_completion_times.values()
                           if t is not None),
             wall_s=time.perf_counter() - start)
    pin = getattr(bench_sim, "TIER_2048_CELLS_CUT", None)
    r["within_pin"] = bool(pin) and (pin["rounds"] == rounds
                                     and bench_sim.check_run(r, pin) == [])
    return r


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    pin = getattr(bench_sim, "TIER_2048_PDHG_CUT", None)
    parser.add_argument("--rounds", type=int, nargs="+",
                        default=[pin["rounds"]] if pin else [160])
    parser.add_argument("--cells", action="store_true",
                        help="the cells tier's cut (bench_sim."
                        "TIER_2048_CELLS_CUT), not the pdhg tier's")
    parser.add_argument("--policy", default="shockwave_tpu_pdhg",
                        help="shockwave_tpu: phase 8's tier "
                        "(bench_sim.TIER_2048_CUT)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    rows = []
    for rounds in args.rounds:
        r = (ref_cells_cut(rounds) if args.cells
             else ref_cut(rounds, args.policy))
        print(json.dumps(r), flush=True)
        rows.append(r)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
