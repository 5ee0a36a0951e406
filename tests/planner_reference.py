"""The JAX package's runs of the planner cells the port is held to.

    python tests/planner_reference.py [--out FILE]

Runs the JAX package's scheduler, on the CPU, on every cell that
``shockwave_tpu_torch/tools/bench_sim.py`` pins for the rest of the
Shockwave planner (``PLANNER``, ``PLANNER_CELLS``; ``planner_runs``):
simulator checkpoints (the unbroken run, the run that saves, the run
resumed from the file), plan-ahead speculation (with its hit / repair /
miss counts), per-worker-type pool sets, and the level backend with the
native greedy unavailable, so that the greedy fallback runs. Each cell
is driven as the port's ``bench_sim.run_trace`` drives it (the same
arguments) and printed as one JSON line with whether it is within
``bench_sim.TOLERANCE`` of its pin; the last line is one JSON object of
them all. None of these runs calls scipy's HiGHS, so the pins hold under
any scipy.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from shockwave_tpu import native as ref_native  # noqa: E402
from shockwave_tpu.core.scheduler import Scheduler  # noqa: E402
from shockwave_tpu.data import (  # noqa: E402
    load_or_synthesize_profiles,
    parse_trace,
)
from shockwave_tpu.data.default_oracle import generate_oracle  # noqa: E402
from shockwave_tpu.policies import get_policy  # noqa: E402
from shockwave_tpu_torch.tools import bench_sim  # noqa: E402


@contextlib.contextmanager
def native_unavailable():
    """The JAX package's native greedy reported unavailable (no C++
    compiler), so its greedy fallback is the jitted greedy."""
    available = ref_native.available
    ref_native.available = lambda: False
    try:
        yield
    finally:
        ref_native.available = available


def ref_run(trace, policy: str, num_gpus: int, cluster: dict = None,
            gpus_per_server: int = None, config: dict = None,
            checkpoint_threshold: int = None, checkpoint_file: str = None,
            no_native: bool = False) -> dict:
    """The JAX package's run of ``trace`` as ``bench_sim.run_trace`` drives
    the port's (120 s rounds, seed 0; the same arguments)."""
    start = time.perf_counter()
    cluster = cluster or {"v100": num_gpus}
    jobs, arrivals = parse_trace(str(trace))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(trace), jobs, oracle, worker_type=next(iter(cluster)),
        cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = {"num_gpus": num_gpus, "time_per_iteration": bench_sim.ROUND_S,
              "future_rounds": 20, "lambda": 5.0, "k": 10.0,
              **(config or {})}
    sched = Scheduler(get_policy(policy, seed=0), throughputs=oracle, seed=0,
                      time_per_iteration=bench_sim.ROUND_S,
                      profiles=profiles, shockwave_config=config)
    per_server = None
    if gpus_per_server is not None:
        per_server = {wt: gpus_per_server for wt in cluster}
    with native_unavailable() if no_native else contextlib.nullcontext():
        makespan = sched.simulate(
            dict(cluster), arrivals, jobs, num_gpus_per_server=per_server,
            checkpoint_threshold=checkpoint_threshold,
            checkpoint_file=checkpoint_file)
    ftf, unfair = sched.get_finish_time_fairness()
    solves: dict = {}
    for record in sched._shockwave.solve_records:
        key = record["backend"]
        if "pool" in record:
            key = f"{record['pool']}:{key}"
        solves[key] = solves.get(key, 0) + 1
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), unfair_fraction=unfair,
                rounds=sched._num_completed_rounds, solves=solves,
                spec_stats=getattr(sched._shockwave, "spec_stats", None),
                wall_s=time.perf_counter() - start)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for key, run_args, kwargs in bench_sim.planner_runs():
            kwargs = dict(kwargs)
            if "checkpoint_file" in kwargs:
                kwargs["checkpoint_file"] = str(
                    Path(tmp) / kwargs["checkpoint_file"])
            r = ref_run(*run_args, **kwargs)
            r["key"] = key
            pin = bench_sim.PLANNER[key]
            r["within_pin"] = (pin is not None
                               and bench_sim.check_run(r, pin) == [])
            print(json.dumps(r), flush=True)
            rows.append(r)
    out = {"cells": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
