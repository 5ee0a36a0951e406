"""The JAX package's runs of the Gavel cells the port is held to.

    python tests/gavel_reference.py [--out FILE]

Runs the JAX package's scheduler under Gavel's policies (its Gavel half
and its LP policies import no JAX, so this runs where JAX is absent) on
every cell that ``shockwave_tpu_torch/tools/bench_sim.py`` pins for the
Gavel round path (``GOLDEN_GAVEL``, the Gavel cells of ``FIGURE9``,
``TIER_2048_MMF``, ``HETERO``), as the port's ``bench_sim.run_trace``
drives them, and prints one JSON object: scipy's version and each cell's
makespan, average JCT, worst FTF, unfair fraction and rounds, with
whether the cell is within ``bench_sim.TOLERANCE`` of its pin under this
scipy (``bench_sim.pinned``). The pins are these runs under scipy
1.17.0; where another scipy's HiGHS returns another vertex of a
degenerate LP, this script gives the JAX package's numbers under that
scipy, which ``bench_sim.SCIPY_PINS`` records.
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


def ref_run(trace, policy: str, num_gpus: int, cluster: dict = None,
            gpus_per_server: int = None) -> dict:
    """The JAX package's run of ``trace`` as ``bench_sim.run_trace`` drives
    the port's (120 s rounds, seed 0)."""
    start = time.perf_counter()
    cluster = cluster or {"v100": num_gpus}
    jobs, arrivals = parse_trace(str(trace))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(trace), jobs, oracle, worker_type=next(iter(cluster)),
        cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    sched = Scheduler(get_policy(policy, seed=0), throughputs=oracle, seed=0,
                      time_per_iteration=bench_sim.ROUND_S,
                      profiles=profiles)
    per_server = None
    if gpus_per_server is not None:
        per_server = {wt: gpus_per_server for wt in cluster}
    makespan = sched.simulate(dict(cluster), arrivals, jobs,
                              num_gpus_per_server=per_server)
    ftf, unfair = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), unfair_fraction=unfair,
                rounds=sched._num_completed_rounds,
                wall_s=time.perf_counter() - start)


def gavel_cells() -> list:
    """(table, key, run arguments, keyword arguments) of every pinned
    Gavel cell; ``ref_run`` and ``bench_sim.run_trace`` take both."""
    cells = [("GOLDEN_GAVEL", policy, (bench_sim.GOLDEN_TRACE, policy, 8), {})
             for policy in bench_sim.GOLDEN_GAVEL]
    cells += [("FIGURE9", (policy, gpus), (bench_sim.TRACE_220, policy, gpus),
               {"gpus_per_server": 4})
              for policy, gpus in bench_sim.FIGURE9
              if not policy.startswith("shockwave")]
    cells.append(("TIER_2048_MMF", None,
                  (bench_sim.TRACE_2048, "max_min_fairness", 256), {}))
    cells += [("HETERO", policy, (bench_sim.TRACE_220, policy, 16),
               {"cluster": bench_sim.HETERO_CLUSTER, "gpus_per_server": 4})
              for policy in bench_sim.HETERO]
    return cells


def main(argv=None) -> dict:
    import scipy

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    rows = []
    for table, key, run_args, kwargs in gavel_cells():
        r = ref_run(*run_args, **kwargs)
        pin = bench_sim.pinned(table, key, scipy.__version__)
        r.update(table=table, key=key,
                 within_pin=bench_sim.check_run(r, pin) == [])
        print(json.dumps(r), flush=True)
        rows.append(r)
    out = {"scipy": scipy.__version__, "cells": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
