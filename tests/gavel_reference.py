"""The JAX package's runs of the Gavel cells the port is held to.

    python tests/gavel_reference.py [--only gavel|library] [--figure9-milp]
        [--out FILE]

Runs the JAX package's scheduler under Gavel's policies and the exact
MILP (its Gavel half, its LP policies, Gandiva, AlloX and the MILP import
no JAX, so this runs where JAX is absent) on every cell that
``shockwave_tpu_torch/tools/bench_sim.py`` pins for the Gavel round path
(``GOLDEN_GAVEL``, the Gavel cells of ``FIGURE9``, ``TIER_2048_MMF``,
``HETERO``) and for the rest of the policy library (``GOLDEN_LIBRARY``,
``ALLOX_SINGLE``, ``GOLDEN_SLO``, ``PACKED_220``), as the port's
``bench_sim.run_trace`` drives them, and prints one JSON object: scipy's
version and each cell's makespan, average JCT, worst FTF, unfair
fraction, rounds, SLO violations and MILP solves by HiGHS status, with
whether the cell is within ``bench_sim.TOLERANCE`` of its pin under this
scipy (``bench_sim.pinned``). ``--only`` keeps one of the two sets;
``--figure9-milp`` also runs Figure 9's three ``shockwave`` cells (the
220-job trace at 64, 128 and 256 GPUs under the sweep's planner config,
about a minute each), which are reported and not pinned. The pins are these runs under scipy
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

import shockwave_tpu.solver.eg_milp as ref_milp  # noqa: E402
from shockwave_tpu.core.scheduler import Scheduler  # noqa: E402
from shockwave_tpu.data import (  # noqa: E402
    load_or_synthesize_profiles,
    parse_trace,
)
from shockwave_tpu.data.default_oracle import generate_oracle  # noqa: E402
from shockwave_tpu.policies import get_policy  # noqa: E402
from shockwave_tpu_torch.tools import bench_sim  # noqa: E402
from shockwave_tpu_torch.tools import scale_experiments  # noqa: E402


class MilpStatuses:
    """Counts the HiGHS statuses of the JAX package's MILP calls while it
    is entered (wrapping ``scipy.optimize.milp`` as its module sees it)."""

    def __enter__(self):
        self.counts = {}
        self._milp = ref_milp.milp

        def counted(*args, **kwargs):
            res = self._milp(*args, **kwargs)
            self.counts[int(res.status)] = (
                self.counts.get(int(res.status), 0) + 1)
            return res

        ref_milp.milp = counted
        return self

    def __exit__(self, *exc):
        ref_milp.milp = self._milp
        return False


def ref_run(trace, policy: str, num_gpus: int, cluster: dict = None,
            gpus_per_server: int = None, config: dict = None,
            scale_factor: int = None, slo: float = None) -> dict:
    """The JAX package's run of ``trace`` as ``bench_sim.run_trace`` drives
    the port's (120 s rounds, seed 0; the same arguments)."""
    start = time.perf_counter()
    cluster = cluster or {"v100": num_gpus}
    jobs, arrivals = parse_trace(str(trace))
    if scale_factor is not None:
        kept = [(j, a) for j, a in zip(jobs, arrivals)
                if j.scale_factor == scale_factor]
        jobs, arrivals = [j for j, _ in kept], [a for _, a in kept]
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(trace), jobs, oracle, worker_type=next(iter(cluster)),
        cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
        if slo is not None:
            job.SLO = slo
    if policy.startswith("shockwave"):
        config = {"num_gpus": num_gpus,
                  "time_per_iteration": bench_sim.ROUND_S,
                  "future_rounds": 20, "lambda": 5.0, "k": 10.0,
                  **(config or {})}
    sched = Scheduler(get_policy(policy, seed=0), throughputs=oracle, seed=0,
                      time_per_iteration=bench_sim.ROUND_S,
                      profiles=profiles, shockwave_config=config)
    per_server = None
    if gpus_per_server is not None:
        per_server = {wt: gpus_per_server for wt in cluster}
    with MilpStatuses() as milp:
        makespan = sched.simulate(dict(cluster), arrivals, jobs,
                                  num_gpus_per_server=per_server)
    ftf, unfair = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), unfair_fraction=unfair,
                rounds=sched._num_completed_rounds,
                slo_violations=sched.get_num_SLO_violations(),
                milp_statuses=milp.counts,
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


def figure9_milp_cells() -> list:
    """Figure 9's ``shockwave`` cells, as the sweep runs them."""
    return [("FIGURE9_MILP", ("shockwave", gpus),
             (bench_sim.TRACE_220, "shockwave", gpus),
             {"gpus_per_server": 4,
              "config": scale_experiments.SHOCKWAVE_CONFIG})
            for gpus in scale_experiments.DEFAULT_SIZES]


def main(argv=None) -> dict:
    import scipy

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--only", choices=("gavel", "library"), default=None)
    parser.add_argument("--figure9-milp", action="store_true")
    args = parser.parse_args(argv)
    cells = []
    if args.only != "library":
        cells += gavel_cells()
    if args.only != "gavel":
        cells += bench_sim.library_runs()
    if args.figure9_milp:
        cells += figure9_milp_cells()
    rows = []
    for table, key, run_args, kwargs in cells:
        r = ref_run(*run_args, **kwargs)
        r.update(table=table, key=key)
        if table != "FIGURE9_MILP":
            pin = bench_sim.pinned(table, key, scipy.__version__)
            r["within_pin"] = bench_sim.check_run(r, pin) == []
        print(json.dumps(r), flush=True)
        rows.append(r)
    out = {"scipy": scipy.__version__, "cells": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
