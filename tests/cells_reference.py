"""Capture every coordinated replan of a cells-market run, in either
package, and find where two captures part.

    python tests/cells_reference.py capture --package jax --out jax.json
    python tests/cells_reference.py capture --package port --device cuda \\
        --out card.json
    python tests/cells_reference.py compare jax.json card.json

``capture`` runs the 2048-job trace on 256 GPUs, 120 s rounds, under
``shockwave_tpu_pdhg`` with ``--cells 4`` (``--trace``, ``--gpus`` and
``--cells`` change it) through the JAX package's scheduler (``--package
jax``, on the CPU) or the port's (``--package port`` on ``--device``; it
imports nothing of JAX, so it runs on the card's machine). It writes, in
order, each batched solve's lanes (``s`` and the objective of each
lane) and each replan's decisions (the cells' capacities, prices and
spares, the stale cells' job ids, round counts and plans), then prints
the run's metrics. ``compare`` walks two captures side by side and
prints the first replan whose decisions differ, and every lane before it
whose ``s`` differs by more than 5e-3 (the two-orders limit of
``tests/test_torch_pdhg.py``) with its objectives' relative difference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

S_TOL = 5e-3
DECISIONS = ("round", "cells", "plans", "counts", "ids")


def capture(package: str, trace: str, gpus: int, cells: int,
            device: str = "cpu") -> dict:
    """One run's metrics and its replans' capture (module docstring)."""
    if package == "jax":
        from shockwave_tpu.cells import batched, planner
        from shockwave_tpu.core.scheduler import Scheduler
        from shockwave_tpu.data import load_or_synthesize_profiles, parse_trace
        from shockwave_tpu.data.default_oracle import generate_oracle
        from shockwave_tpu.policies import get_policy
    else:
        from shockwave_tpu_torch.cells import batched, planner
        from shockwave_tpu_torch.core.scheduler import Scheduler
        from shockwave_tpu_torch.data import (load_or_synthesize_profiles,
                                              parse_trace)
        from shockwave_tpu_torch.data.default_oracle import generate_oracle
        from shockwave_tpu_torch.policies import get_policy as port_policy

        def get_policy(name):
            return port_policy(name, device=device)

    log = []
    write = planner.CellPlanner._write_schedules
    solve = batched.solve_cells_pdhg

    def writing(self, built, solved):
        write(self, built, solved)
        log.append({
            "round": self.round_index, "cells": dict(self.cells),
            "prices": {n: float(p) for n, p in self.prices.items()},
            "spares": dict(self.spares),
            "plans": {n: [str(j) for j in self.children[n].schedules.get(
                self.round_index, [])] for n in solved},
            "counts": {n: [int(x) for x in solved[n]["Y"].sum(axis=1)]
                       for n in solved},
            "ids": {n: [str(j) for j in built[n][1]] for n in solved}})

    def solving(problems, s0s=None, **kwargs):
        s, objs, diags = solve(problems, s0s, **kwargs)
        log.append({"lanes": [[float(x) for x in lane] for lane in s],
                    "objs": [float(o) for o in objs]})
        return s, objs, diags

    planner.CellPlanner._write_schedules = writing
    batched.solve_cells_pdhg = solving
    try:
        jobs, arrivals = parse_trace(trace)
        oracle = generate_oracle()
        profiles = load_or_synthesize_profiles(trace, jobs, oracle,
                                               worker_type="v100",
                                               cache=False)
        for i, job in enumerate(jobs):
            job.duration = sum(profiles[i]["duration_every_epoch"])
        sched = Scheduler(
            get_policy("shockwave_tpu_pdhg"), throughputs=oracle, seed=0,
            time_per_iteration=120.0, profiles=profiles,
            shockwave_config={"num_gpus": gpus, "time_per_iteration": 120.0,
                              "future_rounds": 20, "lambda": 5.0, "k": 10.0,
                              "cells": cells})
        makespan = sched.simulate({"v100": gpus}, arrivals, jobs)
    finally:
        planner.CellPlanner._write_schedules = write
        batched.solve_cells_pdhg = solve
    ftf, _ = sched.get_finish_time_fairness()
    return {"package": package, "device": device,
            "metrics": {"makespan": makespan,
                        "avg_jct": sched.get_average_jct(),
                        "worst_ftf": max(ftf),
                        "rounds": sched._num_completed_rounds},
            "log": log}


def compare(a: dict, b: dict) -> dict:
    """The first replan whose decisions differ between two captures, the
    replans before it, and the lanes before it past S_TOL."""
    first, replans, lanes = None, 0, []
    for i, (x, y) in enumerate(zip(a["log"], b["log"])):
        if "lanes" in x:
            for k, (sx, sy) in enumerate(zip(x["lanes"], y["lanes"])):
                sx, sy = np.asarray(sx), np.asarray(sy)
                if sx.shape != sy.shape or not sx.size:
                    continue
                ds = float(np.abs(sx - sy).max())
                if ds > S_TOL:
                    rel = abs(x["objs"][k] - y["objs"][k]) / (
                        1.0 + abs(x["objs"][k]))
                    lanes.append({"entry": i, "lane": k, "jobs": sx.size,
                                  "max_ds": ds, "objective_rel": rel})
            continue
        if "round" not in y or any(x[key] != y[key] for key in DECISIONS):
            first = {"entry": i, "round": x["round"],
                     "differ": [key for key in DECISIONS[1:]
                                if x[key] != y.get(key)]}
            break
        replans += 1
    return {"first_difference": first, "replans_equal": replans,
            "lanes_past_s_tol": lanes,
            "lanes_compared": sum(len(x["lanes"]) for x in a["log"][
                :first["entry"] if first else None] if "lanes" in x),
            "metrics": [a["metrics"], b["metrics"]]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("capture")
    p.add_argument("--package", choices=("jax", "port"), required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--trace", default=str(
        ROOT / "traces" / "generated_2048_dynamic.trace"))
    p.add_argument("--gpus", type=int, default=256)
    p.add_argument("--cells", type=int, default=4)
    p.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = parser.parse_args(argv)
    if args.cmd == "capture":
        result = capture(args.package, args.trace, args.gpus, args.cells,
                         args.device)
        with open(args.out, "w") as f:
            json.dump(result, f)
        print(json.dumps({k: result[k] for k in ("package", "device",
                                                 "metrics")}))
        return
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    print(json.dumps(compare(a, b), indent=1))


if __name__ == "__main__":
    main()
