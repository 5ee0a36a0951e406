"""Figure-9 runner of the port: the scale experiment.

    python -m shockwave_tpu_torch.tools.scale_experiments   # into results/scale_torch
    python -m shockwave_tpu_torch.tools.scale_experiments --device cpu \\
        --policies max_min_fairness --num_gpus 64

The counterpart of the JAX package's
``scripts/replicate/scale_experiments.py`` (``run_cell`` and ``main``):
the 220-job dynamic trace (``traces/generated_220_dynamic.trace``) on
{64, 128, 256}-GPU clusters of 4 GPUs a server with 120 s rounds, under
``max_min_fairness``, ``shockwave`` (the exact MILP on the host) and
``shockwave_tpu``, the Shockwave policies with the replication's planner
config. Gavel's policies and the MILP solve on the host; the Shockwave
planner's device solves run on ``--device`` (default ``cuda``, which
raises without a card). Each cell writes a
result pickle (makespan, average JCT, worst FTF, unfair fraction,
utilization, rounds, wall seconds, and the allocation calls and their
seconds) and the sweep one merged ``summary.json`` of its own cells. A
cell's pickle is reused without ``--force`` only when it was run on the
same trace, round, seed and server size. A ``shockwave`` cell also
records its MILP solves by HiGHS status (``milp_statuses``): a solve
that stopped at its time limit makes the cell depend on the wall clock.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

from shockwave_tpu_torch.tools.bench_sim import TRACES, run_trace

TRACE = TRACES / "generated_220_dynamic.trace"
DEFAULT_POLICIES = ["max_min_fairness", "shockwave", "shockwave_tpu"]
DEFAULT_SIZES = [64, 128, 256]
GPUS_PER_SERVER = 4

# The replication configs' planner settings (the JAX package's
# scripts/replicate/scale_experiments.py:55-63; the solver_* keys belong
# to the MILP backend, which the other backends ignore, and HiGHS takes
# no thread count).
SHOCKWAVE_CONFIG = {
    "future_rounds": 20,
    "lambda": 5.0,
    "k": 10.0,
    "log_approximation_bases": [0.0, 0.2, 0.4, 0.6, 0.8, 1.0],
    "solver_rel_gap": 1e-3,
    "solver_num_threads": 24,
    "solver_timeout": 15,
}

SUMMARY_KEYS = ("policy", "num_gpus", "makespan", "avg_jct", "worst_ftf",
                "unfair_fraction", "utilization", "rounds",
                "sim_wall_clock_s", "allocations", "allocation_s")


def run_cell(trace_file, policy_name: str, num_gpus: int,
             round_duration: float = 120.0, seed: int = 0,
             gpus_per_server: int = GPUS_PER_SERVER, device="cuda") -> dict:
    """One cell: ``trace_file`` on ``num_gpus`` v100s under
    ``policy_name``."""
    config = SHOCKWAVE_CONFIG if policy_name.startswith("shockwave") else None
    r = run_trace(trace_file, policy_name, num_gpus, device, config=config,
                  gpus_per_server=gpus_per_server,
                  round_s=round_duration, seed=seed)
    return {
        "trace_file": str(trace_file),
        "policy": policy_name,
        "num_gpus": str(num_gpus),
        "round_duration": float(round_duration),
        "seed": seed,
        "gpus_per_server": gpus_per_server,
        "makespan": r["makespan"],
        "avg_jct": r["avg_jct"],
        "worst_ftf": r["worst_ftf"],
        "unfair_fraction": r["unfair_fraction"],
        "utilization": r["utilization"],
        "rounds": r["rounds"],
        "sim_wall_clock_s": r["wall_s"],
        "allocations": r["allocations"],
        "allocation_s": r["allocation_s"],
        "solves": r["solves"],
        "milp_statuses": r["milp_statuses"],
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Figure-9 scale experiments")
    parser.add_argument("--trace_file", type=str, default=str(TRACE))
    parser.add_argument("--out", type=str, default="results/scale_torch")
    parser.add_argument("--policies", type=str, nargs="+",
                        default=DEFAULT_POLICIES)
    parser.add_argument("--num_gpus", type=int, nargs="+",
                        default=DEFAULT_SIZES)
    parser.add_argument("--time_per_iteration", type=int, default=120)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gpus_per_server", type=int,
                        default=GPUS_PER_SERVER)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the Shockwave planner's device solves "
                        "run: cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    from shockwave_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    setting = {"trace_file": args.trace_file,
               "round_duration": float(args.time_per_iteration),
               "seed": args.seed, "gpus_per_server": args.gpus_per_server}
    summary = {}
    for policy_name in args.policies:
        for num_gpus in args.num_gpus:
            name = f"{policy_name}_{num_gpus}gpus"
            out_pickle = os.path.join(args.out, name + ".pickle")
            if os.path.exists(out_pickle) and not args.force:
                with open(out_pickle, "rb") as f:
                    cached = pickle.load(f)
                if all(cached.get(k) == v for k, v in setting.items()):
                    print(f"[skip] {name} (exists)")
                    summary[name] = {k: cached[k] for k in SUMMARY_KEYS}
                    continue
            print(f"[run ] {name} on {os.path.basename(args.trace_file)}")
            result = run_cell(args.trace_file, policy_name, num_gpus,
                              args.time_per_iteration, args.seed,
                              args.gpus_per_server, device=device)
            with open(out_pickle, "wb") as f:
                pickle.dump(result, f)
            summary[name] = {k: result[k] for k in SUMMARY_KEYS}
            print(f"[done] {name}: makespan={result['makespan']:.3f}s "
                  f"avg_jct={result['avg_jct']:.3f}s "
                  f"worst_ftf={result['worst_ftf']:.3f} "
                  f"unfair={result['unfair_fraction']:.1f}% "
                  f"(sim {result['sim_wall_clock_s']:.1f} s, "
                  f"{result['allocations']} allocations in "
                  f"{result['allocation_s']:.2f} s"
                  + (f"; MILP solves by HiGHS status "
                     f"{result['milp_statuses']}"
                     if result["milp_statuses"] else "") + ")")

    out = {"trace": os.path.basename(args.trace_file), "results": summary}
    summary_path = os.path.join(args.out, "summary.json")
    with open(summary_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"Wrote {summary_path} ({len(summary)} cells)")
    return out


if __name__ == "__main__":
    main()
