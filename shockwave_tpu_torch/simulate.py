"""Trace-driven simulation entry point of the PyTorch port.

    python -m shockwave_tpu_torch.simulate -t traces/small_12_dynamic.trace \\
        -p shockwave_tpu_level -c v100=8 --time_per_iteration 120 --device cuda
    python -m shockwave_tpu_torch.simulate -t traces/generated_220_dynamic.trace \\
        -p max_min_fairness_perf -c 16:16:16 --num_gpus_per_server 4:4:4 \\
        --time_per_iteration 120 --device cpu
    python -m shockwave_tpu_torch.simulate -t traces/small_12_dynamic.trace \\
        -p shockwave_tpu_pdhg -c v100=8 --time_per_iteration 120 --cells 2
    python -m shockwave_tpu_torch.simulate -t traces/small_12_dynamic.trace \\
        -p shockwave -c v100=8 --time_per_iteration 120 --device cpu
    python -m shockwave_tpu_torch.simulate -t traces/generated_220_dynamic.trace \\
        -p shockwave_tpu -c v100=64 --num_gpus_per_server v100=4 \\
        --time_per_iteration 120 --speculate
    python -m shockwave_tpu_torch.simulate -t traces/generated_220_dynamic.trace \\
        -p shockwave_tpu_pdhg -c v100=64 --num_gpus_per_server v100=4 \\
        --time_per_iteration 120 --checkpoint_threshold 110 \\
        --checkpoint_file run.ckpt
    python -m shockwave_tpu_torch.simulate -t traces/generated_220_dynamic.trace \\
        -p shockwave_tpu_pdhg -c v100=64 --num_gpus_per_server v100=4 \\
        --time_per_iteration 120 --fault-plan plan.json --round_log log.jsonl
    python -m shockwave_tpu_torch.simulate -t traces/small_12_dynamic.trace \\
        -p max_min_fairness_packed -c v100=8 --time_per_iteration 120 \\
        --profiling_percentage 0.5 --num_reference_models 8 --device cpu

The counterpart of the JAX package's ``scripts/simulate.py``: parses a
trace, builds the throughput oracle and epoch profiles, runs the
simulator under a Shockwave policy (``shockwave``, the exact MILP on the
host, ``shockwave_tpu``, ``shockwave_tpu_level``, ``shockwave_native``,
``shockwave_tpu_pdhg`` or ``shockwave_tpu_relaxed``; with ``--cells N``
or ``-p shockwave_tpu_cells`` the cell-decomposed market, its stale cells
one launch of kernel A) or a Gavel policy (``fifo``,
``max_min_fairness``, ``finish_time_fairness``, the packed policies,
``gandiva``, ``allox`` and the others of
``policies.get_available_policies``), and prints makespan / average JCT /
utilization / finish-time fairness (and, under ``shockwave``, the MILP's
solves by HiGHS status). ``--device`` (default ``cuda``) is
where the planner's device solves run (the level-set solve, and the
PDHG and relaxed kernels); ``cuda`` without a card raises. The MILP and
the Gavel policies solve on the host and leave the device unused. A
``plan_deadline_s`` in ``--config`` runs every solve down the
degradation ladder, and ``"hetero_pools": true`` there plans a mixed
cluster as one pool a worker type. ``--speculate`` solves each next
round ahead and reconciles it at the boundary (a churned boundary
re-solves through kernel A), and ``--checkpoint_threshold N
--checkpoint_file F`` saves the run to ``F`` once N jobs were admitted,
or resumes from ``F`` where it exists. ``--fault-plan P`` arms the fault
plan ``P`` (``runtime/faults.py``; worker crashes, reclaims, re-adds,
scheduler kills and solver faults) before the scheduler exists and
prints the injector's applied / recovered counts; ``--round_log L``
writes the run's job / round / complete records to ``L`` as JSON lines;
under a packed policy ``--profiling_percentage`` below 1 or
``--num_reference_models`` turns on online throughput estimation, its
masked ALS on ``--device``. ``--solver`` takes the one LP solver both
packages have (``scipy``). The JAX package's telemetry flags
(``obs.add_telemetry_args``) turn its planes on for the run:
``--metrics-out M`` dumps the metrics registry (with predictor
calibration) as ``shockwave-metrics-v1`` JSON, ``--trace-out T`` a
Chrome trace-event timeline in simulated time, ``--decision-log D`` the
flight recorder's JSONL log (replay it with ``python -m
shockwave_tpu_torch.obs.recorder replay D``), and ``--watchdog`` /
``--watchdog-config`` the health rules, whose summary is printed; each
run starts and ends with every plane reset. ``--metrics-port`` serves
physical mode only and is parsed and left unused here, as in the JAX
package.

    python -m shockwave_tpu_torch.simulate -t traces/small_12_dynamic.trace \\
        -p shockwave_tpu_level -c 2:0:0 --seed 0 --time_per_iteration 60 \\
        --metrics-out M.json --trace-out T.json --decision-log D.jsonl \\
        --watchdog
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data import (
    load_or_synthesize_profiles,
    parse_trace,
    read_throughputs,
)
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.policies import get_available_policies, get_policy
from shockwave_tpu_torch.utils.cluster_spec import parse_cluster_spec
from shockwave_tpu_torch.utils.device import resolve_device
from shockwave_tpu_torch.utils.fileio import read_json_arg


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # Every plane starts off, then the flags turn theirs on before the
    # scheduler exists: the tracer adopts its virtual clock and the
    # flight recorder sees the first planning round.
    obs.reset()
    obs.apply_telemetry_args(args)
    try:
        return _run(args, device)
    finally:
        obs.reset()


def _run(args, device) -> dict:
    jobs, arrival_times = parse_trace(args.trace_file)
    if args.throughputs_file:
        throughputs = read_throughputs(args.throughputs_file)
    else:
        throughputs = generate_oracle()

    cluster_spec = parse_cluster_spec(args.cluster_spec)
    if "=" in args.cluster_spec:
        if "=" not in args.num_gpus_per_server and (
            args.num_gpus_per_server != "1:1:1"
        ):
            raise SystemExit(
                "--num_gpus_per_server must use the type=count form "
                "when --cluster_spec does"
            )
        num_gpus_per_server = {wt: 1 for wt in cluster_spec}
        if "=" in args.num_gpus_per_server:
            num_gpus_per_server.update(
                parse_cluster_spec(args.num_gpus_per_server)
            )
    else:
        per_server = [int(x) for x in args.num_gpus_per_server.split(":")]
        num_gpus_per_server = {
            "v100": per_server[0], "p100": per_server[1], "k80": per_server[2]
        }

    profiles = load_or_synthesize_profiles(
        args.trace_file,
        jobs,
        throughputs,
        worker_type=next(iter(cluster_spec)),
        cache=not args.no_profile_cache,
    )
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])

    shockwave_config = None
    if args.policy.startswith("shockwave"):
        shockwave_config = {}
        if args.config:
            with open(args.config) as f:
                shockwave_config = json.load(f)
        shockwave_config.setdefault("future_rounds", 20)
        shockwave_config.setdefault("lambda", 5.0)
        shockwave_config.setdefault("k", 10.0)
        shockwave_config.setdefault(
            "log_approximation_bases", [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
        )
        # The MILP's settings (the planner's own defaults), set as the JAX
        # package's CLI sets them, so recorded planner states are equal.
        shockwave_config.setdefault("solver_rel_gap", 1e-3)
        shockwave_config.setdefault("solver_num_threads", 24)
        shockwave_config.setdefault("solver_timeout", 15)
        shockwave_config["time_per_iteration"] = args.time_per_iteration
        # Homogeneous planning capacity: the v100 pool in the reference
        # vocabulary, else the whole (named-type) cluster.
        shockwave_config["num_gpus"] = cluster_spec.get(
            "v100", sum(cluster_spec.values())
        )
        if args.cells:
            # Cell-decomposed market: the fleet in N cells, stale cells
            # solved as one launch of kernel A (shockwave_tpu_torch/cells/).
            shockwave_config["cells"] = int(args.cells)
        if args.speculate:
            # Plan-ahead pipelining (policies/speculation.py).
            shockwave_config["speculate"] = True

    preemption_overheads = None
    if args.preemption_overheads:
        preemption_overheads = read_json_arg(
            args.preemption_overheads, "--preemption_overheads")

    # Fault injection: the plan is armed before the scheduler exists, so
    # the first round already sees the injector.
    fault_injector = None
    if args.fault_plan:
        from shockwave_tpu_torch.runtime import faults

        fault_injector = faults.configure(args.fault_plan)

    policy = get_policy(args.policy, device=device, seed=args.seed)
    sched = Scheduler(
        policy,
        simulate=True,
        throughputs=throughputs,
        seed=args.seed if args.seed is not None else 0,
        time_per_iteration=args.time_per_iteration,
        profiles=profiles,
        shockwave_config=shockwave_config,
        preemption_overheads=preemption_overheads,
        round_overhead_fraction=args.round_overhead_fraction,
        profiling_percentage=args.profiling_percentage,
        num_reference_models=args.num_reference_models,
        device=device,
    )

    jobs_to_complete = None
    if args.window_start is not None and args.window_end is not None:
        from shockwave_tpu_torch.core.ids import JobId

        jobs_to_complete = {
            JobId(i) for i in range(args.window_start, args.window_end)
        }

    start = time.time()
    makespan = sched.simulate(
        cluster_spec,
        arrival_times,
        jobs,
        num_gpus_per_server=num_gpus_per_server,
        jobs_to_complete=jobs_to_complete,
        checkpoint_threshold=args.checkpoint_threshold,
        checkpoint_file=args.checkpoint_file,
        max_rounds=args.max_rounds,
    )
    wall = time.time() - start

    avg_jct = sched.get_average_jct(jobs_to_complete)
    utilization = sched.get_cluster_utilization()
    ftf_list, unfair_fraction = sched.get_finish_time_fairness()
    backends: dict = {}
    if sched._shockwave is not None:
        for record in sched._shockwave.solve_records:
            backends[record["backend"]] = backends.get(record["backend"], 0) + 1
        print(f"Policy: {args.policy} (device solves on {device})")
    else:
        print(f"Policy: {args.policy} (allocations on the host)")
    print(f"Makespan: {makespan:.3f} s ({makespan / 3600.0:.2f} h)")
    if avg_jct is not None:
        print(f"Average JCT: {avg_jct:.3f} s ({avg_jct / 3600.0:.2f} h)")
    if utilization is not None:
        print(f"Cluster utilization: {utilization:.3f}")
    if ftf_list:
        print(f"Worst FTF: {max(ftf_list):.3f}")
        print(f"Unfair job fraction: {unfair_fraction:.1f}%")
    print(f"Preemptions: {sched.get_num_preemptions()}")
    faults_summary = None
    if fault_injector is not None:
        faults_summary = fault_injector.summary()
        print(
            f"Faults: {faults_summary['applied']} applied, "
            f"{faults_summary['recovered']} recovered, "
            f"{len(faults_summary['unrecovered'])} unrecovered"
        )
    if sched._time_per_iteration != args.time_per_iteration:
        print(
            f"Round auto-sized: {args.time_per_iteration} s -> "
            f"{sched._time_per_iteration:.0f} s"
        )
    milp_statuses: dict = {}
    for status in getattr(sched._shockwave, "milp_statuses", ()):
        milp_statuses[status] = milp_statuses.get(status, 0) + 1
    spec_stats = getattr(sched._shockwave, "spec_stats", None)
    exposed_s = sum(getattr(sched._shockwave, "exposed_plan_times", ()))
    if sched._shockwave is not None:
        print(f"Rounds: {sched._num_completed_rounds}; solves by backend: "
              f"{backends}; sim wall-clock: {wall:.1f} s")
        if args.speculate:
            print(f"Speculation: {spec_stats}; exposed planning "
                  f"{exposed_s:.3f} s")
        if milp_statuses:
            print(f"MILP solves by HiGHS status (0 optimal within the gap, "
                  f"1 time limit): {milp_statuses}")
    else:
        print(f"Rounds: {sched._num_completed_rounds}; allocations: "
              f"{sched.num_allocations} taking {sched.allocation_s:.2f} s; "
              f"sim wall-clock: {wall:.1f} s")

    if args.round_log:
        os.makedirs(os.path.dirname(args.round_log) or ".", exist_ok=True)
        sched.save_round_log(args.round_log)
        print(f"Wrote {args.round_log}")

    obs.export_run_summary(
        metrics_out=args.metrics_out,
        trace_out=args.trace_out,
        makespan=makespan,
        avg_jct=avg_jct,
        utilization=utilization,
        ftf_list=ftf_list,
        unfair_fraction=unfair_fraction,
    )

    result = {
        "trace_file": args.trace_file,
        "policy": args.policy,
        "device": str(device),
        "num_gpus": str(cluster_spec.get("v100", sum(cluster_spec.values()))),
        "makespan": makespan,
        "avg_jct": avg_jct,
        "utilization": utilization,
        "worst_ftf": max(ftf_list) if ftf_list else None,
        "unfair_fraction": unfair_fraction,
        "num_preemptions": sched.get_num_preemptions(),
        "rounds": sched._num_completed_rounds,
        "solves": backends,
        "spec_stats": spec_stats if args.speculate else None,
        "exposed_plan_s": exposed_s,
        "milp_statuses": milp_statuses,
        "allocations": sched.num_allocations,
        "allocation_s": sched.allocation_s,
        "wall_s": wall,
        "effective_round_s": sched._time_per_iteration,
        "faults": faults_summary,
    }
    if args.output_pickle:
        os.makedirs(os.path.dirname(args.output_pickle) or ".", exist_ok=True)
        with open(args.output_pickle, "wb") as f:
            pickle.dump(result, f)
        print(f"Wrote {args.output_pickle}")
    return result


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run the simulator on a trace")
    parser.add_argument("-t", "--trace_file", type=str, required=True)
    parser.add_argument(
        "-p", "--policy", type=str, default="shockwave_tpu",
        choices=get_available_policies(),
    )
    parser.add_argument(
        "--throughputs_file",
        type=str,
        default=None,
        help="Oracle JSON; defaults to the built-in synthetic oracle",
    )
    parser.add_argument("-c", "--cluster_spec", type=str, default="25:0:0")
    parser.add_argument("--num_gpus_per_server", type=str, default="1:1:1")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--solver", type=str, choices=["scipy"], default="scipy",
        help="the Gavel policies' LP solver (scipy's HiGHS, the one both "
        "packages have)",
    )
    parser.add_argument("--time_per_iteration", type=int, default=360)
    parser.add_argument("-s", "--window-start", type=int, default=None)
    parser.add_argument("-e", "--window-end", type=int, default=None)
    parser.add_argument("--config", type=str, default=None,
                        help="Shockwave JSON config")
    parser.add_argument(
        "--cells", type=int, default=0,
        help="partition the Shockwave fleet into N cells (cell-decomposed "
        "market; 0 or 1 = one global solve)",
    )
    parser.add_argument(
        "--speculate", action="store_true",
        help="plan-ahead pipelining: solve round r+1 while round r runs "
        "and reconcile at the boundary (Shockwave policies)",
    )
    parser.add_argument(
        "--checkpoint_threshold", type=int, default=None,
        help="save a simulator checkpoint once this many jobs were admitted",
    )
    parser.add_argument(
        "--checkpoint_file", type=str, default=None,
        help="checkpoint path; the run resumes from it if it exists",
    )
    parser.add_argument("--output_pickle", type=str, default=None)
    parser.add_argument(
        "--round_log", type=str, default=None,
        help="write the structured per-round event log (JSONL) here; "
        "scripts/analysis/postprocess_log.py reads it",
    )
    parser.add_argument(
        "--fault-plan", "--fault_plan", dest="fault_plan", type=str,
        default=None,
        help="arm fault injection from this JSON fault plan "
        "(shockwave_tpu_torch/runtime/faults.py)",
    )
    parser.add_argument(
        "--profiling_percentage", type=float, default=1.0,
        help="fraction of colocations profiled for new jobs; below 1 turns "
        "on online throughput estimation (packed policies only)",
    )
    parser.add_argument(
        "--num_reference_models", type=int, default=None,
        help="size of the reference-model set for throughput estimation",
    )
    parser.add_argument("--no_profile_cache", action="store_true")
    parser.add_argument(
        "--max_rounds", type=int, default=None,
        help="end the run after this many rounds (its metrics cover the "
        "jobs completed by then)")
    parser.add_argument(
        "--preemption_overheads",
        type=str,
        default=None,
        help="measured relaunch overhead feeding the planner's "
        "switching-cost term: a JSON literal (scalar seconds or "
        '{"family": seconds}) or a path to a JSON file holding one',
    )
    parser.add_argument(
        "--round_overhead_fraction",
        type=float,
        default=None,
        help="auto-size the round so the worst relaunch overhead costs "
        "at most this fraction of it (never shrinks the round)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="where the planner's device solves run: cuda (default; "
        "raises without a card) or cpu",
    )
    # The JAX package's observability flags; --metrics-port serves
    # physical mode only and is left unused here, as there.
    obs.add_telemetry_args(parser)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
