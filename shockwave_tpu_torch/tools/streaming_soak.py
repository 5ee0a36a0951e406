"""Streaming-admission soak: a seeded arrival, churn and reclaim campaign
through the admission front door, with the serving contract held.

    python -m shockwave_tpu_torch.tools.streaming_soak          # the campaign, on the card
    python -m shockwave_tpu_torch.tools.streaming_soak --smoke --device cpu

The port's counterpart of the JAX package's ``scripts/streaming_soak.py``
(``--smoke`` is ``scripts/ci/churn_smoke.py``'s reduced campaign: 14 jobs
on 4 GPUs, 80 target events, seed 0). A Poisson and burst arrival campaign
(:func:`runtime.faults.generate_arrival_campaign`) goes through the
bounded, token-deduplicated, backpressured admission queue (the
:class:`runtime.admission.StreamingSubmitter` path that SubmitJobs
models), composed with a :func:`runtime.faults.generate_streaming_plan`
campaign (worker crashes, spot reclamations, churn re-adds, solver faults)
and injected SubmitJobs faults (lost responses and pre-send errors, so
retried submissions go through the token ledger). It holds:

- no lost job and no double admission: every submitted job is admitted
  once (the token ledger) and completes despite the churn;
- backpressure engages (at least one rejected batch in the bursts) and
  drains (final queue depth 0);
- the p99 replan latency stays under the round budget;
- the flight recorder's decision log replays every plan exactly;
- the applied faults and the admission records reach ``--min_events``.

The planner's solves (kernel A under ``shockwave_tpu_pdhg``), the
admission pricer's (``--price_admission``) and the replays run on
``--device`` (default ``cuda``). Writes ``<result_name>`` with its fault
plan and decision log under ``--out``; exits 1 on any violated invariant.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.profiles import synthesize_profiles
from shockwave_tpu_torch.data.workload_info import steps_per_epoch
from shockwave_tpu_torch.obs.recorder import replay_log, summarize_log
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.runtime.admission import StreamingSubmitter
from shockwave_tpu_torch.utils.fileio import atomic_write_json, atomic_write_text

MODELS = [("ResNet-18", 32), ("ResNet-50", 64)]
# scripts/ci/churn_smoke.py's campaign.
SMOKE = {"result_name": "churn_smoke.json", "num_jobs": 14, "num_gpus": 4,
         "epochs": 2, "arrival_horizon_s": 1200.0, "bursts": 2,
         "batch_size": 4, "admission_capacity": 4, "target_churn_events": 80,
         "submit_faults": 2, "solver_faults": 2, "min_events": 80, "seed": 0}
_RUN_KEYS = ("makespan_s", "worst_ftf", "unfair_fraction", "rounds",
             "preemptions")


def make_jobs(num_jobs: int, epochs: int):
    jobs = []
    for i in range(num_jobs):
        model, bs = MODELS[i % len(MODELS)]
        jobs.append(Job(
            job_type=f"{model} (batch size {bs})",
            command="python3 main.py",
            total_steps=steps_per_epoch(model, bs) * epochs,
            scale_factor=[1, 1, 2, 1][i % 4],
            mode="static",
        ))
    return jobs


def run_stream(args, arrivals, jobs, profiles, oracle,
               decision_log=None) -> dict:
    """One streaming simulation through the admission front door."""
    config = {
        "num_gpus": args.num_gpus,
        "time_per_iteration": args.round_s,
        "future_rounds": args.future_rounds,
        "lambda": 2.0,
        "k": 1e-3,
        "solver_rel_gap": 1e-3,
        "solver_timeout": 15,
        "plan_deadline_s": args.plan_deadline_s,
    }
    obs.reset()
    if decision_log is not None:
        obs.configure_recorder(decision_log)
        obs.configure_watchdog({"replan_p99": {"budget_s": args.round_s}})
    submitter = StreamingSubmitter(arrivals, jobs, batch_size=args.batch_size)
    sched = Scheduler(
        get_policy(args.policy, device=args.device),
        throughputs=oracle,
        seed=args.seed,
        time_per_iteration=args.round_s,
        profiles=profiles,
        shockwave_config=(config if args.policy.startswith("shockwave")
                          else None),
    )
    pricer = None
    if args.price_admission and args.policy.startswith("shockwave"):
        from shockwave_tpu_torch.whatif import AdmissionPricer

        # The submitter pumps on the round loop's thread, so the snapshot
        # never races a replan; before the first plan the pricer abstains.
        pricer = AdmissionPricer(
            state_provider=lambda: (
                sched._shockwave.state_dict()
                if sched._shockwave is not None and sched._shockwave.num_jobs
                else None),
            threshold=args.price_threshold,
            budget_s=args.price_budget_s,
            device=args.device,
        )
    makespan = sched.simulate(
        {"v100": args.num_gpus},
        submitter=submitter,
        admission_capacity=args.admission_capacity,
        admission_retry_s=args.round_s / 2.0,
        admission_pricer=pricer,
    )
    ftf_list, unfair = sched.get_finish_time_fairness()
    completed = sum(1 for t in sched._job_completion_times.values()
                    if t is not None)
    if decision_log is not None:
        obs.get_recorder().close()
    return {
        "makespan_s": makespan,
        "completed": completed,
        "admitted": sched._num_jobs_in_trace,
        "worst_ftf": max(ftf_list) if ftf_list else None,
        "unfair_fraction": unfair,
        "rounds": sched._num_completed_rounds,
        "preemptions": sched.get_num_preemptions(),
        "solve_records": (list(getattr(sched._shockwave, "solve_records", []))
                          if sched._shockwave is not None else []),
        "submitter": dict(submitter.stats),
        "admission": sched._admission.summary(),
        "watchdog_alerts": list(obs.get_watchdog().alerts),
    }


def _kernel_launches() -> dict:
    """Kernel A's and B's launches so far (none off the card)."""
    from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed

    return {"eg_pdhg": eg_pdhg.LAUNCHES["eg_pdhg"],
            "eg_relaxed": eg_relaxed.LAUNCHES["eg_relaxed"]}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _kernel_launches().items()}


def _by_backend(records) -> dict:
    """Solves by the backend that made them."""
    counts: dict = {}
    for r in records:
        counts[r["backend"]] = counts.get(r["backend"], 0) + 1
    return counts


def run_campaign(args) -> dict:
    """The fault-free baseline, the churn campaign and the invariants;
    returns the result (its ``failures`` empty when every one held)."""
    os.makedirs(args.out, exist_ok=True)
    oracle = generate_oracle()
    failures = []
    stem = os.path.splitext(args.result_name)[0]

    # The fault-free baseline sizes the churn plan's horizon. Bursts are
    # narrower than a round, so a whole burst lands in one admission drain
    # and piles up against the queue bound.
    faults.reset()
    arrivals = faults.generate_arrival_campaign(
        args.seed, args.num_jobs, args.arrival_horizon_s,
        burst_count=args.bursts, burst_width_frac=args.burst_width_frac)
    jobs = make_jobs(args.num_jobs, args.epochs)
    before = _kernel_launches()
    baseline = run_stream(args, arrivals, jobs,
                          synthesize_profiles(jobs, oracle), oracle)
    launches = {"baseline": _since(before)}
    print(f"baseline: makespan {baseline['makespan_s']:.0f}s, "
          f"{baseline['rounds']} rounds, "
          f"{baseline['admission']['rejected_batches']} rejects", flush=True)

    _, plan = faults.generate_streaming_plan(
        args.seed, args.num_jobs, baseline["makespan_s"], args.num_gpus,
        target_churn_events=args.target_churn_events,
        submit_faults=args.submit_faults, round_s=args.round_s,
        min_capacity=max(2, args.num_gpus // 4),
        solver_faults=args.solver_faults)
    atomic_write_text(os.path.join(args.out, f"{stem}_fault_plan.json"),
                      plan.to_json())
    injector = faults.configure(plan)
    decision_log = os.path.join(args.out, f"{stem}_decision_log.jsonl")
    if os.path.exists(decision_log):
        os.remove(decision_log)
    jobs = make_jobs(args.num_jobs, args.epochs)
    before = _kernel_launches()
    chaos = run_stream(args, arrivals, jobs, synthesize_profiles(jobs, oracle),
                       oracle, decision_log=decision_log)
    launches["chaos"] = _since(before)
    summary = injector.summary()
    faults.reset()  # the replays below must not consume leftover events
    print(f"streamed: makespan {chaos['makespan_s']:.0f}s, "
          f"{chaos['rounds']} rounds, {summary['applied']} faults, "
          f"{chaos['admission']['rejected_batches']} rejects, "
          f"{chaos['admission']['deduped_batches']} dedups", flush=True)

    adm = chaos["admission"]
    if chaos["completed"] != args.num_jobs:
        failures.append(f"LOST JOBS: {args.num_jobs - chaos['completed']} of "
                        f"{args.num_jobs} never completed")
    if chaos["admitted"] != args.num_jobs:
        failures.append(
            f"ADMISSION MISCOUNT: {chaos['admitted']} admitted for "
            f"{args.num_jobs} submitted — a token resolved "
            f"{'twice' if chaos['admitted'] > args.num_jobs else 'never'}")
    if adm["accepted_jobs"] != args.num_jobs:
        failures.append(f"queue accepted {adm['accepted_jobs']} jobs for "
                        f"{args.num_jobs} submitted (token ledger leak)")
    if (args.submit_faults
            and chaos["submitter"]["rpc_faults"] < args.submit_faults):
        failures.append(f"only {chaos['submitter']['rpc_faults']} of "
                        f"{args.submit_faults} injected SubmitJobs faults "
                        "fired")
    if adm["rejected_batches"] < 1:
        failures.append("backpressure never engaged (0 rejected batches — "
                        "shrink --admission_capacity or widen the bursts)")
    if adm["depth"] != 0:
        failures.append(f"admission queue did not drain (final depth "
                        f"{adm['depth']})")
    if not adm["closed"]:
        failures.append("end-of-stream close never reached the queue")
    solve_seconds = [r["seconds"] for r in chaos["solve_records"]
                     if r.get("ok")]
    replan_p99 = (float(np.percentile(solve_seconds, 99))
                  if solve_seconds else None)
    if replan_p99 is None:
        failures.append("no successful plan solves recorded")
    elif replan_p99 > args.round_s:
        failures.append(f"p99 replan latency {replan_p99:.2f}s exceeds the "
                        f"{args.round_s}s round budget")
    if summary["unrecovered"]:
        failures.append(f"{len(summary['unrecovered'])} applied faults never "
                        f"recovered: {summary['unrecovered'][:10]}")
    log_summary = summarize_log(decision_log)
    admission_events = sum(log_summary.get("admissions", {}).values())
    total_events = summary["applied"] + admission_events
    if total_events < args.min_events:
        failures.append(f"only {total_events} total events "
                        f"({summary['applied']} faults + {admission_events} "
                        f"admissions); need >= {args.min_events}")
    before = _kernel_launches()
    replays = replay_log(decision_log, device=args.device)
    launches["replay"] = _since(before)
    diverged = [r for r in replays if r["diff"]]
    if not replays:
        failures.append("decision log recorded no plan rounds")
    if diverged:
        failures.append(f"replay diverged on {len(diverged)}/{len(replays)} "
                        f"plan records (first: round {diverged[0]['round']})")

    return {
        "seed": args.seed,
        "num_jobs": args.num_jobs,
        "num_gpus": args.num_gpus,
        "policy": args.policy,
        "device": args.device,
        "round_s": args.round_s,
        "plan_deadline_s": args.plan_deadline_s,
        "admission_capacity": args.admission_capacity,
        "batch_size": args.batch_size,
        "planned_fault_events": summary["planned_events"],
        "applied_fault_events": summary["applied"],
        "admission_events": log_summary.get("admissions", {}),
        "total_events": total_events,
        "submitter": chaos["submitter"],
        "admission": adm,
        "replan_p99_s": (round(replan_p99, 4) if replan_p99 is not None
                         else None),
        "replan_count": len(solve_seconds),
        # Each run's solves by backend, and the kernels' launches (on the
        # card) in each run and in the replays.
        "solves_by_backend": {"baseline": _by_backend(
            baseline["solve_records"]), "chaos": _by_backend(
                chaos["solve_records"])},
        "kernel_launches": launches,
        "replayed_plans": len(replays),
        "replay_exact": len(replays) - len(diverged),
        "baseline": {k: baseline[k] for k in _RUN_KEYS},
        "chaos": {k: chaos[k] for k in _RUN_KEYS},
        "watchdog_alert_rules": sorted({a["rule"]
                                        for a in chaos["watchdog_alerts"]}),
        "failures": failures,
        "ok": not failures,
    }


def main(args) -> int:
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    result = run_campaign(args)
    out_json = os.path.join(args.out, args.result_name)
    atomic_write_json(out_json, result)
    print(f"wrote {out_json}")
    for line in result["failures"]:
        print(f"FAIL: {line}")
    if result["ok"]:
        print(f"OK: {result['total_events']} events "
              f"({result['applied_fault_events']} faults + "
              f"{result['total_events'] - result['applied_fault_events']} "
              f"admissions), 0 lost/double-admitted jobs, "
              f"{result['admission']['rejected_batches']} backpressure "
              f"rejects drained, p99 replan {result['replan_p99_s']:.2f}s < "
              f"{args.round_s}s budget, {result['replayed_plans']} plans "
              "replayed exactly")
    return 0 if result["ok"] else 1


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=str, default="results/streaming_torch")
    parser.add_argument("--result_name", type=str,
                        default="streaming_soak.json")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--policy", type=str, default="shockwave_tpu_pdhg",
                        help="shockwave_tpu_pdhg solves every replan with "
                        "kernel A")
    parser.add_argument("--num_jobs", type=int, default=200)
    parser.add_argument("--num_gpus", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--arrival_horizon_s", type=float, default=9000.0)
    parser.add_argument("--bursts", type=int, default=3)
    parser.add_argument(
        "--burst_width_frac", type=float, default=0.005,
        help="burst width as a fraction of the horizon; keep it under one "
        "round so a burst cannot be split across drains")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--admission_capacity", type=int, default=16)
    parser.add_argument(
        "--price-admission", "--price_admission", dest="price_admission",
        action="store_true",
        help="price each fresh batch's Nash-welfare externality with a "
        "2-scenario what-if solve on --device (shockwave policies only); a "
        "failed or over-budget pricing falls back to the quota-only path")
    parser.add_argument(
        "--price_threshold", "--price-threshold", dest="price_threshold",
        type=float, default=1e-3,
        help="the incumbents' largest Nash-welfare loss a burst may impose "
        "before it is rejected")
    parser.add_argument(
        "--price_budget_s", "--price-budget-s", dest="price_budget_s",
        type=float, default=0.25,
        help="wall-clock budget of one pricing solve; an overrun abstains")
    parser.add_argument("--round_s", type=float, default=120.0)
    parser.add_argument("--future_rounds", type=int, default=8)
    parser.add_argument("--plan_deadline_s", type=float, default=30.0)
    parser.add_argument("--target_churn_events", type=int, default=9800)
    parser.add_argument("--submit_faults", type=int, default=6)
    parser.add_argument("--solver_faults", type=int, default=6)
    parser.add_argument("--min_events", type=int, default=10000)
    parser.add_argument(
        "--smoke", action="store_true",
        help="the reduced campaign: churn_smoke.json, 14 jobs, 4 GPUs, "
        "80 target events, 2 submit and 2 solver faults, seed 0")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the planner's solves, the pricer's and "
                        "the replays run")
    return parser


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
