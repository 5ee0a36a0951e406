"""Chaos soak: a seeded churn, reclaim and solver-fault campaign against the
simulator, with the recovery contract held.

    python -m shockwave_tpu_torch.tools.chaos_soak            # the soak, on the card
    python -m shockwave_tpu_torch.tools.chaos_soak --smoke --device cpu

The port's counterpart of the JAX package's ``scripts/chaos_soak.py``
(``--smoke`` is ``scripts/ci/chaos_smoke.py``'s reduced campaign: 10 jobs
on 4 GPUs, 80 target events, at least 50 applied, 3 solver faults, seed
0). It runs the same synthetic trace twice, fault-free and then under a
:func:`runtime.faults.generate_churn_plan` plan (worker crashes, spot
reclamations, churn re-adds, solver slowdowns and timeouts, scheduler
crash and restart drills through ``ha/codec.py``), and holds:

- no lost job: every job completes despite the churn;
- every applied fault is paired with a recovery, in the injector's
  summary and in the flight recorder's decision log;
- the decision log replays exactly;
- the solver ladder fell back (at least one ``degraded`` round) and no
  solve passed the plan deadline;
- the worst finish-time fairness against the fault-free run is reported.

The planner's solves (and the replays) run on ``--device`` (default
``cuda``). Writes ``<result_name>`` with its fault plan and decision log
under ``--out``; exits 1 on any violated invariant.
"""

from __future__ import annotations

import argparse
import os

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.profiles import synthesize_profiles
from shockwave_tpu_torch.data.workload_info import steps_per_epoch
from shockwave_tpu_torch.obs.recorder import iter_records, replay_log
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.utils.fileio import atomic_write_json, atomic_write_text

MODELS = [("ResNet-18", 32), ("ResNet-50", 64)]
# scripts/ci/chaos_smoke.py's campaign.
SMOKE = {"result_name": "chaos_smoke.json", "num_jobs": 10, "num_gpus": 4,
         "target_events": 80, "min_events": 50, "solver_faults": 3, "seed": 0}


def make_jobs(num_jobs: int, epochs: int, arrival_gap_s: float, seed: int):
    jobs, arrivals = [], []
    for i in range(num_jobs):
        model, bs = MODELS[i % len(MODELS)]
        jobs.append(Job(
            job_type=f"{model} (batch size {bs})",
            command="python3 main.py",
            total_steps=steps_per_epoch(model, bs) * epochs,
            scale_factor=[1, 1, 2, 1][i % 4],
            mode="static",
        ))
        arrivals.append(i * arrival_gap_s)
    return jobs, arrivals


def run_sim(args, jobs, arrivals, profiles, oracle, decision_log=None,
            extra_config=None) -> dict:
    """One simulation (the caller builds fresh jobs and profiles for each:
    the scheduler mutates them); ``extra_config`` merges extra Shockwave
    configuration keys."""
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
    if extra_config:
        config.update(extra_config)
    obs.reset()
    if decision_log is not None:
        obs.configure_recorder(decision_log)
        obs.configure_watchdog()
    sched = Scheduler(
        get_policy(args.policy, device=args.device),
        throughputs=oracle,
        seed=args.seed,
        time_per_iteration=args.round_s,
        profiles=profiles,
        shockwave_config=(config if args.policy.startswith("shockwave")
                          else None),
    )
    makespan = sched.simulate({"v100": args.num_gpus}, list(arrivals),
                              list(jobs))
    ftf_list, unfair = sched.get_finish_time_fairness()
    completed = sum(1 for t in sched._job_completion_times.values()
                    if t is not None)
    if decision_log is not None:
        obs.get_recorder().close()
    return {
        "makespan_s": makespan,
        "completed": completed,
        "worst_ftf": max(ftf_list) if ftf_list else None,
        "unfair_fraction": unfair,
        "rounds": sched._num_completed_rounds,
        "preemptions": sched.get_num_preemptions(),
        "solve_records": (list(getattr(sched._shockwave, "solve_records", []))
                          if sched._shockwave is not None else []),
        "watchdog_alerts": list(obs.get_watchdog().alerts),
    }


def pair_log_faults(decision_log: str):
    """(fault keys, recovery keys, unpaired fault keys) of the decision
    log; a fault without a ``fault_id`` pairs on (kind, worker, round)."""
    fault_keys, recovery_keys = [], []
    for record in iter_records(decision_log):
        event = record.get("event")
        if event not in ("fault", "recovery"):
            continue
        key = record.get("fault_id", (record.get("kind"),
                                      record.get("worker_id"),
                                      record.get("round")))
        (fault_keys if event == "fault" else recovery_keys).append(key)
    recovered = set(recovery_keys)
    unpaired = [k for k in fault_keys if k not in recovered]
    return fault_keys, recovery_keys, unpaired


_RUN_KEYS = ("makespan_s", "worst_ftf", "unfair_fraction", "rounds",
             "preemptions")


def run_campaign(args) -> dict:
    """The baseline and the chaos run, and the invariants; returns the
    result (its ``failures`` empty when every invariant held)."""
    os.makedirs(args.out, exist_ok=True)
    oracle = generate_oracle()

    def fresh_inputs():
        jobs, arrivals = make_jobs(args.num_jobs, args.epochs,
                                   args.arrival_gap_s, args.seed)
        return jobs, arrivals, synthesize_profiles(jobs, oracle)

    failures = []
    faults.reset()
    jobs, arrivals, profiles = fresh_inputs()
    baseline = run_sim(args, jobs, arrivals, profiles, oracle)
    print(f"baseline: makespan {baseline['makespan_s']:.0f}s, worst FTF "
          f"{baseline['worst_ftf']:.3f}, {baseline['rounds']} rounds",
          flush=True)

    plan = faults.generate_churn_plan(
        args.seed,
        horizon_s=baseline["makespan_s"],
        num_workers=args.num_gpus,
        target_events=args.target_events,
        round_s=args.round_s,
        min_capacity=max(2, args.num_gpus // 4),
        solver_faults=args.solver_faults,
        scheduler_faults=args.scheduler_faults,
    )
    stem = os.path.splitext(args.result_name)[0]
    atomic_write_text(os.path.join(args.out, f"{stem}_fault_plan.json"),
                      plan.to_json())
    injector = faults.configure(plan)
    decision_log = os.path.join(args.out, f"{stem}_decision_log.jsonl")
    if os.path.exists(decision_log):
        os.remove(decision_log)
    jobs, arrivals, profiles = fresh_inputs()
    chaos = run_sim(args, jobs, arrivals, profiles, oracle,
                    decision_log=decision_log)
    summary = injector.summary()
    faults.reset()  # the replays below must not consume leftover events
    print(f"chaos:    makespan {chaos['makespan_s']:.0f}s, worst FTF "
          f"{chaos['worst_ftf']:.3f}, {chaos['rounds']} rounds, "
          f"{summary['applied']} faults applied", flush=True)

    if chaos["completed"] != args.num_jobs:
        failures.append(f"LOST JOBS: {args.num_jobs - chaos['completed']} "
                        f"of {args.num_jobs} never completed")
    if summary["applied"] < args.min_events:
        failures.append(f"only {summary['applied']} fault events applied "
                        f"(need >= {args.min_events}; plan had "
                        f"{summary['planned_events']})")
    if summary["unrecovered"]:
        failures.append(f"{len(summary['unrecovered'])} applied faults never "
                        f"recovered: {summary['unrecovered'][:10]}")
    fault_keys, recovery_keys, unpaired = pair_log_faults(decision_log)
    if not fault_keys:
        failures.append("decision log recorded no fault events")
    if unpaired:
        failures.append(f"{len(unpaired)} decision-log faults lack a "
                        f"recovery record: {unpaired[:10]}")
    degraded = [r for r in chaos["solve_records"] if r.get("degraded")]
    if not degraded:
        failures.append("solver ladder never degraded (expected >= 1 "
                        "tagged round)")
    over_deadline = [
        r for r in chaos["solve_records"]
        if args.plan_deadline_s is not None
        and r["seconds"] > args.plan_deadline_s + args.round_s * 0.1]
    if over_deadline:
        failures.append(f"{len(over_deadline)} solves breached the "
                        f"{args.plan_deadline_s}s plan deadline")
    replays = replay_log(decision_log, device=args.device)
    diverged = [r for r in replays if r["diff"]]
    if diverged:
        failures.append(f"replay diverged on {len(diverged)}/{len(replays)} "
                        f"plan records (first: round {diverged[0]['round']})")

    return {
        "seed": args.seed,
        "num_jobs": args.num_jobs,
        "num_gpus": args.num_gpus,
        "policy": args.policy,
        "device": args.device,
        "plan_deadline_s": args.plan_deadline_s,
        "planned_events": summary["planned_events"],
        "applied_events": summary["applied"],
        "recovered_events": summary["recovered"],
        "log_faults": len(fault_keys),
        "log_recoveries": len(recovery_keys),
        "degraded_rounds": len(degraded),
        "replayed_plans": len(replays),
        "replay_exact": len(replays) - len(diverged),
        "baseline": {k: baseline[k] for k in _RUN_KEYS},
        "chaos": {k: chaos[k] for k in _RUN_KEYS},
        "worst_ftf_delta": (
            chaos["worst_ftf"] - baseline["worst_ftf"]
            if chaos["worst_ftf"] is not None
            and baseline["worst_ftf"] is not None else None),
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
        print(f"OK: {result['applied_events']} faults, 0 lost jobs, "
              f"{result['degraded_rounds']} degraded rounds, "
              f"{result['replayed_plans']} plans replayed exactly, "
              f"worst-FTF delta {result['worst_ftf_delta']:+.3f}")
    return 0 if result["ok"] else 1


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=str, default="results/chaos_torch")
    parser.add_argument("--result_name", type=str, default="soak.json")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--policy", type=str, default="shockwave_tpu")
    parser.add_argument("--num_jobs", type=int, default=48)
    parser.add_argument("--num_gpus", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--arrival_gap_s", type=float, default=30.0)
    parser.add_argument("--round_s", type=float, default=120.0)
    parser.add_argument("--future_rounds", type=int, default=8)
    parser.add_argument("--plan_deadline_s", type=float, default=30.0)
    parser.add_argument("--target_events", type=int, default=1100)
    parser.add_argument("--min_events", type=int, default=1000)
    parser.add_argument("--solver_faults", type=int, default=6)
    parser.add_argument(
        "--scheduler_faults", type=int, default=2,
        help="paired scheduler_crash/restart drills (the control plane's "
        "state round-trips ha/codec.py at round boundaries; 0 disables)")
    parser.add_argument(
        "--smoke", action="store_true",
        help="the reduced campaign: chaos_smoke.json, 10 jobs, 4 GPUs, 80 "
        "target events (at least 50), 3 solver faults, seed 0")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the planner's solves and the replays "
                        "run")
    return parser


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
