"""The physical drivers: run a whole trace against a live localhost
cluster, with its payloads on the card or on the host's CPU.

    python -m shockwave_tpu_torch.run_physical --driver card \\
        --trace traces/small_12_dynamic.trace --policy shockwave_tpu \\
        --oracle results/measured_oracle_h100.json --out results/physical_h100
    python -m shockwave_tpu_torch.run_physical --driver localhost \\
        --policy fifo --device cpu --out results/physical_cpu

The port's counterpart of the JAX package's ``scripts/drivers/``:
``physical_common.py`` (the shared loop, :func:`run_physical_cluster`, and
:func:`overheads_from_phase_report`), ``run_physical_tpu.py`` (the card
driver, :func:`main_card`) and ``run_physical_localhost.py`` (CPU
payloads, :func:`main_localhost`).

The loop brings up the scheduler (``core/physical.py``) and one worker
agent subprocess (``runtime.worker``, ``--accelerators`` slots), submits
the trace through the streaming admission front door on its own thread
(arrival times scaled by ``--time_scale``), runs the round loop until
every admitted job completed, and writes ``summary.json``,
``round_log.json`` and ``timelines.json`` under ``<out>/<policy>/``.

The card driver's agent registers as ``h100`` and its slots share the
card. Each singleton job runs the port's training program at its trace
batch size, its steps sized from the measured oracle (``rate x 0.5 x
--train_s``: two payloads share the card); a job type the oracle lacks
raises. A scale-factor-2 gang needs two cards, so its two ranks train on
the host's CPU over gloo (``--gang_device cpu``) at ``GANG_CPU_BATCH`` for
``GANG_STEPS`` steps, as the JAX driver runs its gangs on the host. The
payloads print their ``PHASES`` lines; the summary carries their
per-family means (``preemption_overhead_phases``), and
``--overheads_from`` feeds a prior run's into the planner's
switching-cost term and round sizing. The planner solves on ``--device``
(default ``cuda``); the card driver's ``--device cpu`` runs its payloads
on the host's CPU too (the oracle's rates then mislabel them: a check of
the loop, not a measurement).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shlex
import subprocess
import sys
import threading
import time
import traceback

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.core.physical import PhysicalScheduler
from shockwave_tpu_torch.utils.fileio import atomic_write_text

# Phases a preempted job pays again on every relaunch (``train`` is the
# useful work; ``rendezvous`` only gangs pay, and for them it is part of
# the relaunch's bill).
_RELAUNCH_PHASES = (
    "rendezvous", "build", "restore", "first_step_compile", "save",
)
CARD_WORKER_TYPE = "h100"
# A gang's ranks train on the host's CPU: a small batch and a few steps
# prove the gang's path (rendezvous, synchronised ranks, merged Done
# reports) inside a round or two.
GANG_CPU_BATCH = {
    "Transformer": 16,
    "ResNet-18": 16,
    "ResNet-50": 4,
    "LM": 8,
    "Recommendation": 128,
    "A3C": 4,
    "CycleGAN": 2,
}
GANG_STEPS = 2
# The localhost driver's (batch size, steps) a family, sized for payloads
# on the host's CPU: a few rounds of real training each.
FAMILY_STEPS = {
    "Transformer": (16, 30),
    "ResNet-18": (16, 8),
    "ResNet-50": (4, 6),
    "LM": (8, 15),
    "Recommendation": (128, 150),
    "A3C": (4, 40),
    "CycleGAN": (2, 4),
}

_BS_RE = re.compile(r"^(?P<family>.+?) \(batch size (?P<bs>\d+)\)$")
_PHASES_RE = re.compile(r"^PHASES (.+)$", re.MULTILINE)


def overheads_from_phase_report(report: dict) -> dict:
    """Each family's relaunch overhead (seconds) from a
    ``preemption_overhead_phases`` block: the sum of its mean relaunch
    phases, rounded to 0.1 s; families with none are left out."""
    overheads = {}
    for family, entry in report.items():
        total = sum(float(entry.get(f"{phase}_mean_s", 0.0))
                    for phase in _RELAUNCH_PHASES)
        if total > 0.0:
            overheads[family] = round(total, 1)
    return overheads


def _train_command(family: str, batch_size: int, extra: str = "") -> str:
    return (f"{shlex.quote(sys.executable)} -m "
            f"shockwave_tpu_torch.models.train --model {family} "
            f"--batch_size {batch_size} {extra}").rstrip()


def _as_payload(job, command: str, steps: int) -> None:
    job.command = command
    job.total_steps = steps
    job.num_steps_arg = "-n"
    job.mode = "static"
    job.working_directory = None
    job.needs_data_dir = False


def localize_jobs(jobs, oracle, train_s: float,
                  worker_type: str = CARD_WORKER_TYPE,
                  payload_args: str = ""):
    """The card driver's jobs, in place: each trace job runs the port's
    training program. A singleton keeps its trace batch size and trains
    ``max(1, int(rate x 0.5 x train_s))`` steps at its oracle rate
    (``payload_args`` appended); a gang trains ``GANG_STEPS`` steps at
    ``GANG_CPU_BATCH`` on the host's CPU. Raises ValueError on a job type
    that is not ``<family> (batch size <N>)``, on a gang of a family with
    no CPU batch, and on a singleton the oracle has no rate for."""
    for job in jobs:
        m = _BS_RE.match(job.job_type)
        if m is None:
            raise ValueError(
                f"trace job_type {job.job_type!r} does not match the "
                "'<family> (batch size <N>)' form this driver localizes")
        family, bs = m.group("family"), int(m.group("bs"))
        if job.scale_factor > 1:
            if family not in GANG_CPU_BATCH:
                raise ValueError(
                    f"no CPU gang batch size for family {family!r} "
                    f"(job_type {job.job_type!r}); add it to GANG_CPU_BATCH")
            command = _train_command(family, GANG_CPU_BATCH[family],
                                     "--gang_device cpu")
            steps = GANG_STEPS
        else:
            try:
                rate = oracle[worker_type][(job.job_type, 1)]["null"]
            except KeyError:
                raise ValueError(
                    f"measured oracle has no {worker_type!r} rate for "
                    f"job_type {job.job_type!r}; re-run the oracle "
                    "measurement or fix the trace") from None
            command = _train_command(family, bs, payload_args)
            # Two payloads share the card: about half its rate each.
            steps = max(1, int(rate * 0.5 * train_s))
        _as_payload(job, command, steps)
    return jobs


def localize_localhost_jobs(jobs):
    """The localhost driver's jobs, in place: ``FAMILY_STEPS``' batch and
    steps a family; a gang's ranks train a sixteenth of the steps (at
    least one)."""
    for job in jobs:
        family = job.job_type.split(" (")[0]
        batch, steps = FAMILY_STEPS[family]
        if job.scale_factor > 1:
            steps = max(1, steps // 16)
        _as_payload(job, _train_command(family, batch), steps)
    return jobs


def collect_phase_report(run_dir: str) -> dict:
    """The payloads' ``PHASES`` lines under ``run_dir`` by family: the
    attempts and each phase's mean and largest seconds, rounded to 0.1 s.
    Every relaunch pays build, restore and the first step again, so a
    phase's mean is its per-preemption overhead."""
    per_family: dict = {}
    for path in glob.glob(os.path.join(run_dir, "*.stdout")):
        with open(path) as f:
            text = f.read()
        fam_match = re.search(r"^\[(.+?)\] steps=", text, re.MULTILINE)
        family = fam_match.group(1) if fam_match else "unknown"
        for phases in _PHASES_RE.findall(text):
            entry = per_family.setdefault(family, {"attempts": 0})
            entry["attempts"] += 1
            for kv in phases.split():
                key, val = kv.split("=")
                entry.setdefault(key, []).append(float(val.rstrip("s")))
    report = {}
    for family, entry in sorted(per_family.items()):
        report[family] = {"attempts": entry.pop("attempts")}
        for key, vals in entry.items():
            report[family][f"{key}_mean_s"] = round(sum(vals) / len(vals), 1)
            report[family][f"{key}_max_s"] = round(max(vals), 1)
    return report


def _configure_telemetry(metrics_out, trace_out, decision_log,
                         watchdog_rules, round_s) -> None:
    """The planes, before the scheduler exists (the tracer adopts its
    clock, the registry catches registration). The replan-p99 budget
    defaults to the round; an ingest p99 budget only when the operator
    sets ``SHOCKWAVE_INGEST_P99_BUDGET_S``."""
    if metrics_out:
        obs.configure(metrics=True)
        obs.configure_calibration()
    if trace_out:
        obs.configure(trace=True)
    if decision_log:
        obs.configure_recorder(decision_log)
    if watchdog_rules is None:
        return
    rules = dict(watchdog_rules or {})
    if "replan_p99" not in rules:
        rules["replan_p99"] = {"budget_s": round_s}
    elif rules["replan_p99"] not in (False, None):
        rules["replan_p99"] = {"budget_s": round_s, **rules["replan_p99"]}
    ingest = os.environ.get("SHOCKWAVE_INGEST_P99_BUDGET_S", "").strip()
    try:
        budget_s = float(ingest) if ingest else None
    except ValueError:
        budget_s = None
    if budget_s and budget_s > 0:
        if "ingest_p99" not in rules:
            rules["ingest_p99"] = {"budget_s": budget_s}
        elif rules["ingest_p99"] not in (False, None):
            rules["ingest_p99"] = {"budget_s": budget_s,
                                   **rules["ingest_p99"]}
    obs.configure_watchdog(rules)
    obs.configure_calibration()


def _summary(sched, jobs, submitted, policy_name, worker_type, accelerators,
             round_s, preemption_overheads, t_start, metrics_out,
             trace_out) -> dict:
    completed = {str(j): t for j, t in sched._job_completion_times.items()}
    avg_jct = sched.get_average_jct()
    ftf_list, unfair_fraction = sched.get_finish_time_fairness()
    summary = {
        "policy": policy_name,
        "worker_type": worker_type,
        "accelerators": accelerators,
        "round_s": round_s,
        "effective_round_s": sched._time_per_iteration,
        "preemption_overheads": preemption_overheads,
        "wall_clock_s": round(time.time() - t_start, 1),
        "makespan_s": round(sched.get_current_timestamp(), 1),
        "avg_jct_s": round(avg_jct, 1) if avg_jct is not None else None,
        "completed_jobs": sum(1 for t in completed.values() if t is not None),
        "total_jobs": len(jobs),
        "submitted_jobs": len(submitted),
        "lease_extensions": sched._num_lease_extensions,
        "lease_extension_opportunities": (
            sched._num_lease_extension_opportunities),
        "num_preemptions": sched.get_num_preemptions(),
        "worst_ftf": round(max(ftf_list), 3) if ftf_list else None,
        "unfair_fraction": (round(unfair_fraction, 1) if ftf_list
                            else None),
        "steps_run": {str(j): int(s)
                      for j, s in sched._total_steps_run.items()},
        "job_completion_times_s": {
            j: (round(t, 1) if t is not None else None)
            for j, t in completed.items()},
    }
    # Planning seconds on the round loop's thread (exposed) against those
    # hidden on the speculative thread.
    planner = sched._shockwave
    if planner is not None and hasattr(planner, "spec_stats"):
        exposed = list(planner.exposed_plan_times)
        rounds = max(1, sched._num_completed_rounds)
        summary["pipelining"] = {
            "speculate": bool(sched._speculate),
            "spec_stats": dict(planner.spec_stats),
            "exposed_plan_s_total": round(sum(exposed), 4),
            "exposed_plan_s_max": round(max(exposed), 4) if exposed else 0.0,
            "exposed_plan_s_mean_per_round": round(sum(exposed) / rounds, 4),
            "effective_planning_overhead_pct": round(
                100.0 * sum(exposed) / (rounds * sched._time_per_iteration),
                4),
        }
    if trace_out and obs.trace_enabled():
        from shockwave_tpu_torch.obs import spantree

        budgets = spantree.latency_budget(
            obs.get_tracer().export_dict()["traceEvents"])
        if budgets:
            summary["latency_budget"] = {
                "fleet": spantree.budget_fleet_summary(budgets),
                "jobs": budgets,
            }
    summary["admission"] = sched._admission.summary()
    if metrics_out:
        from shockwave_tpu_torch.obs.watchdog import Watchdog

        snap = obs.get_registry().snapshot()["metrics"]
        p50, admitted = Watchdog._histogram_quantile(
            snap, "admission_queue_latency_seconds", 0.5)
        p99, _ = Watchdog._histogram_quantile(
            snap, "admission_queue_latency_seconds", 0.99)
        if admitted:
            summary["ingest"] = {
                "admitted_jobs": int(admitted),
                "queue_latency_p50_s": p50,
                "queue_latency_p99_s": p99,
                "tick_s": float(os.environ.get("SHOCKWAVE_INGEST_TICK_S", "0")
                                or 0),
            }
    if obs.get_watchdog().enabled:
        summary["scheduler_health"] = obs.get_watchdog().summary()
    return summary


def run_physical_cluster(
    jobs,
    arrivals,
    oracle,
    profiles,
    policy_name: str,
    out_dir: str,
    worker_type: str,
    worker_env: dict,
    accelerators: int,
    round_s: float,
    time_scale: float,
    max_rounds,
    completion_buffer_s: float,
    shockwave_config=None,
    extra_summary=None,
    preemption_overheads=None,
    round_overhead_fraction=None,
    metrics_out=None,
    trace_out=None,
    decision_log=None,
    watchdog_rules=None,
    metrics_port=None,
    device: str = "cuda",
    worker_device: str = "cuda",
    scheduler_cls=PhysicalScheduler,
    deadline=None,
    worker_log=None,
):
    """Drive the whole trace against a live localhost cluster; writes
    ``<out_dir>/{summary.json,round_log.json,timelines.json}`` and returns
    the summary. ``extra_summary(sched, run_dir)`` adds fields. The
    planner solves on ``device``; the agent's payloads run on
    ``worker_device``. ``scheduler_cls`` is the scheduler's class (a
    caller's subclass may observe it). ``deadline`` (``time.time()``), when
    given, bounds every wait: a round loop still running then is shut
    down and the summary says ``"timed_out": true``. ``worker_log`` is the
    agent's output file (default: this process's streams); the summary
    carries its exit code (``worker_exit_code``).

    ``metrics_out`` / ``trace_out`` turn on the telemetry planes and
    export the scheduler's metrics and timeline there; the agent gets the
    matching environment and writes ``worker_metrics.json`` /
    ``worker_trace.json`` beside them."""
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.runtime.testing import free_port

    os.makedirs(out_dir, exist_ok=True)
    run_dir = os.path.join(out_dir, "run")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    _configure_telemetry(metrics_out, trace_out, decision_log,
                         watchdog_rules, round_s)
    worker_env = dict(worker_env)
    if metrics_out:
        worker_env["SHOCKWAVE_METRICS_OUT"] = os.path.join(
            os.path.dirname(os.path.abspath(metrics_out)),
            "worker_metrics.json")
    if trace_out:
        worker_env["SHOCKWAVE_TRACE_OUT"] = os.path.join(
            os.path.dirname(os.path.abspath(trace_out)), "worker_trace.json")

    def left(most: float) -> float:
        if deadline is None:
            return most
        return max(1.0, min(most, deadline - time.time()))

    sched_port, worker_port = free_port(), free_port()
    sched = scheduler_cls(
        get_policy(policy_name, device=device),
        port=sched_port,
        throughputs=oracle,
        time_per_iteration=round_s,
        completion_buffer_seconds=completion_buffer_s,
        minimum_time_between_allocation_resets=0.0,
        profiles=profiles,
        shockwave_config=shockwave_config,
        preemption_overheads=preemption_overheads,
        round_overhead_fraction=round_overhead_fraction,
        metrics_port=metrics_port,
    )
    if sched._fleet is not None and sched._fleet.port is not None:
        print(f"Fleet scrape endpoint: http://127.0.0.1:{sched._fleet.port}"
              "/metrics (and /healthz)")
    log_file = open(worker_log, "w") if worker_log else None
    worker_proc = subprocess.Popen(
        [sys.executable, "-m", "shockwave_tpu_torch.runtime.worker",
         "-t", worker_type, "-n", str(accelerators),
         "-a", "127.0.0.1", "-s", str(sched_port), "-p", str(worker_port),
         "--run_dir", run_dir, "--checkpoint_dir", ckpt_dir,
         "--device", worker_device],
        env=worker_env, stdout=log_file,
        stderr=subprocess.STDOUT if log_file else None)
    t_start = time.time()
    timed_out = False
    try:
        sched.wait_for_workers(accelerators, timeout=left(60))
        submitted = []

        def submit():
            from shockwave_tpu_torch.runtime.rpc.submitter_client import (
                SubmitterClient,
            )

            client = SubmitterClient("127.0.0.1", sched_port,
                                     client_id="driver")
            try:
                # submit_trace closes the stream even when it fails, so
                # the round loop finishes what was admitted.
                client.submit_trace(jobs, arrivals, time_scale=time_scale,
                                    on_batch=submitted.extend)
            except Exception:
                print("ERROR: submitter thread failed after "
                      f"{len(submitted)}/{len(jobs)} jobs:\n"
                      f"{traceback.format_exc()}", file=sys.stderr)
            finally:
                client.close()

        sched.expect_stream()
        submitter = threading.Thread(target=submit, daemon=True)
        submitter.start()
        if deadline is None:
            sched.run(max_rounds=max_rounds)
        else:
            runner = threading.Thread(target=sched.run, name="round-loop",
                                      kwargs={"max_rounds": max_rounds})
            runner.start()
            # The agent's exit after Shutdown has 30 s of what is left.
            runner.join(timeout=max(1.0, deadline - time.time() - 30.0))
            timed_out = runner.is_alive()
        submitter.join(timeout=5)
        if submitter.is_alive():
            print(f"WARNING: only {len(submitted)}/{len(jobs)} jobs were "
                  "submitted before the round loop ended", file=sys.stderr)
        summary = _summary(sched, jobs, submitted, policy_name, worker_type,
                           accelerators, round_s, preemption_overheads,
                           t_start, metrics_out, trace_out)
        summary["timed_out"] = timed_out
    finally:
        sched.shutdown()
        # A background speculative solve still running when the
        # interpreter exits aborts it: let the last one finish.
        speculation = getattr(sched._shockwave, "_speculation", None)
        if speculation is not None:
            speculation.done.wait(timeout=left(30))
        try:
            # The agent exits on the Shutdown call once its telemetry is
            # written.
            worker_proc.wait(timeout=left(15))
        except subprocess.TimeoutExpired:
            worker_proc.terminate()
            try:
                worker_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                worker_proc.kill()
                worker_proc.wait()
        if log_file is not None:
            log_file.close()
    # After the agent's exit: every payload's output is complete.
    summary["worker_exit_code"] = worker_proc.returncode
    if extra_summary is not None:
        summary.update(extra_summary(sched, run_dir))
    ftf_list, unfair_fraction = sched.get_finish_time_fairness()
    obs.export_run_summary(
        metrics_out=metrics_out, trace_out=trace_out,
        makespan=summary["makespan_s"], avg_jct=sched.get_average_jct(),
        ftf_list=ftf_list, unfair_fraction=unfair_fraction)
    # Atomic writes: a run killed in its teardown leaves no torn JSON.
    atomic_write_text(os.path.join(out_dir, "summary.json"),
                      json.dumps(summary, indent=1))
    atomic_write_text(os.path.join(out_dir, "round_log.json"),
                      json.dumps(sched._round_log, indent=1))
    atomic_write_text(
        os.path.join(out_dir, "timelines.json"),
        json.dumps({str(j): lines for j, lines in sched._job_timelines.items()},
                   indent=1))
    print(json.dumps(summary, indent=1), flush=True)
    return summary


def _shockwave_config(args):
    if not args.policy.startswith("shockwave"):
        return None
    return {
        "num_gpus": args.accelerators,
        "time_per_iteration": args.round_s,
        "future_rounds": 8,
        "lambda": 5.0,
        "k": 10.0,
        "speculate": args.speculate,
        "speculate_epoch_tolerance": args.speculate_epoch_tolerance,
    }


def _common_parser(description: str, policy: str, out: str, round_s: float,
                   max_rounds: int) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--trace", default="traces/small_12_dynamic.trace")
    parser.add_argument("--policy", default=policy)
    parser.add_argument("--out", default=out)
    parser.add_argument("--accelerators", type=int, default=2)
    parser.add_argument("--round_s", type=float, default=round_s)
    parser.add_argument("--time_scale", type=float, default=0.002,
                        help="arrival-time compression")
    parser.add_argument("--max_rounds", type=int, default=max_rounds)
    parser.add_argument(
        "--round_overhead_fraction", type=float, default=None,
        help="auto-size the round so the worst measured relaunch overhead "
        "costs at most this fraction of it")
    parser.add_argument(
        "--speculate", action=argparse.BooleanOptionalAction, default=True,
        help="plan round r+1 on a background thread while round r runs "
        "(shockwave policies only); --no-speculate plans serially")
    parser.add_argument(
        "--speculate_epoch_tolerance", type=int, default=1,
        help="epochs of per-job progress drift a speculation survives "
        "before the boundary repairs it")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the planner's device solves run")
    obs.add_telemetry_args(parser)
    return parser


def card_parser() -> argparse.ArgumentParser:
    parser = _common_parser(
        "the card driver: the trace's payloads on the card",
        "shockwave_tpu", "results/physical_h100", 60.0, 60)
    parser.add_argument("--oracle", default="results/measured_oracle_h100.json")
    parser.add_argument(
        "--train_s", type=float, default=60.0,
        help="a singleton's target seconds of training alone on the card")
    parser.add_argument(
        "--overheads_from", default=None,
        help="summary.json of a prior run; its per-family "
        "preemption_overhead_phases seed the planner's switching-cost "
        "term and round auto-sizing")
    return parser


def main_card(argv=None) -> dict:
    """The card driver (``run_physical_tpu.py``'s counterpart)."""
    from shockwave_tpu_torch.data import parse_trace, read_throughputs
    from shockwave_tpu_torch.data.profiles import synthesize_profiles

    args = card_parser().parse_args(argv)
    jobs, arrivals = parse_trace(args.trace)
    oracle = read_throughputs(args.oracle)
    localize_jobs(jobs, oracle, args.train_s)
    preemption_overheads = None
    if args.overheads_from:
        with open(args.overheads_from) as f:
            report = json.load(f).get("preemption_overhead_phases")
        if not report:
            raise ValueError(f"{args.overheads_from} carries no "
                             "preemption_overhead_phases block to seed "
                             "overheads from")
        preemption_overheads = overheads_from_phase_report(report)
    profiles = synthesize_profiles(jobs, oracle, worker_type=CARD_WORKER_TYPE)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    env = dict(os.environ)
    env["SHOCKWAVE_PHASE_TIMINGS"] = "1"
    return run_physical_cluster(
        jobs, arrivals, oracle, profiles, args.policy,
        os.path.join(args.out, args.policy), CARD_WORKER_TYPE, env,
        args.accelerators, args.round_s, args.time_scale, args.max_rounds,
        completion_buffer_s=1.5 * args.round_s,
        shockwave_config=_shockwave_config(args),
        preemption_overheads=preemption_overheads,
        round_overhead_fraction=args.round_overhead_fraction,
        metrics_out=args.metrics_out, trace_out=args.trace_out,
        decision_log=args.decision_log,
        watchdog_rules=obs.watchdog_rules_from_args(args),
        metrics_port=args.metrics_port, device=args.device,
        worker_device=args.device,
        extra_summary=lambda sched, run_dir: {
            "trace": args.trace,
            "preemption_overhead_phases": collect_phase_report(run_dir),
        },
    )


def localhost_parser() -> argparse.ArgumentParser:
    parser = _common_parser(
        "the localhost driver: the trace's payloads on the host's CPU",
        "fifo", "results/physical_cpu", 30.0, 90)
    parser.add_argument(
        "--overheads", type=float, default=None,
        help="measured relaunch overhead (seconds, every family) for the "
        "planner's switching-cost term")
    return parser


def main_localhost(argv=None) -> dict:
    """The localhost driver (``run_physical_localhost.py``'s counterpart):
    payloads on the host's CPU under the synthetic oracle's v100 rates."""
    from shockwave_tpu_torch.data import parse_trace
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.data.profiles import synthesize_profiles

    args = localhost_parser().parse_args(argv)
    jobs, arrivals = parse_trace(args.trace)
    localize_localhost_jobs(jobs)
    oracle = generate_oracle()
    profiles = synthesize_profiles(jobs, oracle)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    return run_physical_cluster(
        jobs, arrivals, oracle, profiles, args.policy,
        os.path.join(args.out, args.policy), "v100", dict(os.environ),
        args.accelerators, args.round_s, args.time_scale, args.max_rounds,
        completion_buffer_s=args.round_s,
        shockwave_config=_shockwave_config(args),
        preemption_overheads=args.overheads,
        round_overhead_fraction=args.round_overhead_fraction,
        metrics_out=args.metrics_out, trace_out=args.trace_out,
        decision_log=args.decision_log,
        watchdog_rules=obs.watchdog_rules_from_args(args),
        metrics_port=args.metrics_port, device=args.device,
        worker_device="cpu",
        extra_summary=lambda sched, run_dir: {"trace": args.trace},
    )


def main(driver: str, argv=None) -> dict:
    if driver == "card":
        return main_card(argv)
    if driver == "localhost":
        return main_localhost(argv)
    raise ValueError(f"unknown driver {driver!r} (card or localhost)")
