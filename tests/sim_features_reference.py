"""The JAX package's runs of the simulator's features, and where two runs
part.

    python tests/sim_features_reference.py capture --package jax \\
        --out jax.json.gz
    python tests/sim_features_reference.py capture --package port \\
        --device cpu --skip-tier --out port.json.gz
    python tests/sim_features_reference.py compare jax.json.gz port.json.gz

``capture`` runs every cell of ``bench_sim.sim_feature_runs`` (the
220-job trace on 64 v100s under a churn plan, with and without kernel A;
the estimator sweep on the golden trace; the 220-job trace under online
estimation) through the JAX package's scheduler (``--package jax``, on
the CPU) or the port's (``--package port`` on ``--device``), as
``bench_sim.run_trace`` drives the port's, and prices
(``whatif/pricing.py``) round 91 of the committed decision log and,
unless ``--skip-tier``, the ``--cells 4`` 2048-job tier's state at its
most incomplete jobs (a burst of 8 jobs, and ``bench_sim.pricing_bursts``
as one batch). It writes each run's metrics and
``bench_sim.sim_features`` (the injector's summary and recovery records,
the live worker ids, the jobs admitted, lost and dropped, the
estimator's matches, the round log), and each pricing decision, and
prints one JSON line a cell. ``compare`` holds the second capture to
the first: metrics within ``bench_sim.TOLERANCE`` in the same rounds,
summaries, recoveries (but the HA round trips' verdicts,
``bench_sim.recoveries_without_hashes``; the second capture's must all
be exact), worker ids, jobs admitted, lost and dropped, and matches
equal, round logs record for record (exact on policies that solve on the
host, 1e-3 where a device backend decides), pricing decisions by
``bench_sim.decision_misses``. The committed
``results/sim_features/jax_reference.json.gz`` is the JAX package's
capture the pins of ``bench_sim.SIM_FEATURES`` come from.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from shockwave_tpu_torch.tools import bench_sim  # noqa: E402
from shockwave_tpu_torch.tools.whatif import burst_jobs  # noqa: E402

JAX_REFERENCE = ROOT / "results" / "sim_features" / "jax_reference.json.gz"
FLIGHT_LOG = ROOT / "results" / "flight_recorder" / "decisions.jsonl"


def ref_run(trace, policy: str, num_gpus: int, gpus_per_server: int = None,
            fault_plan=None, profiling_percentage: float = 1.0,
            num_reference_models: int = None) -> dict:
    """The JAX package's run of ``trace`` as ``bench_sim.run_trace`` drives
    the port's (120 s rounds, seed 0; the same arguments)."""
    from shockwave_tpu.core.scheduler import Scheduler
    from shockwave_tpu.data import load_or_synthesize_profiles, parse_trace
    from shockwave_tpu.data.default_oracle import generate_oracle
    from shockwave_tpu.policies import get_policy
    from shockwave_tpu.runtime import faults

    start = time.perf_counter()
    cluster = {"v100": num_gpus}
    jobs, arrivals = parse_trace(str(trace))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(trace), jobs, oracle, worker_type="v100", cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = None
    if policy.startswith("shockwave"):
        config = {"num_gpus": num_gpus,
                  "time_per_iteration": bench_sim.ROUND_S,
                  "future_rounds": 20, "lambda": 5.0, "k": 10.0}
    injector = None
    if fault_plan == "churn":
        injector = faults.configure(bench_sim.churn_plan(faults))
    try:
        sched = Scheduler(get_policy(policy, seed=0), throughputs=oracle,
                          seed=0, time_per_iteration=bench_sim.ROUND_S,
                          profiles=profiles, shockwave_config=config,
                          profiling_percentage=profiling_percentage,
                          num_reference_models=num_reference_models)
        per_server = ({"v100": gpus_per_server} if gpus_per_server
                      else None)
        makespan = sched.simulate(dict(cluster), arrivals, jobs,
                                  num_gpus_per_server=per_server)
    finally:
        faults.reset()
    ftf, unfair = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), unfair_fraction=unfair,
                rounds=sched._num_completed_rounds,
                **bench_sim.sim_features(sched, injector),
                wall_s=time.perf_counter() - start)


def tier_state(package: str, device: str = "cpu") -> tuple:
    """(round, incomplete jobs, planner state) of the 2048-job tier under
    ``shockwave_tpu_pdhg --cells 4`` at its most incomplete jobs, as
    chip_smoke.py's phase 12 snapshots it."""
    if package == "jax":
        from shockwave_tpu.cells.planner import CellPlanner

        def run():
            return ref_tier()
    else:
        from shockwave_tpu_torch.cells.planner import CellPlanner

        def run():
            return bench_sim.run_trace(bench_sim.TRACE_2048,
                                       "shockwave_tpu_pdhg", 256, device,
                                       config={"cells": 4})
    snapshot = {"jobs": -1}
    real = CellPlanner.current_round_schedule

    def snapshotting(self):
        incomplete = sum(1 for c in self.children.values()
                         for md in c.job_metadata.values()
                         if md.completed_epochs < md.total_epochs)
        if incomplete > snapshot["jobs"]:
            state = self.state_dict()
            for child in state["children"].values():
                for md in child["job_metadata"].values():
                    md["throughput_schedule"] = dict(
                        md["throughput_schedule"])
            snapshot.update(jobs=incomplete, round=self.round_index,
                            state=state)
        return real(self)

    CellPlanner.current_round_schedule = snapshotting
    try:
        run()
    finally:
        CellPlanner.current_round_schedule = real
    return snapshot["round"], snapshot["jobs"], snapshot["state"]


def ref_tier():
    from shockwave_tpu.core.scheduler import Scheduler
    from shockwave_tpu.data import load_or_synthesize_profiles, parse_trace
    from shockwave_tpu.data.default_oracle import generate_oracle
    from shockwave_tpu.policies import get_policy

    trace = str(bench_sim.TRACE_2048)
    jobs, arrivals = parse_trace(trace)
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(trace, jobs, oracle,
                                           worker_type="v100", cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    sched = Scheduler(
        get_policy("shockwave_tpu_pdhg", seed=0), throughputs=oracle, seed=0,
        time_per_iteration=bench_sim.ROUND_S, profiles=profiles,
        shockwave_config={"num_gpus": 256,
                          "time_per_iteration": bench_sim.ROUND_S,
                          "future_rounds": 20, "lambda": 5.0, "k": 10.0,
                          "cells": 4})
    return sched.simulate({"v100": 256}, arrivals, jobs)


def pricing(package: str, device: str = "cpu", tier: bool = True) -> dict:
    """The pricing decisions (``PricingDecision.as_record``): round 91 of
    the committed log with the CLI fixture's burst, and, with ``tier``,
    the tier's state with a burst of 8 jobs and the batch of bursts."""
    if package == "jax":
        from shockwave_tpu.core.job import Job
        from shockwave_tpu.whatif import (AdmissionPricer,
                                          base_problem_from_log,
                                          base_problem_from_state)
        kwargs = {}
    else:
        from shockwave_tpu_torch.core.job import Job
        from shockwave_tpu_torch.whatif import (AdmissionPricer,
                                                base_problem_from_log,
                                                base_problem_from_state)
        kwargs = {"device": device}

    def pricer(problem, keys, s0):
        holder = {"problem": problem, "keys": keys, "s0": s0}
        return AdmissionPricer(lambda: holder, budget_s=600.0, **kwargs)

    out = {}
    problem, keys, s0, _ = base_problem_from_log(
        str(FLIGHT_LOG), round_index=bench_sim.PRICING_LOG_ROUND)
    b = bench_sim.PRICING_LOG_BURST
    out["log"] = pricer(problem, keys, s0).price(burst_jobs(
        Job, b["jobs"], b["scale"], b["duration"])).as_record()
    if tier:
        rnd, jobs, state = tier_state(package, device)
        problem, keys, s0 = base_problem_from_state(state)
        p = pricer(problem, keys, s0)
        out["tier"] = {"round": rnd, "jobs": jobs,
                       "num_jobs": problem.num_jobs}
        out["tier_single"] = p.price(burst_jobs(
            Job, bench_sim.PRICING_TIER_BURST["jobs"])).as_record()
        bursts = bench_sim.pricing_bursts(Job)
        out["tier_batch"] = [d.as_record() for d in p.price_batch(bursts)]
        out["tier_sequential"] = [p.price(burst).as_record()
                                  for burst in bursts]
    return out


def capture(package: str, device: str = "cpu", tier: bool = True,
            only=None) -> dict:
    runs = {}
    for key, args, kwargs in bench_sim.sim_feature_runs():
        if only and key not in only:
            continue
        if package == "jax":
            r = ref_run(*args, **kwargs)
        else:
            r = bench_sim.run_trace(*args, device, **kwargs)
            r = {k: r[k] for k in (
                "makespan", "avg_jct", "worst_ftf", "unfair_fraction",
                "rounds", "faults", "recoveries", "worker_ids", "admitted",
                "lost_jobs", "dropped_jobs", "matches", "total_cost",
                "lease_extensions", "round_log", "wall_s")}
        runs[key] = r
        print(json.dumps({"key": key, **{k: r[k] for k in (
            "makespan", "avg_jct", "worst_ftf", "rounds", "faults",
            "lost_jobs", "dropped_jobs", "wall_s")}}), flush=True)
    out = {"package": package, "device": device, "runs": runs}
    if not only:
        out["pricing"] = pricing(package, device, tier)
        print(json.dumps({"pricing": out["pricing"]}), flush=True)
    return out


def compare_run(key: str, r: dict, ref: dict) -> list:
    """Where run ``r`` of cell ``key`` leaves the JAX package's ``ref``."""
    bad = bench_sim.check_run(r, {k: ref[k] for k in (
        "makespan", "avg_jct", "worst_ftf", "rounds")})
    r, ref = json.loads(json.dumps(r)), json.loads(json.dumps(ref))
    for k in ("faults", "worker_ids", "admitted", "lost_jobs",
              "dropped_jobs", "matches"):
        if r[k] != ref[k]:
            bad.append(f"{k} {r[k]} vs {ref[k]}")
    if bench_sim.recoveries_without_hashes(r["recoveries"]) != (
            bench_sim.recoveries_without_hashes(ref["recoveries"])):
        bad.append("recovery records differ")
    inexact = [k for k, v in (r["recoveries"] or {}).items()
               if "roundtrip_exact" in v and not v["roundtrip_exact"]]
    if inexact:
        bad.append(f"inexact HA round trips at events {inexact}")
    tol = bench_sim.TOLERANCE if "shockwave" in key or "pdhg" in key else 0.0
    bad += bench_sim.round_log_misses(r["round_log"], ref["round_log"],
                                      tol)[:5]
    return bad


def compare(a: dict, b: dict) -> dict:
    out = {}
    for key, ref in a["runs"].items():
        if key in b["runs"]:
            out[key] = compare_run(key, b["runs"][key], ref)
    for key in ("log", "tier_single"):
        if key in a.get("pricing", {}) and key in b.get("pricing", {}):
            out[f"pricing_{key}"] = bench_sim.decision_misses(
                b["pricing"][key], a["pricing"][key])
    if "tier_batch" in a.get("pricing", {}) and "tier_batch" in b.get(
            "pricing", {}):
        out["pricing_tier_batch"] = [
            f"lane {i}: {m}" for i, (x, y) in enumerate(zip(
                b["pricing"]["tier_batch"], a["pricing"]["tier_batch"]))
            for m in bench_sim.decision_misses(x, y)]
    return out


def load(path) -> dict:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def save(obj, path) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with opener(path, "wt") as f:
        json.dump(obj, f)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("capture")
    p.add_argument("--package", choices=("jax", "port"), required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--skip-tier", action="store_true")
    p.add_argument("--only", nargs="*", default=None,
                   help="run only these cells (no pricing)")
    p.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = parser.parse_args(argv)
    if args.cmd == "capture":
        result = capture(args.package, args.device, not args.skip_tier,
                         args.only)
        save(result, args.out)
        return result
    result = compare(load(args.a), load(args.b))
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
