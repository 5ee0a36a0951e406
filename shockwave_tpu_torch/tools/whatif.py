"""What-if fleet CLI: capacity planning against recorded planner state.

    python -m shockwave_tpu_torch.tools.whatif sweep \\
        --log results/flight_recorder/decisions.jsonl --round 91 \\
        --capacity 1,2,4,8 --priority-scale 0.5,1,2 --out sweep.json

The counterpart of the ``sweep`` subcommand of the JAX package's
``scripts/analysis/whatif.py``: load a decision log (``--log``, the
round of ``--round`` or the last) or an ``export-state`` artifact
(``--state``) of either package, build the scenario grid (the identity
baseline, then fleet sizes x weight scales x switch-cost scales x round
lengths), solve the whole grid as one launch of kernel A on ``--device``
(default ``cuda``; a block a scenario), audit every lane (or the first
``--audit-lanes``) against its one-lane launch in every bit, and print
and write (``--out``) the capacity-planning report: per-scenario welfare,
makespan and worst-FTF-proxy deltas, the batch's time against one
standalone solve and against the audited lanes launched one by one. Exits
1 if a lane differs from its one-lane launch in any bit.

    python -m shockwave_tpu_torch.tools.whatif price \\
        --log results/flight_recorder/decisions.jsonl --round 91 \\
        --burst-jobs 4 --burst-duration 3600

``price`` is the counterpart of the JAX package's ``cmd_price``: the
marginal-price admission decision of a hypothetical burst of
``--burst-jobs`` jobs against the recorded market (``whatif/pricing.py``:
the market with and without the burst as two lanes of one launch of
kernel A), beside what quota-only admission would decide. A first
``price()`` warms the launch (it builds the extension on the card) and
the second is reported. Exits 0.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import time


def _parse_floats(raw):
    return [float(x) for x in str(raw).split(",") if x.strip()]


def _load_base(args):
    """(problem, job_keys, s0, round, source) from --log or --state."""
    from shockwave_tpu_torch.obs.recorder import load_exported_state
    from shockwave_tpu_torch.whatif import (base_problem_from_log,
                                            base_problem_from_state)

    if args.state:
        envelope = load_exported_state(args.state)
        problem, keys, s0 = base_problem_from_state(envelope["planner_state"])
        return problem, keys, s0, envelope.get("round"), args.state
    problem, keys, s0, rnd = base_problem_from_log(args.log,
                                                   round_index=args.round)
    return problem, keys, s0, rnd, args.log


def build_grid(problem, capacity=None, priority_scale=None,
               switch_scale=None, round_s=None):
    """The identity baseline, then the cartesian grid of the comma lists
    (each defaulting to the base problem's value)."""
    from shockwave_tpu_torch.whatif import Scenario

    capacities = (_parse_floats(capacity) if capacity
                  else [float(problem.num_gpus)])
    pscales = _parse_floats(priority_scale) if priority_scale else [1.0]
    sscales = _parse_floats(switch_scale) if switch_scale else [1.0]
    durs = (_parse_floats(round_s) if round_s
            else [float(problem.round_duration)])
    scenarios = [Scenario(name="baseline")]
    for cap, ps, ss, dur in itertools.product(capacities, pscales, sscales,
                                              durs):
        scenarios.append(Scenario(
            name=f"g{cap:g}_p{ps:g}_s{ss:g}_d{dur:g}", num_gpus=cap,
            priority_scale=ps, switch_cost_scale=ss, round_duration=dur,
            tags={"capacity": cap, "priority_scale": ps,
                  "switch_cost_scale": ss, "round_s": dur}))
    return scenarios


# The JAX package's committed what-if fleet
# (scripts/microbenchmarks/bench_whatif_fleet.py::build_grid): 31 fleet
# sizes x 11 demand weights x 3 switch-cost knobs, with the baseline 1024
# scenarios (``sweep --capacity ... --priority-scale ... --switch-scale``).
FLEET_CAPACITIES = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                    40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                    320, 384, 448)
FLEET_PRIORITY_SCALES = (0.25, 0.5, 0.75, 1, 1.25, 1.5, 2, 2.5, 3, 4, 5)
FLEET_SWITCH_SCALES = (0, 1, 2)


def sweep(problem, scenarios, s0, device, audit_n: int = -1) -> dict:
    """Solve the grid as one launch (after a warm-up launch of the batch
    and of one lane), time it against one standalone solve (median of 5)
    and audit ``audit_n`` lanes (-1: every one) against their one-lane
    launches, timed as the lanes launched one by one. Returns the report
    without its source fields."""
    from shockwave_tpu_torch.whatif import (ScenarioBatch, audit_lanes,
                                            scenario_report, solve_scenario,
                                            solve_scenarios)

    batch = ScenarioBatch(problem, scenarios, s0=s0)
    solve_scenarios(batch, device=device)
    solve_scenario(batch, 0, device=device)
    t0 = time.monotonic()
    s_list, objs, diags = solve_scenarios(batch, device=device)
    batch_s = time.monotonic() - t0
    singles = []
    for _ in range(5):
        t0 = time.monotonic()
        solve_scenario(batch, 0, device=device)
        singles.append(time.monotonic() - t0)
    single_s = statistics.median(singles)
    audit_n = batch.lanes if audit_n < 0 else min(audit_n, batch.lanes)
    t0 = time.monotonic()
    audit = audit_lanes(batch, s_list, indices=range(audit_n), device=device)
    audit["one_by_one_s"] = time.monotonic() - t0
    return {
        "base": {"jobs": problem.num_jobs,
                 "num_gpus": float(problem.num_gpus),
                 "round_duration_s": float(problem.round_duration),
                 "future_rounds": int(problem.future_rounds)},
        "timing": {
            "device": str(device),
            "scenarios": len(scenarios),
            "lanes": batch.lanes,
            "lane_band": batch.band,
            "chunk": diags[0]["chunk"],
            "slots": batch.slots,
            "batch_solve_s": batch_s,
            "single_solve_s": single_s,
            "x_vs_single_solve": batch_s / max(single_s, 1e-9),
            "scenarios_per_s": len(scenarios) / max(batch_s, 1e-9),
            "max_cycles": max(d["cycles"] for d in diags),
        },
        "audit": audit,
        "scenarios": scenario_report(problem, scenarios, s_list, objs, diags),
    }


def cmd_sweep(args) -> int:
    from shockwave_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    problem, keys, s0, rnd, source = _load_base(args)
    scenarios = build_grid(problem, args.capacity, args.priority_scale,
                           args.switch_scale, args.round_s)
    print(f"{source} round {rnd}: {problem.num_jobs} jobs x "
          f"{len(scenarios)} scenarios on {device}")
    report = {"source": source, "round": rnd,
              **sweep(problem, scenarios, s0, device, args.audit_lanes)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    t, audit = report["timing"], report["audit"]
    print(f"batch {t['batch_solve_s']:.4f} s for {t['scenarios']} scenarios "
          f"in {t['lanes']} lanes, {t['chunk']} a launch "
          f"({t['scenarios_per_s']:.1f}/s) = {t['x_vs_single_solve']:.2f}x "
          f"one standalone solve ({t['single_solve_s']:.4f} s); audit "
          f"{audit['audited']} lanes one by one in "
          f"{audit['one_by_one_s']:.4f} s, "
          f"bit_identical={audit['bit_identical']}")
    rows = report["scenarios"]
    best = max(rows[1:], key=lambda r: r["nash_welfare_delta"], default=None)
    if best is not None:
        print(f"best scenario {best['name']}: welfare "
              f"{best['nash_welfare_delta']:+.4f}, makespan "
              f"{best['makespan_delta_s']:+.0f}s")
    return 0 if audit["bit_identical"] else 1


def burst_jobs(job_cls, count: int, scale: int = 1, duration=None,
               priority: float = 1.0,
               job_type: str = "ResNet-18 (batch size 32)") -> list:
    """``count`` hypothetical jobs of ``job_cls`` (either package's
    ``Job``) as ``price`` submits them: ``duration`` seconds of demand
    each, or the whole planning window where it is None."""
    return [job_cls(job_type=job_type, command="whatif-burst",
                    total_steps=1000, scale_factor=int(scale),
                    mode="static", priority_weight=float(priority),
                    duration=float(duration) if duration else None)
            for _ in range(count)]


def cmd_price(args) -> int:
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.utils.device import resolve_device
    from shockwave_tpu_torch.utils.fileio import atomic_write_json
    from shockwave_tpu_torch.whatif import AdmissionPricer

    device = resolve_device(args.device)
    problem, keys, s0, rnd, source = _load_base(args)
    burst = burst_jobs(Job, args.burst_jobs, args.burst_scale,
                       args.burst_duration, args.burst_priority,
                       args.burst_job_type)
    # Offline pricing against a recorded state: the provider hands the
    # pricer the market already built.
    state_holder = {"problem": problem, "keys": keys, "s0": s0}
    pricer = AdmissionPricer(
        state_provider=lambda: state_holder,
        threshold=args.threshold,
        budget_s=args.budget_s,
        device=device,
    )
    # The first call builds and loads the kernel; the second is the
    # operator's decision.
    pricer.price(burst)
    decision = pricer.price(burst)
    # Quota-only admission accepts any batch of a tenant under its quota.
    quota_only = (
        "reject"
        if args.tenant_quota is not None and len(burst) > args.tenant_quota
        else "accept"
    )
    report = {
        "source": source,
        "round": rnd,
        "device": str(device),
        "base": {"jobs": problem.num_jobs,
                 "num_gpus": float(problem.num_gpus)},
        "burst": {
            "jobs": args.burst_jobs,
            "scale_factor": args.burst_scale,
            "duration_s": args.burst_duration,
            "priority_weight": args.burst_priority,
            "tenant": args.tenant,
        },
        "threshold": args.threshold,
        "quota_only_decision": quota_only,
        "priced_decision": decision.as_record(),
        "improved": (decision.action in ("accept", "reject")
                     and decision.action != quota_only),
    }
    if args.out:
        atomic_write_json(args.out, report)
        print(f"wrote {args.out}")
    print(json.dumps(report["priced_decision"]))
    print(f"quota-only would {quota_only}; marginal price says "
          f"{decision.action} ({decision.reason})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="what-if fleet: batched counterfactual EG solves")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_source(p):
        p.add_argument("--log", default=None,
                       help="decision log to seed from")
        p.add_argument("--state", default=None,
                       help="export-state artifact to seed from")
        p.add_argument("--round", type=int, default=None,
                       help="planning round (default: last recorded plan)")
        p.add_argument("--out", default=None, help="JSON report path")
        p.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a card) or cpu")

    p_sweep = sub.add_parser("sweep",
                             help="batched capacity-planning scenario sweep")
    add_source(p_sweep)
    p_sweep.add_argument("--capacity", default=None,
                         help="comma list of fleet sizes (chips)")
    p_sweep.add_argument("--priority-scale", default=None,
                         help="comma list of demand-weight scales")
    p_sweep.add_argument("--switch-scale", default=None,
                         help="comma list of switch-cost scales")
    p_sweep.add_argument("--round-s", default=None,
                         help="comma list of round lengths (seconds)")
    p_sweep.add_argument("--audit-lanes", type=int, default=-1,
                         help="lanes to audit against their one-lane "
                         "launches (-1 = every scenario)")
    p_price = sub.add_parser(
        "price", help="marginal-price one hypothetical admission burst")
    add_source(p_price)
    p_price.add_argument("--burst-jobs", type=int, default=4)
    p_price.add_argument("--burst-scale", type=int, default=1)
    p_price.add_argument(
        "--burst-duration", type=float, default=None,
        help="per-job demand seconds (default: the full planning window)")
    p_price.add_argument("--burst-priority", type=float, default=1.0)
    p_price.add_argument("--burst-job-type",
                         default="ResNet-18 (batch size 32)")
    p_price.add_argument("--tenant", default="whatif")
    p_price.add_argument(
        "--tenant-quota", type=int, default=None,
        help="pending-job quota the quota-only comparison applies "
        "(default: none, so quota-only accepts)")
    p_price.add_argument(
        "--threshold", type=float, default=1e-3,
        help="the incumbents' largest welfare loss before a rejection "
        "(default: the solver-noise floor)")
    p_price.add_argument("--budget-s", dest="budget_s", type=float,
                         default=60.0)

    args = parser.parse_args(argv)
    if not args.log and not args.state:
        parser.error("one of --log / --state is required")
    if args.cmd == "sweep":
        return cmd_sweep(args)
    return cmd_price(args)


if __name__ == "__main__":
    raise SystemExit(main())
