"""Causal span-tree reconstruction and fleet-trace merging.

The logic behind ``scripts/analysis/merge_traces.py`` and
``report_run.py``'s per-job latency budget, importable so the physical
drivers can compute the same breakdown from the live tracer's events.

Spans/instants stamped by :mod:`shockwave_tpu_torch.obs.propagate` carry
``trace_id`` / ``span_id`` / ``parent_span_id`` in their Chrome-trace
``args``; one ``trace_id`` is one job's (or operation's) causal chain.
This module groups events into chains (:func:`collect_chains`), checks
tree connectivity across processes (:func:`chain_summary`), merges
per-process trace files onto the scheduler's clock using each file's
``otherData.clock`` anchor + NTP offset (:func:`merge_traces`), and
derives the per-job critical-path/latency-budget breakdown —
queue-wait, plan-exposed, dispatch, run, sync —
(:func:`latency_budget`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_JOB_INTS = re.compile(r"\d+")


def _job_keys(value) -> List[str]:
    """Member job ids of a (possibly packed) job-id repr: ``4`` ->
    ``["4"]``, ``"(3, 7)"`` -> ``["3", "7"]`` — a packed pair's
    dispatch/run span belongs to BOTH members' budgets."""
    return _JOB_INTS.findall(str(value)) or [str(value)]

# -- chain collection ---------------------------------------------------


def _iter_causal(events):
    for e in events:
        args = e.get("args") or {}
        trace_id = args.get("trace_id")
        if trace_id:
            yield trace_id, e, args


def collect_chains(events) -> Dict[str, dict]:
    """Group causally-stamped events by ``trace_id``. Each chain is
    ``{"spans": [...], "instants": [...], "nodes": {span_id: event},
    "pids": set}`` — instants that carry their own ``span_id`` (the
    submit instant naming the chain's root) count as nodes too."""
    chains: Dict[str, dict] = {}
    for trace_id, e, args in _iter_causal(events):
        chain = chains.setdefault(
            trace_id,
            {"spans": [], "instants": [], "nodes": {}, "pids": set()},
        )
        if e.get("ph") == "X":
            chain["spans"].append(e)
        elif e.get("ph") == "i":
            chain["instants"].append(e)
        span_id = args.get("span_id")
        if span_id:
            chain["nodes"].setdefault(span_id, e)
        if "pid" in e:
            chain["pids"].add(e["pid"])
    return chains


def chain_summary(chain: dict) -> dict:
    """Connectivity facts for one chain: a chain is CONNECTED when it
    has exactly one root node (no parent, or a parent nobody in the
    chain names as a node — the wire-carried root) and every other
    node's parent resolves inside the chain."""
    nodes = chain["nodes"]
    node_ids = set(nodes)
    # Parents referenced by events that are not themselves nodes (e.g.
    # the root context referenced by child spans when the root span
    # lives in an unmerged file) count as dangling.
    roots, dangling = [], []
    for span_id, e in nodes.items():
        parent = (e.get("args") or {}).get("parent_span_id")
        if not parent:
            roots.append(span_id)
        elif parent not in node_ids:
            dangling.append((span_id, parent))
    # Instants linked under a node (parent_span_id without own span_id)
    # never break connectivity; they just need a resolvable parent.
    loose_instants = 0
    for e in chain["instants"]:
        args = e.get("args") or {}
        if args.get("span_id"):
            continue
        parent = args.get("parent_span_id")
        if parent and parent not in node_ids:
            loose_instants += 1
    # A single dangling parent shared by every parentless node is the
    # implicit root (context minted on the wire, its span in no file).
    implicit_roots = {p for _, p in dangling}
    connected = (
        len(nodes) > 0
        and (
            (len(roots) == 1 and not dangling)
            or (not roots and len(implicit_roots) == 1)
            or (len(roots) + len(implicit_roots) == 1)
        )
    )
    return {
        "nodes": len(nodes),
        "spans": len(chain["spans"]),
        "instants": len(chain["instants"]),
        "processes": len(chain["pids"]),
        "roots": roots,
        "dangling_parents": dangling,
        "loose_instants": loose_instants,
        "connected": connected,
    }


# -- merging ------------------------------------------------------------


def _clock_of(trace: dict) -> Tuple[float, float]:
    """(wall_at_zero_s, offset_to_scheduler_s) from a dump's
    otherData; (0, 0) for dumps with no anchor (merge degrades to
    no-shift)."""
    other = trace.get("otherData") or {}
    clock = other.get("clock") or {}
    return (
        float(clock.get("wall_at_zero_s", 0.0) or 0.0),
        float(clock.get("offset_to_scheduler_s", 0.0) or 0.0),
    )


def _role_of(trace: dict) -> str:
    return str((trace.get("otherData") or {}).get("role", "") or "")


def merge_traces(traces: List[dict]) -> dict:
    """Fuse per-process Chrome trace dumps into ONE fleet trace aligned
    to the scheduler's clock.

    * The reference file is the one whose ``otherData.role`` is
      ``scheduler`` (else the first); every other file's timestamps are
      shifted by ``(wall_at_zero + ntp_offset) - reference's`` so all
      timelines read in scheduler seconds.
    * pid/tid ints are remapped into disjoint ranges; process names are
      suffixed with the source's role/worker identity so two worker
      agents' "worker" tracks stay distinguishable.
    * For every cross-process parent->child span edge, a Chrome flow
      event pair (``ph: s``/``f``) is synthesized so Perfetto draws the
      causal arrows.
    """
    if not traces:
        raise ValueError("no traces to merge")
    ref_index = 0
    for i, trace in enumerate(traces):
        if _role_of(trace) == "scheduler":
            ref_index = i
            break
    ref_wall, ref_offset = _clock_of(traces[ref_index])
    ref_anchor = ref_wall + ref_offset

    merged_events: list = []
    sources: list = []
    pid_base = 0
    for i, trace in enumerate(traces):
        events = trace.get("traceEvents") or []
        wall, offset = _clock_of(trace)
        anchor = wall + offset
        shift_us = (
            (anchor - ref_anchor) * 1e6 if anchor and ref_anchor else 0.0
        )
        role = _role_of(trace) or f"file{i}"
        other = trace.get("otherData") or {}
        suffix = ""
        if i != ref_index:
            worker = other.get("worker")
            suffix = f" [{role}{'' if worker is None else ' ' + str(worker)}]"
        max_pid = 0
        for e in events:
            e = dict(e)
            if "pid" in e:
                max_pid = max(max_pid, int(e["pid"]))
                e["pid"] = int(e["pid"]) + pid_base
            if "ts" in e:
                e["ts"] = e["ts"] + shift_us
            if (
                suffix
                and e.get("ph") == "M"
                and e.get("name") == "process_name"
            ):
                e["args"] = {
                    **(e.get("args") or {}),
                    "name": (e.get("args") or {}).get("name", "") + suffix,
                }
            merged_events.append(e)
        sources.append(
            {
                "index": i,
                "role": role,
                "worker": other.get("worker"),
                "events": len(events),
                "shift_s": round(shift_us / 1e6, 6),
                "clock_offset_s": offset,
                "reference": i == ref_index,
            }
        )
        pid_base += max_pid + 16

    # Cross-process causal flow arrows.
    span_by_id: Dict[str, dict] = {}
    for e in merged_events:
        if e.get("ph") != "X":
            continue
        span_id = (e.get("args") or {}).get("span_id")
        if span_id:
            span_by_id.setdefault(span_id, e)
    flow_id = 0
    flows: list = []
    for e in merged_events:
        if e.get("ph") != "X":
            continue
        parent_id = (e.get("args") or {}).get("parent_span_id")
        parent = span_by_id.get(parent_id) if parent_id else None
        if parent is None or parent.get("pid") == e.get("pid"):
            continue
        flow_id += 1
        flows.append(
            {
                "ph": "s", "cat": "causal", "name": "causal",
                "id": flow_id, "pid": parent["pid"],
                "tid": parent.get("tid", 0), "ts": parent["ts"],
            }
        )
        flows.append(
            {
                "ph": "f", "bp": "e", "cat": "causal", "name": "causal",
                "id": flow_id, "pid": e["pid"],
                "tid": e.get("tid", 0), "ts": e["ts"],
            }
        )
    merged_events.extend(flows)

    return {
        "traceEvents": merged_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "shockwave_tpu_torch.obs.spantree",
            "merged": True,
            "sources": sources,
            "flow_edges": flow_id,
        },
    }


# -- latency budget -----------------------------------------------------


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def latency_budget(events) -> Dict[str, dict]:
    """Per-job critical-path breakdown from causally-stamped events
    (seconds): ``queue_wait`` (submit/arrival -> admission),
    ``plan_exposed`` (solver spans overlapping the job's
    admission->first-dispatch window — the plan bill the job could
    actually see), ``dispatch`` (dispatch span), ``run`` (worker run
    spans when merged, else dispatch-end -> completion), ``sync``
    (last run end -> completion instant), ``total``
    (submit -> completion). Keyed by job id. Works on a single
    scheduler-side trace (coarser run/sync) or a merged fleet trace
    (true worker run spans)."""
    admitted: Dict[str, dict] = {}
    completed: Dict[str, float] = {}
    by_trace_job: Dict[str, str] = {}
    dispatches: Dict[str, list] = {}
    runs: Dict[str, list] = {}
    solves: list = []
    for e in events:
        args = e.get("args") or {}
        name = e.get("name", "")
        ts_s = e.get("ts", 0.0) / 1e6
        if e.get("ph") == "i":
            if name == "job_admitted":
                job = str(args.get("job_id"))
                admitted[job] = {
                    "admitted_s": ts_s,
                    "arrival_s": float(args.get("arrival_s", ts_s)),
                    "trace_id": args.get("trace_id"),
                }
                if args.get("trace_id"):
                    by_trace_job[args["trace_id"]] = job
            elif name == "job_complete":
                completed[str(args.get("job_id"))] = ts_s
            continue
        if e.get("ph") != "X":
            continue
        dur_s = e.get("dur", 0.0) / 1e6
        if name == "dispatch":
            for job in _job_keys(args.get("job_id")):
                dispatches.setdefault(job, []).append((ts_s, dur_s))
        elif name.startswith("run job "):
            # Sim run spans name the (possibly packed) key; the name is
            # authoritative — a packed pair's single span credits BOTH
            # members (its trace args only carry the first member's
            # chain, so the trace_id route would drop the second).
            for job in _job_keys(name[len("run job "):]):
                runs.setdefault(job, []).append((ts_s, dur_s))
        elif name == "run_job":
            trace_id = args.get("trace_id")
            job = by_trace_job.get(trace_id) if trace_id else None
            if job is None:
                job_arg = args.get("job_id")
                job = str(job_arg) if job_arg is not None else None
            if job is not None:
                runs.setdefault(job, []).append((ts_s, dur_s))
        elif name.startswith("solve:"):
            solves.append((ts_s, dur_s))
    budgets: Dict[str, dict] = {}
    for job, info in admitted.items():
        end = completed.get(job)
        if end is None:
            continue
        t_submit = min(info["arrival_s"], info["admitted_s"])
        t_admit = info["admitted_s"]
        job_dispatches = sorted(dispatches.get(job, ()))
        t_first_dispatch = (
            job_dispatches[0][0] if job_dispatches else t_admit
        )
        dispatch_s = sum(d for _, d in job_dispatches)
        plan_s = sum(
            _overlap(s, s + d, t_admit, t_first_dispatch)
            for s, d in solves
        )
        job_runs = sorted(runs.get(job, ()))
        if job_runs:
            run_s = sum(d for _, d in job_runs)
            last_run_end = max(s + d for s, d in job_runs)
            sync_s = max(0.0, end - last_run_end)
        else:
            run_s = max(0.0, end - t_first_dispatch - dispatch_s)
            sync_s = 0.0
        budgets[job] = {
            "queue_wait_s": round(max(0.0, t_admit - t_submit), 6),
            "plan_exposed_s": round(plan_s, 6),
            "dispatch_s": round(dispatch_s, 6),
            "run_s": round(run_s, 6),
            "sync_s": round(sync_s, 6),
            "total_s": round(max(0.0, end - t_submit), 6),
            "dispatches": len(job_dispatches),
            "run_spans": len(job_runs),
            "trace_id": info.get("trace_id"),
        }
    return budgets


def budget_fleet_summary(budgets: Dict[str, dict]) -> Optional[dict]:
    """Mean per-phase seconds over every per-job budget (None when
    empty) — the summary.json / report_run fleet row."""
    if not budgets:
        return None
    keys = ("queue_wait_s", "plan_exposed_s", "dispatch_s", "run_s",
            "sync_s", "total_s")
    n = len(budgets)
    return {
        "jobs": n,
        **{
            f"mean_{k}": round(sum(b[k] for b in budgets.values()) / n, 6)
            for k in keys
        },
    }
