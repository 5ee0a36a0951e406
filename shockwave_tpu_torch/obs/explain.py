"""Decision narratives: why the market did what it did to one job.

One pure function — :func:`narrative_from_records` — turns the flight
recorder's decision log into a per-job narrative: admission verdict →
queue wait → per-round share/price trail → preemptions with the
charged switch cost → degraded rounds → forecast vs realized. Both
consumers call exactly this function over exactly the same records:

* the live ``ExplainJob`` RPC (the scheduler flushes its recorder and
  reads its own log; see ``core/physical.py``), and
* the offline ``scripts/analysis/explain.py`` over a copied log,

so the live answer and the offline replay-derived answer are equal
field for field by construction — the property
``scripts/ci/explain_smoke.py`` gates.

Inputs consumed (all optional — a log without a record kind simply
yields narratives without that section):

* ``admission`` records (kind ``admitted``) — verdict, round, time;
* ``attribution`` records — the per-(job, round) market trail stamped
  by the planners (share vs fair share, price, bonus state, ladder);
* ``speculation`` records — a speculative attribution at round r is
  admitted into the trail only when the round-boundary reconcile
  committed that plan (kind ``hit``) and no live replan superseded it;
* ``round_context`` records — who actually ran, who was preempted.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

_TRAIL_COLUMNS = (
    "share",
    "fair_share",
    "welfare",
    "marginal",
    "price",
    "spend",
    "bonus",
    "bonus_state",
    "switch_cost",
    "makespan_binding",
    "predicted_finish_s",
)


def _resolve_attributions(records: list) -> list:
    """Attribution records that actually governed a round, in round
    order: live (non-speculative) records win; a speculative record
    stands only when the reconcile committed it (``hit``) and no live
    replan for the same round exists."""
    spec_outcome: Dict[int, str] = {}
    for rec in records:
        if rec.get("event") == "speculation":
            spec_outcome[int(rec.get("round", -1))] = rec.get("kind", "")
    live: Dict[int, dict] = {}
    speculative: Dict[int, dict] = {}
    for rec in records:
        if rec.get("event") != "attribution":
            continue
        rnd = int(rec.get("round", -1))
        if rec.get("speculative"):
            speculative[rnd] = rec
        else:
            live[rnd] = rec
    resolved = dict(live)
    for rnd, rec in speculative.items():
        if rnd not in resolved and spec_outcome.get(rnd) == "hit":
            resolved[rnd] = rec
    return [resolved[r] for r in sorted(resolved)]


def _job_row(att: dict, key: str) -> Optional[dict]:
    """One job's columns out of an attribution record's columnar jobs
    block, or None when the job is not in this record."""
    jobs = att.get("jobs") or {}
    keys = jobs.get("keys") or []
    try:
        i = keys.index(key)
    except ValueError:
        return None
    row = {}
    for col in _TRAIL_COLUMNS:
        values = jobs.get(col)
        row[col] = values[i] if values is not None else None
    cells = jobs.get("cell")
    if cells is not None:
        row["cell"] = cells[i]
    return row


def narrative_from_records(
    records: Iterable[dict], job_id: Optional[str] = None
):
    """Build decision narratives from decoded decision-log records.

    With ``job_id`` (the job's string key, e.g. ``"7"``): that job's
    narrative dict, or ``None`` if the log never saw the job. Without:
    ``{"jobs": {key: narrative, ...}}`` for every job in the log.
    Output is plain JSON data with deterministic ordering — byte-equal
    across live and offline derivations from the same log.
    """
    records = list(records)
    admissions: Dict[str, dict] = {}
    for rec in records:
        if rec.get("event") != "admission":
            continue
        if rec.get("kind") != "admitted" or "job_id" not in rec:
            continue
        key = str(rec["job_id"])
        if key in admissions:
            continue
        entry = {
            "round": rec.get("round"),
            "time_s": rec.get("time"),
            "token": rec.get("token"),
        }
        if "price" in rec:
            entry["price"] = rec["price"]
        admissions[key] = entry

    attributions = _resolve_attributions(records)
    rounds_ctx = []
    for rec in records:
        if rec.get("event") == "round_context":
            rounds_ctx.append(rec)
    rounds_ctx.sort(key=lambda r: int(r.get("round", -1)))

    all_keys = set(admissions)
    for att in attributions:
        all_keys.update((att.get("jobs") or {}).get("keys") or [])
    for ctx in rounds_ctx:
        all_keys.update((ctx.get("assignments") or {}).keys())
        all_keys.update(ctx.get("preempted") or [])

    wanted = sorted(all_keys) if job_id is None else [str(job_id)]
    out: Dict[str, dict] = {}
    for key in wanted:
        if key not in all_keys:
            continue
        out[key] = _one_narrative(key, admissions, attributions, rounds_ctx)
    if job_id is not None:
        return out.get(str(job_id))
    return {"jobs": out}


def _one_narrative(key, admissions, attributions, rounds_ctx) -> dict:
    trail = []
    migrations = []
    for att in attributions:
        rnd = int(att.get("round", -1))
        for m in att.get("migrations") or []:
            if str(m.get("job")) == key:
                migrations.append(
                    {
                        "round": rnd,
                        "src": m.get("src"),
                        "dst": m.get("dst"),
                        "gain": m.get("gain"),
                        "cost": m.get("cost"),
                    }
                )
        row = _job_row(att, key)
        if row is None:
            continue
        market = att.get("market") or {}
        entry = {
            "round": rnd,
            "backend": att.get("backend"),
            "degraded": bool(att.get("degraded", False)),
            "budget_dual": market.get("budget_dual"),
            "fairness_drift": market.get("fairness_drift"),
            **row,
        }
        if att.get("fallback_from") is not None:
            entry["fallback_from"] = att["fallback_from"]
        trail.append(entry)

    scheduled_rounds = []
    preemptions = []
    last_run_time = None
    for ctx in rounds_ctx:
        rnd = int(ctx.get("round", -1))
        if key in (ctx.get("assignments") or {}):
            scheduled_rounds.append(rnd)
            last_run_time = ctx.get("time")
        if key in (ctx.get("preempted") or []):
            # The switch cost the market charged for dropping the
            # incumbent: the forfeited bonus in the replan that
            # governed this round (the latest trail entry at <= rnd).
            charged = None
            for entry in reversed(trail):
                if entry["round"] <= rnd:
                    if entry.get("bonus_state") == "forfeited":
                        charged = entry.get("switch_cost")
                    break
            preemptions.append(
                {
                    "round": rnd,
                    "time_s": ctx.get("time"),
                    "switch_cost_charged": charged,
                }
            )

    admission = admissions.get(key)
    first_sched = scheduled_rounds[0] if scheduled_rounds else None
    queue_wait = None
    if (
        admission is not None
        and admission.get("round") is not None
        and first_sched is not None
    ):
        queue_wait = max(int(first_sched) - int(admission["round"]), 0)
    forecasts = [
        e["predicted_finish_s"]
        for e in trail
        if e.get("predicted_finish_s") is not None
    ]
    return {
        "job": key,
        "admission": admission,
        "queue_wait_rounds": queue_wait,
        "first_scheduled_round": first_sched,
        "last_scheduled_round": (
            scheduled_rounds[-1] if scheduled_rounds else None
        ),
        "rounds_run": len(scheduled_rounds),
        "trail": trail,
        "preemptions": preemptions,
        "degraded_rounds": [e["round"] for e in trail if e["degraded"]],
        "migrations": migrations,
        "forecast": {
            "first_predicted_finish_s": forecasts[0] if forecasts else None,
            "last_predicted_finish_s": forecasts[-1] if forecasts else None,
        },
        "realized": {
            "last_run_round": (
                scheduled_rounds[-1] if scheduled_rounds else None
            ),
            "last_run_time_s": last_run_time,
        },
    }


def narrative_from_log(path: str, job_id: Optional[str] = None):
    """Narratives from a decision log on disk (``.gz`` transparent) —
    the function both the live RPC callback and the offline CLI call."""
    from shockwave_tpu_torch.obs.recorder import iter_records

    return narrative_from_records(iter_records(path), job_id=job_id)
