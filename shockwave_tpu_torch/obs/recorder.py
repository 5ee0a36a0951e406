"""Flight recorder: an append-only JSONL log of scheduling decisions.

The port's copy of the JAX package's ``shockwave_tpu/obs/recorder.py``:
writer, reader and replay. Every planning round the Shockwave planner
makes, the recorder snapshots the full planner input (per-job predictor
metadata, remaining-runtime forecasts, finish-time history, incumbents
and switching costs) and the decision it produced (the plan window, its
EG objective, the backend that solved it, the solve record). The
scheduler adds one ``round_context`` record per executed round, so a
dump answers "why did job 7 get preempted in round 41" without a
cluster. A planner's ``state_dict()`` holds host numpy only, so what the
recorder encodes never touches the card; the encoded strings are the
JAX package's for the same state, and a log written by either package
replays in either.

Records queue on the hot path and are encoded and appended at
:meth:`FlightRecorder.flush` (every ``FLUSH_EVERY`` records and at
close) in one ``O_APPEND`` write: a killed run keeps every flushed
decision, and readers skip at most one truncated final line.

Replay: :func:`replay_plan_record` restores the recorded planner state
(:func:`shockwave_tpu_torch.policies.shockwave.planner_from_state`) and
re-runs ``_replan`` offline, then diffs the produced plan window against
the recorded one. An empty diff for every record means the log is a
faithful, deterministic account of the run.

CLI (replay solves on the card unless ``--device cpu`` is given)::

    python -m shockwave_tpu_torch.obs.recorder summary results/run/decisions.jsonl
    python -m shockwave_tpu_torch.obs.recorder replay  results/run/decisions.jsonl [--round 12]
    python -m shockwave_tpu_torch.obs.recorder export-state results/run/decisions.jsonl --round 12

``export-state`` writes one round's restorable planner state, the input
of the what-if fleet (:mod:`shockwave_tpu_torch.whatif`); an artifact
written here (:func:`write_state`, the same envelope) loads in either
package.

Disabled by default (``FlightRecorder.enabled`` is False) behind the
same null-object contract as the rest of :mod:`shockwave_tpu_torch.obs`:
every ``record_*`` call is one attribute check and an early return, so
un-instrumented runs stay bit-identical.
"""

from __future__ import annotations

import copy
import gzip
import json
import os
import tempfile
from collections import OrderedDict
from typing import Iterator, List, Optional

import numpy as np

from shockwave_tpu_torch.analysis import sanitize

SCHEMA = "shockwave-decisions-v1"


# ----------------------------------------------------------------------
# JSON codec: planner state holds numpy arrays, JobId keys, int-keyed
# dicts and tuples, none of which survive plain JSON. Every container is
# tagged so decode() restores the exact object graph state_dict() made.
# ----------------------------------------------------------------------
# Exact types that encode and decode return as they are: a container's
# such members are copied without a call apiece (a scheduler's HA state
# holds about a million of them, in profiles and histories).
_SCALARS = frozenset((bool, int, float, str, type(None)))


class _Scalars(list):
    """A list the builder guarantees holds only JSON scalars; encode()
    passes it through without the per-element type scan."""

    __slots__ = ()


def encode(obj):
    from shockwave_tpu_torch.core.ids import JobId

    if type(obj) is _Scalars:
        return obj
    if obj is None or isinstance(obj, (bool, str, int, float)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        # Epoch profiles hold a handful of constant runs: run-length
        # encode where it pays. Both forms round-trip exactly.
        if obj.ndim == 1 and obj.size >= 32:
            boundaries = np.flatnonzero(obj[1:] != obj[:-1]) + 1
            if boundaries.size + 1 <= obj.size // 4:
                starts = np.concatenate(([0], boundaries))
                ends = np.concatenate((boundaries, [obj.size]))
                return {"__ndrle__": obj.dtype.str,
                        "runs": _Scalars(x for s, e in zip(starts, ends)
                                         for x in (obj[s].item(),
                                                   int(e - s)))}
        return {"__nd__": obj.dtype.str, "data": _Scalars(obj.tolist())}
    if isinstance(obj, JobId):
        return {"__jobid__": list(obj)}
    if isinstance(obj, tuple):
        return {"__tuple__": [x if type(x) in _SCALARS else encode(x)
                              for x in obj]}
    if isinstance(obj, dict):
        return {"__pairs__": [
            [k if type(k) in _SCALARS else encode(k),
             v if type(v) in _SCALARS else encode(v)]
            for k, v in obj.items()],
                "__od__": isinstance(obj, OrderedDict)}
    if isinstance(obj, (list, set)):
        return [x if type(x) in _SCALARS else encode(x) for x in obj]
    raise TypeError(f"flight recorder cannot encode {type(obj).__name__!r}")


def decode(obj):
    from shockwave_tpu_torch.core.ids import JobId

    if isinstance(obj, list):
        return [x if type(x) in _SCALARS else decode(x) for x in obj]
    if not isinstance(obj, dict):
        return obj
    if "__nd__" in obj:
        return np.asarray(obj["data"], dtype=np.dtype(obj["__nd__"]))
    if "__ndrle__" in obj:
        flat = obj["runs"]
        values = np.asarray(flat[0::2], dtype=np.dtype(obj["__ndrle__"]))
        counts = np.asarray(flat[1::2], dtype=np.int64)
        return np.repeat(values, counts)
    if "__jobid__" in obj:
        return JobId(*obj["__jobid__"])
    if "__tuple__" in obj:
        return tuple(x if type(x) in _SCALARS else decode(x)
                     for x in obj["__tuple__"])
    if "__pairs__" in obj:
        cls = OrderedDict if obj.get("__od__") else dict
        return cls((k if type(k) in _SCALARS else decode(k),
                    v if type(v) in _SCALARS else decode(v))
                   for k, v in obj["__pairs__"])
    # Plain JSON object (a record envelope, not planner state).
    return {k: decode(v) for k, v in obj.items()}


def _job_key(job_id) -> str:
    """Stable string identity for a job across record/replay (JobId in
    real runs, arbitrary hashables in unit fixtures)."""
    return str(job_id)


# ----------------------------------------------------------------------
# JobMetadata state splitting. A planner snapshot is dominated by
# per-job epoch arrays that never change after admission; serializing
# them into EVERY plan record made the log ~1 MB/record. Instead the
# immutable profile is emitted once per job (a ``job_profile`` record)
# and plan records carry only the dynamic fields plus a reference;
# derived fields (the rescaled ``epoch_durations`` and its memo keys)
# are dropped entirely and recomputed at replay — the rescale is a pure,
# idempotent function of the throughput schedule
# (JobMetadata.recompute_epoch_durations).
# ----------------------------------------------------------------------
_MD_STATIC_FIELDS = (
    "total_epochs",
    "nsamples_per_epoch",
    "nworkers",
    "epoch_batch_sizes",
    "estimated_epoch_durations",
    "regimes",
    "dirichlet",
    "round_duration",
)
# Schema-parity fields no planner math reads (profiles.py synthesizes
# them as zeros): dropped from the log, rebuilt empty at replay.
_MD_DROPPED_FIELDS = ("epoch_mem_reqs", "epoch_gpu_reqs")
_MD_DYNAMIC_FIELDS = (
    "completed_epochs",
    "submit_time",
    "_schedule_version",
)


def _profile_fingerprint(md_state: dict) -> tuple:
    """Cheap change tripwire for the statically-assumed profile fields
    (they are immutable by construction; a mismatch re-emits)."""
    est = md_state["estimated_epoch_durations"]
    return (
        md_state["total_epochs"],
        md_state["nsamples_per_epoch"],
        md_state["round_duration"],
        len(est),
        float(est[0]) if len(est) else 0.0,
        float(est[-1]) if len(est) else 0.0,
    )


def _split_metadata_state(md_state: dict, emitted_rounds: int = 0):
    """``emitted_rounds`` entries of the throughput schedule were
    already logged by earlier plan records for this job; only the tail
    is carried (the schedule is append-only — rounds execute once), as
    three parallel scalar lists so encode() skips per-entry recursion.
    Returns (static profile, dynamic record, total schedule length)."""
    static = {f: md_state[f] for f in _MD_STATIC_FIELDS}
    dynamic = {f: md_state[f] for f in _MD_DYNAMIC_FIELDS}
    schedule = md_state["throughput_schedule"]
    rounds = sorted(schedule)[emitted_rounds:]
    dynamic["tput_base"] = int(emitted_rounds)
    dynamic["tput_rounds"] = _Scalars(int(r) for r in rounds)
    dynamic["tput_values"] = _Scalars(float(schedule[r][0]) for r in rounds)
    dynamic["tput_bss"] = _Scalars(int(schedule[r][1]) for r in rounds)
    return static, dynamic, len(schedule)


def _rebuild_metadata_state(profile: dict, dynamic: dict,
                            schedule: "Optional[dict]" = None) -> dict:
    state = {**profile, **dynamic}
    state.pop("tput_base", None)
    inline = {r: (t, b) for r, t, b in zip(state.pop("tput_rounds"),
                                           state.pop("tput_values"),
                                           state.pop("tput_bss"))}
    state["throughput_schedule"] = inline if schedule is None else schedule
    for field in _MD_DROPPED_FIELDS:
        state[field] = []
    # Derived fields: the as-profiled durations with the memo keys
    # cleared, so the first recompute_epoch_durations() re-applies the
    # measured-throughput rescale.
    state["epoch_durations"] = np.asarray(
        profile["estimated_epoch_durations"], dtype=np.float64).copy()
    state["_rescale_key"] = None
    state["_bs_durations_cache"] = None
    return state


# ----------------------------------------------------------------------
# The recorder.
# ----------------------------------------------------------------------
class FlightRecorder:
    """Append-only decision log, process-global like the metrics
    registry (see :mod:`shockwave_tpu_torch.obs`).

    Recording must not perturb the system it observes, so the hot path
    does only mutation-safety work: planner snapshots are SPLIT into
    freshly-built / immutable-by-construction structures and queued.
    JSON encoding and the actual appends happen in :meth:`flush` —
    automatically every ``FLUSH_EVERY`` records (bounding both memory
    and crash-loss) and at :meth:`close` (which every driver's export
    path calls). Appends go through
    :func:`~shockwave_tpu_torch.utils.fileio.atomic_append_text`, one
    ``O_APPEND`` write per batch.
    """

    # Memory/crash-loss bound, not a hot-path cadence: at ~3 KB per
    # queued record this caps the buffer near 12 MB. Long-running
    # physical drivers hit it between rounds; short sims flush once at
    # close.
    FLUSH_EVERY = 4096

    def __init__(self, enabled: bool = False, path: Optional[str] = None):
        self.enabled = enabled
        self.path = path
        self.num_records = 0
        self._lock = sanitize.make_lock("obs.recorder.FlightRecorder._lock")
        self._pending: list = []
        # job key -> fingerprint of the job_profile already emitted.
        self._profiles_emitted: dict = {}
        # job key -> throughput-schedule entries already logged (plan
        # records carry only the tail since the previous one).
        self._tput_emitted: dict = {}

    def configure(self, path: str) -> None:
        """Point the recorder at a log path and enable it; queues a
        header record so readers can sanity-check the schema."""
        with self._lock:
            self.path = path
            self.enabled = True
            self.num_records = 0
            self._pending = []
            self._profiles_emitted = {}
            self._tput_emitted = {}
        # _append/flush re-take the lock; queue the header after release.
        self._append({"event": "header", "schema": SCHEMA})
        self.flush()

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self.path = None
            self.num_records = 0
            self._pending = []
            self._profiles_emitted = {}
            self._tput_emitted = {}

    def close(self) -> None:
        self.flush()
        with self._lock:
            self.enabled = False

    def _append(self, record: dict) -> None:
        with self._lock:
            self._pending.append(record)
            self.num_records += 1
            should_flush = len(self._pending) >= self.FLUSH_EVERY
        if should_flush:
            self.flush()

    def flush(self) -> None:
        """Slim, encode and append every queued record — all the real
        packaging work, off the scheduling hot path."""
        from shockwave_tpu_torch.utils.fileio import atomic_append_text

        with self._lock:
            pending, self._pending = self._pending, []
            if not pending or self.path is None:
                return
            lines = []
            for record in pending:
                raw = record.pop("planner_state_raw", None)
                if raw is not None:
                    record["planner_state"] = self._slim_planner_state(
                        raw, lines,
                        advance=not record.get("speculative"),
                    )
                for field in ("planner_state", "profile", "problem"):
                    if field in record:
                        record[field] = encode(record[field])
                lines.append(json.dumps(record, separators=(",", ":")))
            atomic_append_text(self.path, "\n".join(lines) + "\n")

    def _slim_planner_state(
        self, planner_state: dict, lines: list, advance: bool = True
    ) -> dict:
        """Compact a raw planner snapshot for one plan record: factor
        each job's immutable profile out into a ``job_profile`` record
        (appended to ``lines`` ahead of the plan record, once per job),
        delta-encode the append-only throughput schedules, pack tuple
        histories into scalar lists, and drop pure-output fields.
        A cell-set (federated) snapshot slims each child planner's
        state the same way. Caller holds the lock.

        ``advance=False`` (speculative plan records) slims as a
        SELF-CONTAINED overlay: the full throughput schedule is
        emitted (base 0) and the accumulation base is NOT advanced — a
        speculative clone's tails carry PREDICTED entries the live
        planner may never see (physical mode measures different
        values), folding them in would corrupt every downstream live
        record's delta encoding, and delta-encoding them against the
        live base would race mid-round live plan records queued
        between the speculation snapshot and this flush (the live
        record advances the base past measured entries the clone's
        snapshot predates, silently shifting the slice). Replay
        rebuilds these records from the overlay alone (see
        :func:`replay_log`)."""
        if "children" in planner_state:
            slim_state = dict(planner_state)
            slim_state["children"] = OrderedDict(
                (
                    name,
                    self._slim_planner_state(
                        child_state, lines, advance=advance
                    ),
                )
                for name, child_state in planner_state["children"].items()
            )
            return slim_state
        slim_state = dict(planner_state)
        slim_state["job_metadata"] = slim_md = OrderedDict()
        # The solve history is observability output, not planner input;
        # the plan cache is pure output too (_replan prunes then
        # overwrites the whole window) — replay reads neither. The one
        # solver input derived from the pre-replan cache — the pdhg
        # solution warm start — is recorded as its own slim vector
        # (``pdhg_warm_start``, stamped by _replan) instead.
        slim_state["solve_times"] = []
        slim_state["solve_records"] = []
        slim_state["schedules"] = OrderedDict()
        slim_state["finish_time_estimates"] = {
            job: {
                "rounds": _Scalars(int(r) for r, _ in history),
                "estimates": _Scalars(float(ft) for _, ft in history),
            }
            for job, history in planner_state[
                "finish_time_estimates"
            ].items()
        }
        for job_id, md_state in planner_state["job_metadata"].items():
            key = _job_key(job_id)
            static, dynamic, emitted = _split_metadata_state(
                md_state,
                self._tput_emitted.get(key, 0) if advance else 0,
            )
            if advance:
                self._tput_emitted[key] = emitted
            fingerprint = _profile_fingerprint(md_state)
            if self._profiles_emitted.get(key) != fingerprint:
                lines.append(
                    json.dumps(
                        {
                            "event": "job_profile",
                            "job": key,
                            "profile": encode(static),
                        },
                        separators=(",", ":"),
                    )
                )
                self.num_records += 1
                self._profiles_emitted[key] = fingerprint
            dynamic["__profile_ref__"] = key
            # Keep the original key type: the planner state round-trips
            # through encode(), which preserves JobId/ints.
            slim_md[job_id] = dynamic
        return slim_state

    # -- emission -------------------------------------------------------
    def record_plan(
        self,
        planner_state: dict,
        plan: dict,
        backend: str,
        objective: Optional[float],
        solve_record: Optional[dict] = None,
        problem_summary: Optional[dict] = None,
        pool: Optional[str] = None,
        tags: Optional[dict] = None,
    ) -> None:
        """One planning decision: ``planner_state`` is the PRE-replan
        :meth:`ShockwavePlanner.state_dict` snapshot (replay re-enters
        ``_replan`` from it), ``plan`` maps round offset -> scheduled
        job keys, ``problem_summary`` the solver-facing arrays (job
        order, forecasts, priorities, switching costs, incumbents).
        ``tags`` merges extra envelope fields — a speculative clone
        stamps ``{"speculative": True}``, which switches the record to
        overlay slimming (see :meth:`_slim_planner_state`)."""
        if not self.enabled:
            return
        # Hot path: queue the snapshot with minimal copying. Everything
        # state_dict() hands over is either a fresh copy or immutable by
        # construction EXCEPT each job's throughput_schedule, which the
        # scheduler keeps appending to — shallow-copy those now; all
        # slimming/encoding happens at flush(). A cell-set snapshot
        # carries its job metadata inside per-cell child states.
        def _copy_flat(state: dict) -> dict:
            out = dict(state)
            out["job_metadata"] = {
                job_id: {
                    **md_state,
                    "throughput_schedule": dict(
                        md_state["throughput_schedule"]
                    ),
                }
                for job_id, md_state in state["job_metadata"].items()
            }
            return out

        raw = dict(planner_state)
        if "children" in raw:
            raw["children"] = OrderedDict(
                (name, _copy_flat(child_state))
                for name, child_state in raw["children"].items()
            )
        else:
            raw = _copy_flat(raw)
        record = {
            "event": "plan",
            "round": int(planner_state.get("round_index", 0)),
            "backend": backend,
            "objective": objective,
            "plan": {str(k): [_job_key(j) for j in v] for k, v in plan.items()},
            "planner_state_raw": raw,
        }
        if solve_record is not None:
            record["solve"] = dict(solve_record)
        if problem_summary is not None:
            record["problem"] = problem_summary
        if pool is not None:
            record["pool"] = pool
        if tags:
            record.update(tags)
        self._append(record)

    def record_speculation(self, detail: dict) -> None:
        """One plan-ahead-pipelining reconcile outcome (``kind`` is
        hit/repair/miss plus the round and churn detail) — the boundary
        decision that pairs with the preceding ``speculative`` plan
        record, so a log replays the pipelined run's control flow, not
        just its solves."""
        if not self.enabled:
            return
        self._append({"event": "speculation", **detail})

    def record_round_context(
        self,
        round_index: int,
        time_s: float,
        assignments: dict,
        job_steps: dict,
        preempted: Optional[list] = None,
    ) -> None:
        """Scheduler-side context for one executed round: worker
        assignments, per-job step progress, and who got preempted.
        ``job_steps`` maps job key -> completed steps (richer per-job
        state lives in the plan records' planner snapshots)."""
        if not self.enabled:
            return
        self._append(
            {
                "event": "round_context",
                "round": int(round_index),
                "time": float(time_s),
                "assignments": {
                    _job_key(k): list(v) for k, v in assignments.items()
                },
                "job_steps": {_job_key(k): v for k, v in job_steps.items()},
                "preempted": [_job_key(k) for k in (preempted or [])],
            }
        )

    def record_fault(self, detail: dict) -> None:
        """An injected or detected fault (worker death, reclamation,
        solver fault). ``detail`` must be plain JSON-serializable data;
        the chaos harness pairs it with a recovery record by
        ``fault_id`` / (kind, worker_id)."""
        if not self.enabled:
            return
        self._append({"event": "fault", **detail})

    def record_recovery(self, detail: dict) -> None:
        """The recovery that answers a recorded fault (requeue+replan,
        ladder fallback, retry success); same pairing keys as
        :meth:`record_fault` plus ``how``."""
        if not self.enabled:
            return
        self._append({"event": "recovery", **detail})

    def record_attribution(self, detail: dict) -> None:
        """Per-(job, round) market attribution for one replan: the
        dual/price block (budget dual, makespan dual, fairness drift)
        plus each job's share vs fair-share baseline, welfare
        contribution, marginal price, switching-bonus state, ladder
        rung, and — in cells mode — cell id and migration prices.
        Everything in ``detail`` is a deterministic function of the
        paired plan record's inputs, so replay re-derives it exactly
        (tests pin this)."""
        if not self.enabled:
            return
        self._append({"event": "attribution", **detail})

    def record_admission(self, detail: dict) -> None:
        """One streaming-admission front-door event: an accepted or
        rejected (backpressure) submission batch, a token-ledger dedup,
        a drained admission, or the end-of-stream close. ``detail``
        carries ``kind`` plus plain JSON data (token, jobs, depth), so
        a 10k-event streaming run's admission timeline replays from the
        log alone."""
        if not self.enabled:
            return
        self._append({"event": "admission", **detail})


# ----------------------------------------------------------------------
# Reading.
# ----------------------------------------------------------------------
def iter_records(path: str) -> Iterator[dict]:
    """Yield records, skipping a truncated final line; a non-final
    corrupt line raises. ``.gz`` logs are read transparently."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                return
            raise ValueError(
                f"{path}:{i + 1}: corrupt decision record (not the final "
                "line, so not a truncated append)")


def _iter_flat_states(planner_state: dict):
    """The flat states inside one recorded snapshot: itself, or each
    cell child's state of a ``cell_set`` record."""
    if "children" in planner_state:
        yield from planner_state["children"].values()
    else:
        yield planner_state


def accumulate_schedules(record: dict, schedules: dict) -> None:
    """Fold one decoded plan record's delta-encoded throughput tails into
    the per-job full schedules (job key -> {round: (tput, bs)}); applied
    to every plan record in file order."""
    for flat in _iter_flat_states(record["planner_state"]):
        for md_state in flat["job_metadata"].values():
            ref = md_state.get("__profile_ref__")
            if ref is None:
                continue
            full = schedules.setdefault(ref, {})
            base = md_state.get("tput_base", 0)
            if base != len(full):
                raise ValueError(
                    f"job {ref!r}: plan record expects {base} prior "
                    f"throughput entries, log accumulated {len(full)}: "
                    "records missing or out of order")
            for r, t, b in zip(md_state["tput_rounds"],
                               md_state["tput_values"],
                               md_state["tput_bss"]):
                full[r] = (t, b)


def _resolve_recorded_state(flat_state: dict, profiles: Optional[dict],
                            schedules: Optional[dict]) -> dict:
    """One flat planner state rebuilt from its slimmed record form:
    profile references resolved, throughput tails replaced by the
    accumulated schedules, finish-time history unpacked, and any
    ``plan_deadline_s`` stripped."""
    state = dict(flat_state)
    resolved = OrderedDict()
    for job_id, md_state in state["job_metadata"].items():
        md_state = dict(md_state)
        ref = md_state.pop("__profile_ref__", None)
        if ref is not None:
            if profiles is None or ref not in profiles:
                raise ValueError(
                    f"plan record references job_profile {ref!r} not seen "
                    "earlier in the log")
            md_state = _rebuild_metadata_state(
                profiles[ref], md_state,
                schedule=copy.deepcopy((schedules or {}).get(ref, {})))
        resolved[job_id] = md_state
    state["job_metadata"] = resolved
    state["finish_time_estimates"] = {
        job: (list(zip(history["rounds"], history["estimates"]))
              if isinstance(history, dict) else list(history))
        for job, history in state["finish_time_estimates"].items()
    }
    state["config"] = dict(state["config"])
    state["config"].pop("plan_deadline_s", None)
    return state


def resolve_plan_state(record: dict, profiles: Optional[dict] = None,
                       schedules: Optional[dict] = None) -> dict:
    """The restorable planner state inside one decoded plan record, every
    flat state resolved (a ``cell_set`` record's children too)."""
    state = dict(record["planner_state"])
    if "children" in state:
        state["children"] = OrderedDict(
            (name, _resolve_recorded_state(child, profiles, schedules))
            for name, child in state["children"].items())
    else:
        state = _resolve_recorded_state(state, profiles, schedules)
    return state


def _scan_plan_records(path: str):
    """Yield ``(decoded plan record, profiles so far, schedules for this
    record)`` in file order, with ``job_profile`` records and throughput
    tails accumulated; a speculative record rebuilds against a throwaway
    base and never advances the shared accumulation."""
    profiles: dict = {}
    schedules: dict = {}
    for record in iter_records(path):
        event = record.get("event")
        if event == "job_profile":
            profiles[record["job"]] = decode(record["profile"])
            continue
        if event != "plan":
            continue
        record = dict(record)
        record["planner_state"] = decode(record["planner_state"])
        record_schedules: dict = {} if record.get("speculative") else schedules
        accumulate_schedules(record, record_schedules)
        yield record, profiles, record_schedules


def extract_state(path: str, round_index: Optional[int] = None) -> dict:
    """The restorable planner state of one recorded planning round (the
    last committed plan when ``round_index`` is None), skipping
    speculative records. Returns ``{"round", "backend", "objective",
    "planner_state"}``."""
    if round_index is None:
        for record in iter_records(path):
            if record.get("event") == "plan" and not record.get(
                    "speculative"):
                round_index = record.get("round")
        if round_index is None:
            raise ValueError(f"{path}: no committed plan records")
    found: Optional[dict] = None
    rounds_seen: List[int] = []
    for record, profiles, record_schedules in _scan_plan_records(path):
        if record.get("speculative"):
            continue
        r = record.get("round")
        rounds_seen.append(r)
        if r != round_index:
            continue
        found = {"round": r, "backend": record.get("backend"),
                 "objective": record.get("objective"),
                 "planner_state": resolve_plan_state(record, profiles,
                                                     record_schedules)}
    if found is None:
        raise ValueError(f"{path}: no plan record for round "
                         f"{round_index!r} (recorded rounds: {rounds_seen})")
    return found


def write_state(out: str, planner_state: dict, round_index, backend,
                objective=None, source: str = None) -> None:
    """Write a planner state (a live planner's ``state_dict()`` or an
    extracted one) as the ``export-state`` envelope, atomically."""
    envelope = {"event": "planner_state", "schema": SCHEMA,
                "source_log": source, "round": round_index,
                "backend": backend, "objective": objective,
                "planner_state": encode(planner_state)}
    directory = os.path.dirname(os.path.abspath(out))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(envelope, f)
        os.replace(tmp, out)
    except BaseException:
        os.unlink(tmp)
        raise


def export_state(path: str, out: Optional[str] = None,
                 round_index: Optional[int] = None) -> dict:
    """Write one round's restorable planner state of a decision log as a
    standalone artifact (``out`` defaults to
    ``<log>.state-r<round>.json``). Returns the extraction with the
    written path under ``"out"``."""
    extracted = extract_state(path, round_index=round_index)
    if out is None:
        out = f"{path}.state-r{extracted['round']}.json"
    write_state(out, extracted["planner_state"], extracted["round"],
                extracted["backend"], extracted["objective"], str(path))
    extracted["out"] = out
    return extracted


def load_exported_state(path: str) -> dict:
    """Read an artifact of :func:`export_state` or :func:`write_state`
    (either package's) back into a decoded envelope."""
    with open(path) as f:
        envelope = json.load(f)
    if envelope.get("event") != "planner_state":
        raise ValueError(
            f"{path} is not an export-state artifact (event="
            f"{envelope.get('event')!r})")
    envelope["planner_state"] = decode(envelope["planner_state"])
    return envelope


def replay_plan_record(
    record: dict,
    profiles: Optional[dict] = None,
    schedules: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Re-run one recorded planning round offline and diff the plan.

    ``record`` must be pre-decoded (:func:`decode`) with
    :func:`accumulate_schedules` already applied; ``profiles`` maps job
    keys to decoded ``job_profile`` payloads and ``schedules`` to the
    accumulated full throughput schedules (:func:`replay_log` maintains
    both while scanning). Returns ``{"round", "recorded", "replayed",
    "diff"}`` where ``diff`` maps round offsets whose job sets disagree
    to the two sides; an empty ``diff`` means the replay reproduced the
    decision exactly.
    """
    from shockwave_tpu_torch.policies.shockwave import planner_from_state

    state = resolve_plan_state(record, profiles, schedules)
    # Replay is offline math, not a timing re-enactment: disable the
    # degradation ladder's deadline so a slow replay host cannot fall
    # down a different rung than the recorded solve. The snapshot's
    # backend is already stamped with the backend that actually
    # produced the plan (including ladder fallbacks; a cell-set record
    # carries per-cell backends in its ``cells_replay`` stamp).
    state["config"] = dict(state["config"])
    state["config"].pop("plan_deadline_s", None)
    planner = planner_from_state(state, device=device)
    planner._replan()
    start = planner.round_index
    replayed = {
        str(r - start): [_job_key(j) for j in planner.schedules[r]]
        for r in sorted(planner.schedules)
        if r >= start
    }
    recorded = {k: list(v) for k, v in record["plan"].items()}
    diff = {}
    for offset in sorted(set(recorded) | set(replayed), key=int):
        a = recorded.get(offset, [])
        b = replayed.get(offset, [])
        if sorted(a) != sorted(b):
            diff[offset] = {"recorded": a, "replayed": b}
    return {
        "round": record.get("round"),
        "recorded": recorded,
        "replayed": replayed,
        "diff": diff,
    }


def replay_log(path: str, round_index: Optional[int] = None,
               device="cuda") -> List[dict]:
    """Replay every ``plan`` record in a decision log (or just those of
    one planning round) and return the per-record replay results.
    ``job_profile`` records and the delta-encoded throughput tails are
    applied in file order — every plan record is scanned even when only
    one round is replayed.

    Speculative plan records (plan-ahead pipelining) are
    self-contained overlays: they carry the clone's full throughput
    schedules (base 0) and never advanced the recorder's accumulation
    base, so they rebuild into a throwaway empty base for that
    record's replay alone and the shared accumulation continues from
    the measured history."""
    results = []
    for record, profiles, record_schedules in _scan_plan_records(path):
        if round_index is not None and record.get("round") != round_index:
            continue
        results.append(
            replay_plan_record(
                record, profiles=profiles, schedules=record_schedules,
                device=device,
            )
        )
    return results


def summarize_log(path: str) -> dict:
    """Cheap structural summary (no replay): record counts, round span,
    backends, objective range."""
    plans = 0
    speculative_plans = 0
    contexts = 0
    faults = 0
    recoveries = 0
    admissions = {}
    speculations = {}
    rounds = []
    backends = {}
    objectives = []
    for record in iter_records(path):
        event = record.get("event")
        if event == "plan":
            plans += 1
            if record.get("speculative"):
                speculative_plans += 1
            rounds.append(record.get("round"))
            backends[record.get("backend")] = (
                backends.get(record.get("backend"), 0) + 1
            )
            if record.get("objective") is not None:
                objectives.append(record["objective"])
        elif event == "round_context":
            contexts += 1
        elif event == "fault":
            faults += 1
        elif event == "recovery":
            recoveries += 1
        elif event == "admission":
            kind = record.get("kind", "unknown")
            admissions[kind] = admissions.get(kind, 0) + 1
        elif event == "speculation":
            kind = record.get("kind", "unknown")
            speculations[kind] = speculations.get(kind, 0) + 1
    return {
        "plans": plans,
        "speculative_plans": speculative_plans,
        "round_contexts": contexts,
        "faults": faults,
        "recoveries": recoveries,
        "admissions": admissions,
        "speculations": speculations,
        "first_round": min(rounds) if rounds else None,
        "last_round": max(rounds) if rounds else None,
        "backends": backends,
        "objective_min": min(objectives) if objectives else None,
        "objective_max": max(objectives) if objectives else None,
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Inspect / replay a flight-recorder decision log"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summary", help="structural summary, no replay")
    p_sum.add_argument("log")
    p_rep = sub.add_parser(
        "replay",
        help="re-run recorded planning rounds offline and diff the plans",
    )
    p_rep.add_argument("log")
    p_rep.add_argument(
        "--round", type=int, default=None,
        help="replay only this planning round",
    )
    p_rep.add_argument(
        "--device", default="cuda",
        help="device of the replayed solves (default: the card)",
    )
    p_exp = sub.add_parser(
        "export-state",
        help="write one round's restorable planner state as a "
        "standalone artifact (what-if fleet input)",
    )
    p_exp.add_argument("log")
    p_exp.add_argument(
        "--round", type=int, default=None,
        help="planning round to extract (default: the last recorded "
        "plan)",
    )
    p_exp.add_argument(
        "--out", default=None,
        help="output path (default: <log>.state-r<round>.json)",
    )
    args = parser.parse_args(argv)

    if args.cmd == "summary":
        print(json.dumps(summarize_log(args.log), indent=1))
        return 0

    if args.cmd == "export-state":
        extracted = export_state(
            args.log, out=args.out, round_index=args.round
        )
        print(
            json.dumps(
                {
                    "round": extracted["round"],
                    "backend": extracted["backend"],
                    "out": extracted["out"],
                }
            )
        )
        return 0

    results = replay_log(args.log, round_index=args.round,
                         device=args.device)
    mismatched = [r for r in results if r["diff"]]
    for r in mismatched:
        print(f"round {r['round']}: plan diverged")
        for offset, sides in r["diff"].items():
            print(
                f"  +{offset}: recorded={sides['recorded']} "
                f"replayed={sides['replayed']}"
            )
    print(
        f"replayed {len(results)} plan record(s): "
        f"{len(results) - len(mismatched)} exact, {len(mismatched)} diverged"
    )
    return 1 if mismatched else 0


if __name__ == "__main__":
    raise SystemExit(main())
