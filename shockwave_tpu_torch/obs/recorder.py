"""The flight recorder's reader: decision logs and planner-state artifacts.

The reader half of the JAX package's ``shockwave_tpu/obs/recorder.py``:
the JSON codec of planner state (``encode`` / ``decode``, :67-148), the
rebuild of slimmed per-job metadata (:218-247), the log scan
(``iter_records`` :575), the plan-state resolution (:599-703,
``_scan_plan_records``), ``extract_state`` (:806), ``export_state``
(:854) and ``load_exported_state`` (:883). A log or an artifact the JAX
package wrote restores here into the port's planners
(:func:`shockwave_tpu_torch.policies.shockwave.planner_from_state`), and
an artifact written here (:func:`write_state`, the same envelope) loads
in either package. The writer (``FlightRecorder``) and replay are not
ported yet (ROADMAP.md, queue 1).
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


def encode(obj):
    from shockwave_tpu_torch.core.ids import JobId

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
                        "runs": [x for s, e in zip(starts, ends)
                                 for x in (obj[s].item(), int(e - s))]}
        return {"__nd__": obj.dtype.str, "data": obj.tolist()}
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


# ----------------------------------------------------------------------
# JobMetadata state as a plan record carries it: the immutable profile
# once per job (a ``job_profile`` record), the dynamic fields and the
# tail of the throughput schedule in each plan record, derived fields
# dropped and recomputed.
# ----------------------------------------------------------------------
# Schema-parity fields no planner math reads: dropped from the log,
# rebuilt empty.
_MD_DROPPED_FIELDS = ("epoch_mem_reqs", "epoch_gpu_reqs")


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
