"""Scheduler-state capture and restore through the flight-recorder codec.

The port of the JAX package's ``shockwave_tpu/ha/codec.py``.
:meth:`Scheduler.ha_state_dict` / :meth:`Scheduler.restore_ha_state` own
the field lists; this module holds the pieces both sides and the tests
share:

* a :class:`~shockwave_tpu_torch.core.job.Job` codec (the dataclass
  fields and any attribute attached later, such as ``arrival_time``),
* :func:`json_roundtrip`, the exact on-disk transformation of a journal
  checkpoint: encode with ``obs/recorder.py::encode``, write JSON text,
  parse it, decode. The simulator's ``scheduler_crash`` /
  ``scheduler_restart`` faults push the whole control plane through it
  mid-run, and the run must come back bit-identical,
* :func:`state_fingerprint`, the hash both sides of such a round trip
  are compared by (the JAX package hashes sorted-key JSON; the port
  hashes the checkpoint's own text, which is as canonical).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.obs.recorder import decode, encode

_JOB_FIELDS = tuple(f.name for f in dataclasses.fields(Job))


def job_state(job: Job) -> dict:
    """Every attribute of ``job``, declared fields and attached extras
    alike: the journal restores the object the scheduler held."""
    return dict(vars(job))


def job_from_state(state: dict) -> Job:
    declared = {f: state[f] for f in _JOB_FIELDS if f in state}
    job = Job(**declared)
    for key, value in state.items():
        if key not in _JOB_FIELDS:
            setattr(job, key, value)
    return job


def to_json(state) -> str:
    """A journal checkpoint's text: the recorder-encoded state as JSON."""
    return json.dumps(encode(state))


def from_json(text: str):
    return decode(json.loads(text))


def json_roundtrip(state):
    """Recorder-encode, serialize to JSON text, parse, recorder-decode:
    what a journal checkpoint goes through on disk."""
    return from_json(to_json(state))


def fingerprint(text: str) -> str:
    """SHA-256 of a checkpoint's text. The codec writes every dict as its
    ordered pairs, so the text is canonical and dict order is part of
    the identity: compare captures, not hand-built dicts."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def state_fingerprint(state) -> str:
    return fingerprint(to_json(state))


def restore_sets(decoded, *, frozen: bool = False):
    """``decode`` returns lists for encoded sets; coerce back."""
    return frozenset(decoded) if frozen else set(decoded)


def planner_state_or_none(scheduler) -> Optional[dict]:
    shockwave = getattr(scheduler, "_shockwave", None)
    return shockwave.state_dict() if shockwave is not None else None
