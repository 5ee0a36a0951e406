"""Causal trace-context propagation across the fleet's RPC planes.

A :class:`TraceContext` names the *current span* of one causal chain —
``trace_id`` identifies the chain (one per submitted job, or per
ad-hoc operation), ``span_id`` the span itself, ``parent_span_id`` the
span it hangs under, and ``sampled`` whether the chain crosses process
boundaries. Spans stamp these three ids into their Chrome-trace
``args`` (:meth:`TraceContext.args`); the wire carries the compact
``"<trace_id>-<span_id>-<flag>"`` encoding (:meth:`TraceContext.to_wire`
/ :func:`from_wire`) in a proto3 string field every extended RPC
message grew — SubmitJobs, RunJob, Done, heartbeat, kill, DumpMetrics.
A receiver parses the wire context and opens its own spans as children
(``from_wire(s).child()``), so a job's
submit → queue-wait → plan → dispatch → launch → run → done →
completion reconstructs as ONE span tree across submitter, scheduler,
and worker processes (``scripts/analysis/merge_traces.py`` does the
reconstruction; :mod:`shockwave_tpu_torch.obs.spantree` holds the logic).

Wire compatibility is free: proto3 omits empty strings, so a run with
tracing disabled serializes byte-identical messages to the old schema,
and an old reader skips the unknown field per proto3 rules. A message
with no context (old sender, or sampling off) starts a fresh root at
the receiver — never an error.

Sampling: ``SHOCKWAVE_TRACE_SAMPLE`` in [0, 1] (default 1 — every
chain) gates cross-process propagation deterministically (every k-th
root where k = round(1/fraction)); unsampled chains still trace
locally, they just don't ship context. Disabled tracing short-circuits
to ``None`` before any id is drawn, so the null path stays one flag
check.
"""

from __future__ import annotations

import os
from typing import Optional

from shockwave_tpu_torch.analysis import sanitize

_WIRE_SEP = "-"

_lock = sanitize.make_lock("obs.propagate._lock")
# Deterministic every-k-th sampling state ("Caller holds the lock
# (_lock)" applies to the two helpers below).
_sample_fraction: Optional[float] = None
_root_counter = 0


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """One span of one causal chain. Immutable by convention."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "sampled")

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_span_id: Optional[str] = None,
        sampled: bool = True,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.sampled = bool(sampled)

    def __repr__(self):
        return (
            f"TraceContext({self.trace_id}/{self.span_id}"
            f"<-{self.parent_span_id} sampled={self.sampled})"
        )

    def child(self) -> "TraceContext":
        """A new span under this one (same chain, fresh span id)."""
        return TraceContext(
            self.trace_id, _new_id(8), self.span_id, self.sampled
        )

    def args(self) -> dict:
        """Chrome-trace ``args`` entries naming this span in the causal
        tree (what merge_traces/spantree reconstruct from)."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        return out

    def to_wire(self) -> str:
        """Compact wire encoding; empty when the chain is unsampled
        (proto3 then omits the field — byte-identical to old schema)."""
        if not self.sampled:
            return ""
        return f"{self.trace_id}{_WIRE_SEP}{self.span_id}{_WIRE_SEP}1"


def from_wire(wire: str) -> Optional[TraceContext]:
    """Parse a wire context; ``None`` for absent/garbage (an old sender
    or an unsampled chain — the receiver starts a fresh root if it
    wants one; never an error)."""
    if not wire:
        return None
    parts = str(wire).split(_WIRE_SEP)
    if len(parts) != 3 or not parts[0] or not parts[1]:
        return None
    try:
        int(parts[0], 16), int(parts[1], 16)
    except ValueError:
        return None
    return TraceContext(parts[0], parts[1], None, parts[2] == "1")


def ctx_args(ctx: Optional[TraceContext]) -> dict:
    """``ctx.args()`` or ``{}`` — the call-site-friendly form."""
    return ctx.args() if ctx is not None else {}


def ctx_wire(ctx: Optional[TraceContext]) -> str:
    return ctx.to_wire() if ctx is not None else ""


def _read_fraction() -> float:
    """Caller holds the lock (_lock)."""
    global _sample_fraction
    if _sample_fraction is None:
        try:
            _sample_fraction = min(
                1.0, max(0.0, float(os.environ.get(
                    "SHOCKWAVE_TRACE_SAMPLE", "1.0"
                )))
            )
        except ValueError:
            _sample_fraction = 1.0
    return _sample_fraction


def configure_sampling(fraction: Optional[float]) -> None:
    """Override (or with ``None`` re-read from the environment) the
    cross-process sampling fraction; resets the deterministic counter."""
    global _sample_fraction, _root_counter
    with _lock:
        _sample_fraction = (
            None if fraction is None
            else min(1.0, max(0.0, float(fraction)))
        )
        _root_counter = 0


def _sample_next() -> bool:
    """Deterministic every-k-th sampling decision. Caller holds the
    lock (_lock)."""
    global _root_counter
    fraction = _read_fraction()
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    period = max(1, round(1.0 / fraction))
    decision = _root_counter % period == 0
    _root_counter += 1
    return decision


def new_root(force_sample: Optional[bool] = None) -> Optional[TraceContext]:
    """Start a fresh causal chain, or ``None`` when tracing is off (the
    null fast path: one flag check, no id drawn, no lock)."""
    from shockwave_tpu_torch import obs

    if not obs.trace_enabled():
        return None
    if force_sample is None:
        with _lock:
            sampled = _sample_next()
    else:
        sampled = bool(force_sample)
    return TraceContext(_new_id(16), _new_id(8), None, sampled)


def adopt_or_root(wire: str) -> Optional[TraceContext]:
    """Receiver-side entry: the wire context when present, else a fresh
    root (``None`` when tracing is off). The returned context is the
    PARENT for any span the receiver opens (``.child()`` it)."""
    ctx = from_wire(wire)
    if ctx is not None:
        return ctx
    return new_root()
