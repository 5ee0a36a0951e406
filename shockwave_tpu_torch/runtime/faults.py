"""Seeded, deterministic solver-fault injection for the degradation ladder.

The part of the JAX package's ``shockwave_tpu/runtime/faults.py`` that
the Shockwave planner's degradation ladder consumes: :class:`FaultEvent`
(:72), :class:`FaultPlan` (:114), :class:`FaultInjector` (:335) with its
solver queue and the applied/recovered pairing (:369-448), and the
module-level gating ``configure`` / ``reset`` / ``active`` (:450-482).

A plan is a committed, JSON-serializable list of events generated up
front from a seed: nothing samples randomness at injection time. Two
event kinds are carried: ``solver_timeout`` (the ladder charges the rung
as timed out without burning wall clock) and ``solver_slowdown`` (the
attempt sleeps ``delay_s`` first, so a real deadline can overrun). The
injector is off unless :func:`configure` is called or
``SHOCKWAVE_FAULTS`` names a plan file; when off, :func:`active` is one
module-global check.

The scheduler's own faults (worker crashes, capacity reclaims, RPC
faults, scheduler kills) are not ported: a plan holding one raises
``NotImplementedError`` naming ``ROADMAP.md``.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SOLVER_KINDS = ("solver_slowdown", "solver_timeout")


@dataclass
class FaultEvent:
    event_id: int
    kind: str
    # Cluster events: seconds on the run's clock.
    at_s: Optional[float] = None
    # Solver events: planner round_index the event arms at.
    round: Optional[int] = None
    # RPC events: method name.
    method: Optional[str] = None
    count: int = 1
    delay_s: float = 0.0
    worker_type: Optional[str] = None

    def to_dict(self) -> dict:
        out = {"event_id": self.event_id, "kind": self.kind}
        for key in ("at_s", "round", "method", "worker_type"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        if self.count != 1:
            out["count"] = self.count
        if self.delay_s:
            out["delay_s"] = self.delay_s
        return out

    @classmethod
    def from_dict(cls, raw: dict) -> "FaultEvent":
        return cls(
            event_id=int(raw["event_id"]),
            kind=str(raw["kind"]),
            at_s=raw.get("at_s"),
            round=raw.get("round"),
            method=raw.get("method"),
            count=int(raw.get("count", 1)),
            delay_s=float(raw.get("delay_s", 0.0)),
            worker_type=raw.get("worker_type"),
        )


@dataclass
class FaultPlan:
    seed: int
    events: List[FaultEvent] = field(default_factory=list)
    # Capacity guard rails of the (not ported) cluster events, kept so a
    # plan file round-trips.
    min_capacity: int = 1
    max_capacity: Optional[int] = None

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "seed": self.seed,
                "min_capacity": self.min_capacity,
                "max_capacity": self.max_capacity,
                "events": [e.to_dict() for e in self.events],
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        raw = json.loads(text)
        return cls(
            seed=int(raw.get("seed", 0)),
            events=[FaultEvent.from_dict(e) for e in raw.get("events", [])],
            min_capacity=int(raw.get("min_capacity", 1)),
            max_capacity=raw.get("max_capacity"),
        )

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        """Load a plan; ``.gz`` files are read transparently."""
        import gzip

        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls.from_json(f.read())


class FaultInjector:
    """Consumes a :class:`FaultPlan`'s solver events, hands them to the
    ladder, and tracks the applied->recovered pairing."""

    def __init__(self, plan: FaultPlan):
        others = sorted({e.kind for e in plan.events
                         if e.kind not in SOLVER_KINDS})
        if others:
            raise NotImplementedError(
                f"fault kinds {others} are not ported to shockwave_tpu_torch "
                "yet (only the solver faults of the degradation ladder "
                "are; the scheduler's fault plans: ROADMAP.md, queue 1)")
        self.plan = plan
        self._lock = threading.Lock()
        self._solver: List[FaultEvent] = sorted(
            plan.events, key=lambda e: (e.round or 0, e.event_id)
        )
        self.applied: Dict[int, dict] = {}
        self.recovered: Dict[int, dict] = {}

    def next_solver_fault(self, round_index: int) -> Optional[FaultEvent]:
        """Pop ONE solver event armed at or before ``round_index``; the
        ladder calls this once per solve attempt."""
        with self._lock:
            if self._solver and (self._solver[0].round or 0) <= round_index:
                return self._solver.pop(0)
            return None

    def mark_applied(self, event: FaultEvent, **detail) -> None:
        with self._lock:
            self.applied.setdefault(
                event.event_id, {"kind": event.kind, **detail}
            )

    def mark_recovered(self, event_id: int, **detail) -> None:
        with self._lock:
            self.recovered.setdefault(event_id, dict(detail))

    def summary(self) -> dict:
        with self._lock:
            applied = set(self.applied)
            recovered = set(self.recovered)
            return {
                "planned_events": len(self.plan.events),
                "applied": len(applied),
                "recovered": len(recovered),
                "unrecovered": sorted(applied - recovered),
                "pending_solver": len(self._solver),
            }


_INJECTOR: Optional[FaultInjector] = None
_ENV_CHECKED = False


def configure(plan_or_path) -> FaultInjector:
    """Arm fault injection for this process. Accepts a FaultPlan or a
    path to a JSON plan file."""
    global _INJECTOR
    plan = (
        plan_or_path
        if isinstance(plan_or_path, FaultPlan)
        else FaultPlan.from_file(str(plan_or_path))
    )
    _INJECTOR = FaultInjector(plan)
    return _INJECTOR


def reset() -> None:
    global _INJECTOR, _ENV_CHECKED
    _INJECTOR = None
    _ENV_CHECKED = True  # an explicit reset also disarms env pickup


def active() -> Optional[FaultInjector]:
    """The process-wide injector, or None (the common, zero-cost case).
    The first call picks up ``SHOCKWAVE_FAULTS=<plan.json>``."""
    global _INJECTOR, _ENV_CHECKED
    if _INJECTOR is not None:
        return _INJECTOR
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        path = os.environ.get("SHOCKWAVE_FAULTS")
        if path:
            _INJECTOR = FaultInjector(FaultPlan.from_file(path))
    return _INJECTOR
