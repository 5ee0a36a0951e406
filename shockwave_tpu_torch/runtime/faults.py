"""Seeded, deterministic fault injection for the simulator and the planner.

The port of the JAX package's ``shockwave_tpu/runtime/faults.py``. A
:class:`FaultPlan` is a committed, JSON-serializable list of
:class:`FaultEvent` records generated up front from a seed
(``generate_churn_plan``, ``generate_arrival_campaign``,
``generate_streaming_plan``): nothing samples randomness at injection
time. A :class:`FaultInjector` consumes the plan:

  * cluster events (``worker_crash`` / ``capacity_reclaim`` /
    ``worker_add``, and the control-plane kills ``scheduler_crash`` /
    ``scheduler_restart``) are popped by the simulator's round loop as
    their time arrives (``Scheduler._apply_cluster_fault_events``); the
    victims of a crash or reclaim come from :func:`select_victims`,
    seeded by (plan seed, event id);
  * solver events (``solver_slowdown`` / ``solver_timeout``) are popped by
    the planner's degradation ladder once a solve attempt;
  * RPC events (``rpc_error`` / ``rpc_delay`` / ``rpc_drop``) are matched
    call by call per method name (:func:`check_rpc`,
    :func:`note_rpc_success`) by every RPC client of the physical
    control plane (``runtime/rpc/``).

Every applied event is tracked, and the recovery that answers it is paired
back by ``event_id`` (:meth:`FaultInjector.summary`). The injector is off
unless :func:`configure` is called or ``SHOCKWAVE_FAULTS`` names a plan
file; when off, :func:`active` is one module-global check.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Scheduler (control-plane) faults: kill the brain itself. In
# simulation both kinds round-trip the full scheduler state through
# the HA journal codec (ha/codec.py) and the run must continue
# bit-identically (the JAX package's physical mode, not ported yet,
# kills the leader process instead). They ride the cluster-event queue:
# applied at round boundaries, seeded and deterministic like every other
# fault.
SCHEDULER_KINDS = ("scheduler_crash", "scheduler_restart")
CLUSTER_KINDS = (
    "worker_crash", "capacity_reclaim", "worker_add",
) + SCHEDULER_KINDS
SOLVER_KINDS = ("solver_slowdown", "solver_timeout")
RPC_KINDS = ("rpc_error", "rpc_delay", "rpc_drop")


class InjectedRpcError(RuntimeError):
    """Raised in place of a real transport error for ``rpc_error`` /
    ``rpc_drop`` events; carries the event id for recovery pairing."""

    def __init__(self, event_id: int, kind: str, method: str):
        super().__init__(
            f"injected {kind} on RPC {method} (fault event {event_id})"
        )
        self.event_id = event_id
        self.kind = kind
        self.method = method


@dataclass
class FaultEvent:
    event_id: int
    kind: str
    # Cluster events: seconds on the run's clock (virtual time in sim,
    # wall-since-start in physical mode).
    at_s: Optional[float] = None
    # Solver events: planner round_index the event arms at.
    round: Optional[int] = None
    # RPC events: method name ("Done", "RunJob", "KillJob", ...).
    method: Optional[str] = None
    # Workers affected (cluster) or calls affected (rpc).
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
    # Capacity guard rails the applier clamps cluster events to: never
    # reclaim below min_capacity (a gang wider than the surviving
    # cluster would wedge the placer), never restore above
    # max_capacity (a clamped reclaim must not let its paired add
    # inflate the fleet).
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
        """Load a plan; ``.gz`` files (committed large-campaign
        artifacts) are read transparently."""
        import gzip

        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls.from_json(f.read())


def generate_churn_plan(
    seed: int,
    horizon_s: float,
    num_workers: int,
    worker_type: str = "v100",
    target_events: int = 1000,
    round_s: float = 120.0,
    min_capacity: Optional[int] = None,
    solver_faults: int = 6,
    crash_fraction: float = 0.5,
    restore_rounds: float = 2.0,
    scheduler_faults: int = 0,
) -> FaultPlan:
    """A spot/reclaim + churn scenario: paired (reclaim-or-crash, add)
    events spread over ``horizon_s`` plus a sprinkle of solver
    slowdown/timeout rounds for the degradation ladder, and —
    with ``scheduler_faults`` > 0 — paired
    (``scheduler_crash``, ``scheduler_restart``) events that kill the
    brain itself (the HA failover drill). Fully deterministic from
    ``seed``; the capacity trajectory stays within
    [min_capacity, num_workers]."""
    rng = random.Random(seed)
    if min_capacity is None:
        min_capacity = max(1, num_workers // 4)
    events: List[FaultEvent] = []

    def add_event(kind: str, **kwargs) -> FaultEvent:
        event = FaultEvent(event_id=len(events), kind=kind, **kwargs)
        events.append(event)
        return event

    # Scheduler kill drills first so their event ids are stable under
    # target_events growth: each crash pairs with a restart half a
    # round later (in sim both round-trip state at the same boundary;
    # physically the standby's takeover IS the restart).
    for i in range(max(int(scheduler_faults), 0)):
        t = round(horizon_s * (i + 1) / (scheduler_faults + 1), 3)
        add_event("scheduler_crash", at_s=t)
        add_event(
            "scheduler_restart", at_s=round(t + round_s * 0.5, 3)
        )

    n_rounds = max(int(horizon_s / max(round_s, 1e-9)), 2)
    for i, r in enumerate(
        sorted(
            rng.sample(
                range(1, n_rounds), min(solver_faults, n_rounds - 1)
            )
        )
    ):
        if i % 2 == 0:
            add_event("solver_timeout", round=r)
        else:
            add_event(
                "solver_slowdown", round=r, delay_s=round(round_s * 0.05, 3)
            )

    while len(events) < target_events:
        t = round(rng.uniform(0.0, horizon_s * 0.95), 3)
        kind = (
            "worker_crash"
            if rng.random() < crash_fraction
            else "capacity_reclaim"
        )
        count = rng.choice([1, 1, 1, 2, 2, 4])
        add_event(kind, at_s=t, count=count, worker_type=worker_type)
        restore_at = round(
            min(t + rng.uniform(0.5, restore_rounds) * round_s, horizon_s),
            3,
        )
        add_event(
            "worker_add", at_s=restore_at, count=count,
            worker_type=worker_type,
        )
    return FaultPlan(
        seed=seed,
        events=events,
        min_capacity=min_capacity,
        max_capacity=num_workers,
    )


def generate_arrival_campaign(
    seed: int,
    num_jobs: int,
    horizon_s: float,
    burst_count: int = 3,
    burst_fraction: float = 0.5,
    burst_width_frac: float = 0.02,
) -> List[float]:
    """A streaming arrival-time campaign: Poisson background traffic
    composed with short high-rate bursts (the front-door load shape a
    production scheduler actually sees — steady trickle punctuated by
    campaign launches that must hit backpressure, not OOM the queue).

    ``burst_fraction`` of the jobs land inside ``burst_count`` bursts,
    each ``burst_width_frac`` of the horizon wide; the rest arrive as a
    Poisson process over the whole horizon. Fully deterministic from
    ``seed``; returns sorted arrival seconds.
    """
    rng = random.Random(seed ^ 0x5EED)
    num_jobs = int(num_jobs)
    n_burst = int(num_jobs * burst_fraction) if burst_count > 0 else 0
    n_background = num_jobs - n_burst
    arrivals: List[float] = []
    # Poisson background: exponential inter-arrival gaps, rate sized so
    # the expected span fills the horizon.
    rate = n_background / max(horizon_s, 1e-9)
    t = 0.0
    for _ in range(n_background):
        t += rng.expovariate(max(rate, 1e-12))
        arrivals.append(min(t, horizon_s))
    # Bursts: uniformly placed windows, arrivals uniform inside each.
    per_burst = [n_burst // max(burst_count, 1)] * max(burst_count, 0)
    for i in range(n_burst - sum(per_burst)):
        per_burst[i % len(per_burst)] += 1
    width = horizon_s * burst_width_frac
    for count in per_burst:
        start = rng.uniform(0.0, max(horizon_s - width, 0.0))
        for _ in range(count):
            arrivals.append(start + rng.uniform(0.0, width))
    arrivals.sort()
    return [round(a, 3) for a in arrivals]


def generate_streaming_plan(
    seed: int,
    num_jobs: int,
    horizon_s: float,
    num_workers: int,
    target_churn_events: int = 1000,
    submit_faults: int = 4,
    round_s: float = 120.0,
    burst_count: int = 3,
    burst_fraction: float = 0.5,
    **churn_kwargs,
) -> "Tuple[List[float], FaultPlan]":
    """One seeded streaming scenario: an arrival campaign (Poisson +
    bursts) composed with the reclaim/re-add churn plan of
    :func:`generate_churn_plan`, plus ``submit_faults`` injected RPC
    faults on the ``SubmitJobs`` front door (alternating lost-response
    drops and pre-send errors) so the run exercises token-idempotent
    retries. Returns ``(arrival_times, FaultPlan)``."""
    arrivals = generate_arrival_campaign(
        seed, num_jobs, horizon_s, burst_count=burst_count,
        burst_fraction=burst_fraction,
    )
    plan = generate_churn_plan(
        seed, horizon_s, num_workers,
        target_events=target_churn_events, round_s=round_s,
        **churn_kwargs,
    )
    for i in range(submit_faults):
        kind = "rpc_drop" if i % 2 == 0 else "rpc_error"
        plan.events.append(
            FaultEvent(
                event_id=len(plan.events), kind=kind, method="SubmitJobs"
            )
        )
    return arrivals, plan


def select_victims(plan: FaultPlan, event: FaultEvent, live_ids) -> list:
    """Deterministic victim choice for a worker_crash/capacity_reclaim
    event, shared by the simulator and physical appliers so the two
    modes can never drift: sample ``event.count`` workers from the
    sorted live set, clamped so at least ``plan.min_capacity`` survive,
    seeded by (plan seed, event id)."""
    live = sorted(live_ids)
    floor = max(plan.min_capacity, 1)
    count = min(event.count, max(len(live) - floor, 0))
    if count <= 0:
        return []
    rng = random.Random((plan.seed << 16) ^ event.event_id)
    return rng.sample(live, count)


class FaultInjector:
    """Consumes a :class:`FaultPlan`, hands events to the runtime's
    injection points, and tracks the applied->recovered pairing."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._cluster: List[FaultEvent] = sorted(
            (e for e in plan.events if e.kind in CLUSTER_KINDS),
            key=lambda e: (e.at_s or 0.0, e.event_id),
        )
        self._solver: List[FaultEvent] = sorted(
            (e for e in plan.events if e.kind in SOLVER_KINDS),
            key=lambda e: (e.round or 0, e.event_id),
        )
        self._rpc: Dict[str, List[FaultEvent]] = {}
        self._rpc_remaining: Dict[int, int] = {}
        for event in plan.events:
            if event.kind in RPC_KINDS and event.method:
                self._rpc.setdefault(event.method, []).append(event)
                self._rpc_remaining[event.event_id] = max(event.count, 1)
        self.applied: Dict[int, dict] = {}
        self.recovered: Dict[int, dict] = {}

    # -- cluster events (scheduler round loop) --------------------------
    def due_cluster_events(self, now_s: float) -> List[FaultEvent]:
        """Pop every cluster event with ``at_s <= now_s`` (in order)."""
        with self._lock:
            due = []
            while self._cluster and (self._cluster[0].at_s or 0.0) <= now_s:
                due.append(self._cluster.pop(0))
            return due

    # -- solver events (planner degradation ladder) ---------------------
    def next_solver_fault(self, round_index: int) -> Optional[FaultEvent]:
        """Pop ONE solver event armed at or before ``round_index``; the
        ladder calls this once per solve attempt."""
        with self._lock:
            if self._solver and (self._solver[0].round or 0) <= round_index:
                return self._solver.pop(0)
            return None

    # -- rpc events (client call sites) ---------------------------------
    def rpc_fault(self, method: str, kinds=None) -> Optional[FaultEvent]:
        """Match (and consume one count of) the next fault armed for
        ``method``; None when the call should go through clean.
        ``kinds`` restricts which fault kinds this call site can
        consume — e.g. the SubmitJobs client checks ``rpc_error``/
        ``rpc_delay`` BEFORE the wire send and ``rpc_drop`` AFTER it,
        so a drop models a lost *response* (the server processed the
        batch; the retry must be deduplicated), not a lost request."""
        with self._lock:
            queue = self._rpc.get(method)
            if not queue:
                return None
            event = queue[0]
            if kinds is not None and event.kind not in kinds:
                return None
            self._rpc_remaining[event.event_id] -= 1
            if self._rpc_remaining[event.event_id] <= 0:
                queue.pop(0)
            self.applied.setdefault(
                event.event_id,
                {"kind": event.kind, "method": method, "t": time.time()},
            )
            return event

    def note_rpc_success(self, method: str) -> None:
        """A real call on ``method`` went through: every applied RPC
        fault on that method is now recovered-from."""
        with self._lock:
            for event_id, detail in self.applied.items():
                if (
                    detail.get("method") == method
                    and event_id not in self.recovered
                    and detail["kind"] in RPC_KINDS
                ):
                    self.recovered[event_id] = {
                        "kind": detail["kind"],
                        "how": "retry_succeeded",
                    }

    # -- pairing / reporting --------------------------------------------
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
                "pending_cluster": len(self._cluster),
                "pending_solver": len(self._solver),
                "pending_rpc": sum(len(q) for q in self._rpc.values()),
            }


# ----------------------------------------------------------------------
# Module-level gating (mirrors the SHOCKWAVE_SANITIZE pattern).
# ----------------------------------------------------------------------
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
    First call picks up ``SHOCKWAVE_FAULTS=<plan.json>`` so worker
    subprocesses inherit injection through the environment."""
    global _INJECTOR, _ENV_CHECKED
    if _INJECTOR is not None:
        return _INJECTOR
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        path = os.environ.get("SHOCKWAVE_FAULTS")
        if path:
            _INJECTOR = FaultInjector(FaultPlan.from_file(path))
    return _INJECTOR


def check_rpc(method: str, sleep=time.sleep, kinds=None) -> None:
    """Client-side injection hook: no-op when injection is off;
    otherwise may sleep (``rpc_delay``) or raise
    :class:`InjectedRpcError` (``rpc_error`` / ``rpc_drop``) according
    to the armed plan. ``kinds`` restricts which fault kinds this call
    site consumes (see :meth:`FaultInjector.rpc_fault`)."""
    injector = active()
    if injector is None:
        return
    event = injector.rpc_fault(method, kinds=kinds)
    if event is None:
        return
    from shockwave_tpu_torch import obs

    obs.counter(
        "fault_injected_total", "fault events delivered by the injector"
    ).inc(kind=event.kind)
    if event.kind == "rpc_delay":
        sleep(event.delay_s)
        injector.mark_recovered(event.event_id, how="delay_elapsed")
        return
    raise InjectedRpcError(event.event_id, event.kind, method)


def note_rpc_success(method: str) -> None:
    """Success-side hook for recovery pairing; no-op when off."""
    injector = active()
    if injector is not None:
        injector.note_rpc_success(method)
