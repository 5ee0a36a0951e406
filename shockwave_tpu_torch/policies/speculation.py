"""Plan-ahead pipelining: speculative next-round solves.

The port of the JAX package's ``shockwave_tpu/policies/speculation.py``.
While round r runs, the planner is cloned from a snapshot of its state,
the round's predicted outcome (progress, throughput records,
completions, capacity) is applied to the clone, and the clone solves
round r+1: inline in simulation, where solver wall time never advances
virtual time, or on a daemon thread (``background=True``). At the
boundary the speculation is reconciled against reality:

* **hit**: nothing churned (same jobs, same capacity, progress within
  ``speculate_epoch_tolerance`` epochs, no recompute flag); the
  speculative window is installed and the boundary solves nothing. In
  simulation the prediction is exact, so the installed plan is the one
  the serial boundary would have solved.
* **repair**: churn, on a boundary that was going to re-solve anyway;
  the speculative window becomes the warm-start basis and the boundary
  re-solves through the delta-patched PDHG path (kernel A on a card).
* **miss**: the speculative solve failed, outlived the join budget,
  targeted another round, or churn hit a boundary that serves its cache;
  the serial path runs untouched.

The cell federation speculates as a whole and reconciles per cell.

One divergence from the JAX package: a device fault (a kernel that does
not build, load or launch, or a fault the card reported) in a
speculative solve is raised at the reconcile instead of counted as a
miss, as the degradation ladder raises it (policies/shockwave.py).
Other errors keep the JAX package's miss.

Flight-recorder exactness: the speculative solve *is* a ``_replan`` on
the clone, so it records a normal plan record (tagged ``speculative:
true``) whose snapshot is the clone's pre-replan state, and replay
re-enters the identical solve. Reconcile outcomes are stamped as
``speculation`` records. Speculative records are slimmed as overlays:
their predicted throughput tails are not folded into the recorder's
delta-encoded accumulation (:class:`shockwave_tpu_torch.obs.recorder.
FlightRecorder`). The speculation thread's spans land on their own track
(``tid="speculation"``), and the registry and tracer it publishes into
lock through ``analysis.sanitize.make_lock``.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Dict, List, Optional

from shockwave_tpu_torch import obs

# Epochs of per-job progress divergence a speculation survives before
# reality is declared churned (0 = any divergence repairs). Simulation
# predicts outcomes exactly, so the tolerance only matters in physical
# mode, where epoch-boundary races against measured throughput are the
# common benign divergence.
DEFAULT_EPOCH_TOLERANCE = 0
# Seconds the boundary reconcile waits for a still-running background
# speculative solve before declaring a miss and solving serially.
DEFAULT_JOIN_TIMEOUT_S = 10.0


class SpecOutcome:
    """The predicted state delta between the speculation snapshot and
    the next round boundary, supplied by the scheduler (which owns the
    execution model): per-job progress after the boundary's
    ``set_progress`` pass, the throughput records the round's completion
    merge will append, the jobs predicted to complete (and leave the
    planner), and the fleet capacity."""

    __slots__ = (
        "target_round", "progress", "throughputs", "completions",
        "capacity",
    )

    def __init__(
        self,
        target_round: int,
        progress: Dict[object, int],
        throughputs: List[tuple],
        completions: List[object],
        capacity: int,
    ):
        self.target_round = int(target_round)
        self.progress = dict(progress)
        self.throughputs = list(throughputs)
        self.completions = list(completions)
        self.capacity = int(capacity)


class SpeculativePlannerMixin:
    """The pipelining scaffolding both planner kinds share: the
    speculation slot + knobs (``_init_speculation``, called from
    ``__init__``), the public ``speculate_next_round`` /
    ``_reconcile_speculation`` entry points, and the exposed-boundary
    ledger. The kind-specific reconcile hooks
    (``_install_speculation`` / ``_prepare_repair`` /
    ``_augment_mismatch`` / ``_spec_solve_base``) stay on the
    planners."""

    def _init_speculation(self, config: dict) -> None:
        self._speculation: Optional[Speculation] = None
        self._speculate_epoch_tolerance = int(
            config.get("speculate_epoch_tolerance", DEFAULT_EPOCH_TOLERANCE)
        )
        self._speculate_join_s = float(
            config.get("speculate_join_s", DEFAULT_JOIN_TIMEOUT_S)
        )
        # Tags merged into the next flight-recorder plan record
        # (speculative clones stamp {"speculative": True}).
        self._plan_record_tags: Optional[dict] = None
        self._last_repair = False
        # Monotone replan counter (speculation detects whether its
        # clone actually solved) and the exposed side of the
        # hidden-vs-exposed pipelining ledger: planning wall time spent
        # ON THE ROUND LOOP'S THREAD (a boundary serve, or physical
        # mode's mid-round pass — which overlaps worker execution
        # wall-clock-wise but runs under the condition lock, blocking
        # completion RPCs and bounding how short rounds can get).
        # Speculative solves run off-thread and ride the hidden
        # histogram instead.
        self._replan_epoch = 0
        self.exposed_plan_times: List[float] = []
        self.spec_stats: Dict[str, int] = {
            "hit": 0, "repair": 0, "miss": 0,
        }

    def speculate_next_round(self, outcome, background: bool = False):
        """Kick a speculative solve of ``outcome.target_round`` from a
        snapshot of the current planner state plus the scheduler's
        predicted round outcome. ``background=True`` (physical mode)
        runs the apply+solve on a daemon thread sharing nothing
        mutable with the live planner; simulation runs it inline —
        solver wall time never advances virtual time, so the overlap
        is free by construction and the machinery is identical."""
        return begin_speculation(self, outcome, background)

    def _reconcile_speculation(self) -> Optional[str]:
        return reconcile_speculation(self)

    def reconcile_at_boundary(self) -> Optional[str]:
        """Public boundary entry for schedulers that reconcile ahead of
        their own schedule passes (the physical round loop does, so a
        hit's installed window feeds the assignment pass and a repair
        is armed before it solves). Reconciles the pending speculation
        and self-observes the wall time as exposed planning time —
        identical protocol to ``current_round_schedule``'s internal
        reconcile, kept here so the two planner kinds and the physical
        scheduler can never drift apart. Returns the reconcile outcome
        ("hit"/"repair"/"miss") or None when nothing was pending."""
        if self._speculation is None:
            return None
        start = time.perf_counter()
        outcome = self._reconcile_speculation()
        if outcome is not None:
            self._observe_boundary(time.perf_counter() - start)
        return outcome

    def _observe_boundary(self, seconds: float) -> None:
        if getattr(self, "_speculative", False):
            # A speculation clone's solve is HIDDEN time; it rides
            # observe_hidden_solve, never the exposed-boundary ledger.
            return
        self.exposed_plan_times.append(seconds)
        observe_exposed(seconds, self.round_duration)


class Speculation:
    """One in-flight (or finished) speculative solve."""

    def __init__(self, outcome: SpecOutcome):
        self.outcome = outcome
        self.clone = None
        self.fingerprint: Optional[dict] = None
        # True once the clone ran an actual replan (vs predicting the
        # boundary would serve from cache — a solve-free "hit").
        self.solved = False
        self.error: Optional[BaseException] = None
        self.solve_seconds = 0.0
        # The live planner's solve-bookkeeping lengths at snapshot time
        # (``_spec_solve_base()`` — an int for a flat planner, a dict
        # for the cell federation): install/repair appends only the
        # clone's NEW records, immune to live solves that land between
        # snapshot and boundary (physical mode's mid-round pass).
        self.base_solve_records = 0
        self.done = threading.Event()
        # A background solve on a card: the event recorded on the
        # planner's speculation stream after the solve's last launch.
        self.event = None

    @property
    def ok(self) -> bool:
        return self.done.is_set() and self.error is None


# ----------------------------------------------------------------------
# Cloning. state_dict() is shallow where it can afford to be (the
# checkpoint path pickles, which copies implicitly); a speculation clone
# shares the process with the live planner, so every structure either
# side mutates must be deep-copied: per-job throughput schedules (the
# clone applies predicted records), the Dirichlet posterior (mutated by
# the change-point reweight), and the batch-size tripwire.
# ----------------------------------------------------------------------
_MUTABLE_MD_FIELDS = ("throughput_schedule", "dirichlet")


def _copy_flat_state(flat: dict) -> dict:
    out = dict(flat)
    out["job_metadata"] = {
        job_id: {
            **md_state,
            **{
                f: copy.copy(md_state[f])
                for f in _MUTABLE_MD_FIELDS
                if f in md_state
            },
        }
        for job_id, md_state in flat["job_metadata"].items()
    }
    return out


def clone_planner(planner):
    """An isolated planner clone sharing no mutable state with the
    live planner (numpy profile arrays are shared read-only — nothing
    rebinding them in place exists on either side)."""
    from shockwave_tpu_torch.policies.shockwave import planner_from_state

    state = planner.state_dict()
    if "children" in state:
        state = dict(state)
        state["children"] = type(state["children"])(
            (name, _copy_flat_state(child))
            for name, child in state["children"].items()
        )
    else:
        state = _copy_flat_state(state)
    # The clone's device solves run where the live planner's do.
    return planner_from_state(state, device=planner.device)


# ----------------------------------------------------------------------
# Fingerprints: what must agree between prediction and reality for a
# speculative plan to install. Computed identically on the clone (after
# the predicted outcome is applied) and on the live planner at the
# boundary.
# ----------------------------------------------------------------------
def _flat_fingerprint(planner) -> dict:
    return {
        "capacity": int(planner.num_gpus),
        "progress": {
            j: int(md.completed_epochs)
            for j, md in planner.job_metadata.items()
            if md.completed_epochs < md.total_epochs
        },
    }


def planner_fingerprint(planner) -> dict:
    children = getattr(planner, "children", None)
    if children is None:
        return _flat_fingerprint(planner)
    return {
        "capacity": int(planner.num_gpus),
        "cells": {
            name: {
                **_flat_fingerprint(child),
                "capacity": int(planner.cells[name]),
            }
            for name, child in children.items()
        },
    }


def _diff_flat(predicted: dict, live: dict, tolerance: int) -> List[str]:
    reasons = []
    if predicted["capacity"] != live["capacity"]:
        reasons.append(
            f"capacity {predicted['capacity']} -> {live['capacity']}"
        )
    pred_jobs, live_jobs = predicted["progress"], live["progress"]
    arrived = sorted(str(j) for j in live_jobs.keys() - pred_jobs.keys())
    departed = sorted(str(j) for j in pred_jobs.keys() - live_jobs.keys())
    if arrived:
        reasons.append(f"arrived:{','.join(arrived[:4])}")
    if departed:
        reasons.append(f"departed:{','.join(departed[:4])}")
    drifted = sorted(
        str(j)
        for j in pred_jobs.keys() & live_jobs.keys()
        if abs(pred_jobs[j] - live_jobs[j]) > tolerance
    )
    if drifted:
        reasons.append(f"progress:{','.join(drifted[:4])}")
    return reasons


def diff_fingerprints(
    predicted: dict, live: dict, tolerance: int
) -> Dict[str, List[str]]:
    """{} when the speculation still describes reality; otherwise a map
    of scope ("" for a flat planner, the cell name for a federation) to
    human-readable churn reasons."""
    if "cells" not in predicted or "cells" not in live:
        reasons = _diff_flat(predicted, live, tolerance)
        return {"": reasons} if reasons else {}
    out: Dict[str, List[str]] = {}
    if predicted["capacity"] != live["capacity"]:
        out[""] = [
            f"capacity {predicted['capacity']} -> {live['capacity']}"
        ]
    names = predicted["cells"].keys() | live["cells"].keys()
    for name in sorted(names):
        pred = predicted["cells"].get(name)
        liv = live["cells"].get(name)
        if pred is None or liv is None:
            out[name] = ["cell set changed"]
            continue
        reasons = _diff_flat(pred, liv, tolerance)
        if pred["capacity"] != liv["capacity"]:
            reasons.append(
                f"cell capacity {pred['capacity']} -> {liv['capacity']}"
            )
        if reasons:
            out[name] = reasons
    return out


# ----------------------------------------------------------------------
# Observability taps (shared by both planner kinds).
# ----------------------------------------------------------------------
def observe_reconcile(outcome: str, round_index: int, detail=None) -> None:
    obs.counter(
        "speculation_rounds_total",
        "boundary reconciles of speculative plans, by outcome",
    ).inc(outcome=outcome)
    recorder = obs.get_recorder()
    if recorder.enabled:
        record = {"kind": outcome, "round": int(round_index)}
        if detail:
            record["detail"] = detail
        recorder.record_speculation(record)
    obs.instant(
        "speculation_" + outcome, cat="plan", pid="solver",
        tid="speculation",
        args={"round": int(round_index), **({"detail": str(detail)} if detail else {})},
    )


def observe_hidden_solve(seconds: float) -> None:
    obs.histogram(
        "shockwave_plan_hidden_seconds",
        "speculative plan-solve wall time hidden behind round execution",
    ).observe(seconds)


def observe_exposed(seconds: float, round_duration: float) -> None:
    """Planning time spent on the round loop's thread — reconcile,
    install, and any (repair or serial) solve, whether it lands at the
    boundary or in physical mode's mid-round pass (overlapped with
    worker execution wall-clock-wise, but holding the condition lock).
    Both A/B arms count the same quantity; the speculative path's win
    is moving solves off this thread entirely."""
    obs.histogram(
        "shockwave_plan_exposed_seconds",
        "boundary planning wall time the round loop waited for",
    ).observe(seconds)
    if round_duration > 0:
        obs.gauge(
            "effective_planning_overhead",
            "exposed boundary planning time as a fraction of the round",
        ).set(seconds / round_duration)


def begin_speculation(planner, outcome: SpecOutcome, background: bool = False):
    """Shared entry point behind ``speculate_next_round``:
    snapshot+clone under the caller's lock discipline, and run the
    apply+solve inline or on a daemon thread. Reconcile identity needs
    no generation counter — the boundary pops ``planner._speculation``
    before judging it, so a newer speculation can never be reconciled
    against an older boundary."""
    spec = Speculation(outcome)
    spec.base_solve_records = planner._spec_solve_base()
    clone = clone_planner(planner)
    # The clone must never consume injected solver faults (they are the
    # LIVE ladder's events — a speculative solve burning one would
    # de-synchronize chaos runs from their serial baseline) and must
    # not write its hidden solve time into the exposed-boundary ledger.
    _mark_speculative(clone)
    planner._speculation = spec
    if background:
        threading.Thread(
            target=run_speculation,
            args=(spec, clone, {}, speculation_stream(planner)),
            daemon=True,
        ).start()
    else:
        run_speculation(spec, clone, {})
    return spec


def speculation_stream(planner):
    """The CUDA stream a planner's background speculation runs on: one
    of the planner's own, made at first use (the pattern of
    ``ShockwavePlanner._rung_stream``), so the solve's launches do not
    serialise with the round loop's on its thread's current stream;
    None off the card."""
    device = getattr(planner, "device", None)
    if getattr(device, "type", None) != "cuda":
        return None
    stream = getattr(planner, "_spec_stream", None)
    if stream is None:
        import torch

        stream = torch.cuda.Stream(device)
        planner._spec_stream = stream
    return stream


def _mark_speculative(clone) -> None:
    clone._speculative = True
    for child in getattr(clone, "children", {}).values():
        child._speculative = True


def reconcile_speculation(planner) -> Optional[str]:
    """Reconcile a planner's pending speculation against reality at the
    round boundary. Returns None (nothing pending, or a mid-round pass
    before the target boundary) or the outcome: "hit" (speculative
    plan installed, boundary pays no solve), "repair" (churn on a
    boundary that was going to re-solve anyway — the planner arms its
    delta-patched repair path, warm-started from the speculative
    window), "miss" (speculation unusable, or churn on a cache-valid
    boundary; serial path untouched). The planner supplies the
    kind-specific hooks ``_install_speculation(spec)``,
    ``_prepare_repair(spec, mismatch) -> bool`` (True when a repair
    solve was armed) and ``_augment_mismatch(mismatch)``."""
    spec = planner._speculation
    if spec is None:
        return None
    if planner.round_index < spec.outcome.target_round:
        return None
    planner._speculation = None
    if not spec.done.wait(planner._speculate_join_s):
        planner.spec_stats["miss"] += 1
        observe_reconcile("miss", planner.round_index, "join_timeout")
        return "miss"
    if spec.event is not None:
        # The solve's last launch on the speculation stream has finished
        # before the plan is read.
        spec.event.synchronize()
    from shockwave_tpu_torch.policies.shockwave import _is_device_fault

    if _is_device_fault(spec.error):
        # A broken kernel or card is raised, not reconciled as a miss.
        raise spec.error
    if spec.error is not None or (
        planner.round_index != spec.outcome.target_round
    ):
        reason = (
            f"error:{type(spec.error).__name__}"
            if spec.error is not None
            else f"round_skew:{spec.outcome.target_round}"
            f"->{planner.round_index}"
        )
        planner.spec_stats["miss"] += 1
        observe_reconcile("miss", planner.round_index, reason)
        return "miss"
    mismatch = diff_fingerprints(
        spec.fingerprint,
        planner_fingerprint(planner),
        planner._speculate_epoch_tolerance,
    )
    mismatch = planner._augment_mismatch(mismatch)
    if not mismatch:
        planner._install_speculation(spec)
        planner.spec_stats["hit"] += 1
        observe_reconcile(
            "hit", planner.round_index,
            "installed" if spec.solved else "cache_valid",
        )
        return "hit"
    detail = {
        scope or "fleet": reasons for scope, reasons in mismatch.items()
    }
    if planner._prepare_repair(spec, mismatch):
        planner.spec_stats["repair"] += 1
        observe_reconcile("repair", planner.round_index, detail)
        return "repair"
    # Churned, but the serial boundary serves its cache: discard the
    # speculation so pipelined and serial runs make the same decision.
    planner.spec_stats["miss"] += 1
    observe_reconcile(
        "miss", planner.round_index, {"cache_valid": True, **detail}
    )
    return "miss"


def run_speculation(spec: Speculation, clone, tags: dict,
                    stream=None) -> None:
    """Apply the predicted outcome to the clone, advance it to the
    target round, and replan if (and only if) the boundary would. Runs
    inline in simulation, on a daemon thread in physical mode; touches
    nothing but the clone and the (locked) obs planes. With ``stream``
    (a background solve on a card) the solve launches on it and records
    ``spec.event`` after its last launch."""
    outcome = spec.outcome
    if stream is None:
        on_stream = contextlib.nullcontext()
    else:
        import torch

        on_stream = torch.cuda.stream(stream)
    try:
        with on_stream, obs.span(
            "speculate", cat="plan", pid="solver", tid="speculation",
            args={"round": outcome.target_round},
        ):
            for job, round_id, tput, bs in outcome.throughputs:
                clone.record_round_throughput(job, round_id, tput, bs)
            for job, epochs in outcome.progress.items():
                clone.set_progress(job, epochs)
            for job in outcome.completions:
                clone.mark_complete(job)
                clone.remove_job(job)
            if outcome.capacity != clone.num_gpus:
                clone.set_capacity(outcome.capacity)
            clone.increment_round()
            spec.fingerprint = planner_fingerprint(clone)
            clone._plan_record_tags = {"speculative": True, **tags}
            before = getattr(clone, "_replan_epoch", 0)
            t0 = time.perf_counter()
            # current_round_schedule is the boundary's own entry point:
            # it replans exactly when the boundary would (stale cache,
            # recompute flag, exhausted window) and serves from cache
            # otherwise — a cache-served boundary is a solve-free hit.
            clone.current_round_schedule()
            spec.solve_seconds = time.perf_counter() - t0
            spec.solved = getattr(clone, "_replan_epoch", 0) > before
            if spec.solved:
                observe_hidden_solve(spec.solve_seconds)
            if stream is not None:
                spec.event = torch.cuda.Event()
                spec.event.record(stream)
        spec.clone = clone
    except Exception as e:  # noqa: BLE001 - surfaced at the reconcile
        spec.error = e
        obs.counter(
            "speculation_failures_total",
            "speculative solves that raised (reconciled as misses)",
        ).inc()
    finally:
        spec.done.set()
