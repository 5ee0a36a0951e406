"""The Shockwave policy: per-round Volatile Fisher Market planning.

The port of the JAX package's ``shockwave_tpu/policies/shockwave.py``
for the backends of the simulation main path:
  * ``tpu`` — the production dispatch: the C++ host greedy below a work
    of 4e6 (num_gpus x future_rounds x jobs), else the level-set solve
    on the planner's device;
  * ``level`` — the level-set solve forced
    (:func:`shockwave_tpu_torch.solver.eg_level.solve_eg_level`);
  * ``native`` — the C++ greedy forced;
  * ``pdhg`` — the restarted PDHG solve
    (:func:`shockwave_tpu_torch.solver.eg_pdhg.solve_eg_pdhg`, one launch
    of kernel A on a card), warm-started from the previous plan;
  * ``relaxed`` — the projected-gradient solve
    (:func:`shockwave_tpu_torch.solver.eg_relaxed.solve_eg_relaxed`, one
    launch of kernel B, then a bounded PDHG polish);
  * ``reference`` — the exact MILP on the host
    (:func:`shockwave_tpu_torch.solver.eg_milp.solve_eg_milp`, scipy's
    HiGHS within ``solver_rel_gap`` and ``solver_timeout``), then the
    MILP reorder of the unfair jobs; each call's HiGHS status lands in
    ``milp_statuses``.
With ``plan_deadline_s`` in the config, or a fault injector armed
(``shockwave_tpu_torch/runtime/faults.py``), a solve runs down the
degradation ladder: the configured backend, then ``pdhg``, ``relaxed``
and ``native``, each rung bounded by what is left of the deadline.

The ``cells`` backend, or any backend with ``cells`` >= 2 in the config,
plans through the cell-decomposed market
(:class:`shockwave_tpu_torch.cells.planner.CellPlanner`). A planner's
``state_dict`` is the JAX package's, key for key, and
:func:`planner_from_state` restores a flat, ``cell_set`` or ``pool_set``
state that either package wrote. ``"hetero_pools": true`` plans a mixed
cluster as one planner a worker type (:class:`PoolSetPlanner`). With
``"speculate": true`` the scheduler solves the next round ahead and the
planner reconciles it at the boundary
(:mod:`shockwave_tpu_torch.policies.speculation`); a churned boundary
that replans anyway re-solves through the ``pdhg`` backend, warm-started
from the speculative window, whatever the configured backend (kernel A
on a card). The ``sharded`` backend forces the level solve sharded
over the job slots of a one-process solve mesh, every card visible
beside the planner's device once
(:func:`shockwave_tpu_torch.solver.eg_sharded.solve_eg_level_sharded`);
its counts, and so its plans, are the ``level`` backend's. The device
of the device solves is passed explicitly (``ShockwavePolicy(backend,
device=...)``).

A rung that blows the deadline is abandoned as a thread and runs on to
its end, as in the reference. On a card its kernel would hold the
stream the next device rung launches on, and that rung would queue
behind it and spend its own budget waiting. So each deadline-bounded
rung on a card runs on a stream of its own (:func:`_rung_stream`): one
problem's kernel takes one block, one of the card's 132 SMs, and the
next rung's launch runs beside it. The final rung runs in the calling
thread on the current stream, and ``native`` needs no card at all.

The ladder, and a repair solve's fallback to the configured backend,
step past a rung's timeout, an injected fault or a solver error, but not
past a broken card or kernel: a
:class:`~shockwave_tpu_torch.ops._build.KernelError` (a kernel that does
not build, load or launch) or a ``torch.AcceleratorError`` (a fault the
card reported) propagates, so no device rung's failure ends in a plan
from the host greedy. On a card the ladder builds both first-order
kernels before its clock starts, so an nvcc run at first use is not
charged to the plan's budget, and a build that fails raises there. A
device fault in a rung abandoned at its deadline is raised by the next
ladder solve.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.policies.base import Policy
from shockwave_tpu_torch.policies.speculation import SpeculativePlannerMixin
from shockwave_tpu_torch.predictor import JobMetadata
from shockwave_tpu_torch.solver.eg_problem import EGProblem

DEFAULT_LOG_BASES = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]

# Fleet scale at which the "tpu" dispatch shards one solve over every
# card visible beside the planner's device: the reference's default
# (shockwave_tpu/policies/shockwave.py:49), not a crossover measured on
# the card; SHOCKWAVE_SHARDED_MIN_JOBS overrides it per deployment.
SHARDED_DISPATCH_MIN_JOBS = 8192


def sharded_dispatch_min_jobs() -> int:
    """Live threshold for the "tpu" backend's sharded dispatch:
    SHOCKWAVE_SHARDED_MIN_JOBS when set, else the module default."""
    import os

    raw = os.environ.get("SHOCKWAVE_SHARDED_MIN_JOBS", "").strip()
    return int(raw) if raw else SHARDED_DISPATCH_MIN_JOBS


# Work (num_gpus x future_rounds x jobs) below which the "tpu" dispatch
# takes the C++ host greedy: the reference's default
# (shockwave_tpu/policies/shockwave.py:831), kept as it is. The H100's
# measured crossover between the two is in PERF.md.
NATIVE_MAX_WORK = 4e6

BACKENDS = ("tpu", "level", "native", "sharded", "pdhg", "relaxed",
            "reference")


def _is_device_fault(error: Optional[BaseException]) -> bool:
    """A failure the ladder must not step past: a kernel that does not
    build, load or launch, or a fault the card reported."""
    from shockwave_tpu_torch.ops._build import KernelError

    return isinstance(
        error, (KernelError, getattr(torch, "AcceleratorError", KernelError))
    )


class ShockwavePlanner(SpeculativePlannerMixin):
    """Plans a boolean (job x future-round) schedule each planning window.

    State: per-job predictor metadata, finish-time-estimate history, the
    schedule cache keyed by absolute round index, and the recompute flag
    (set on batch-size changes; reference: scheduler/scheduler.py:3590-3591).
    """

    def __init__(self, config: dict, backend: str = "tpu", device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown Shockwave backend {backend!r}")
        self.config = dict(config)
        self.backend = backend
        self.device = torch.device(device)
        self.num_gpus = int(config["num_gpus"])
        self.round_duration = float(config["time_per_iteration"])
        self.future_rounds = int(config.get("future_rounds", 20))
        self.priority_power = float(config.get("lambda", 5.0))
        self.regularizer = float(config.get("k", 10.0))
        self.log_bases = list(
            config.get("log_approximation_bases", DEFAULT_LOG_BASES)
        )
        # The exact MILP's (``reference``) relative gap and time limit.
        self.solver_rel_gap = float(config.get("solver_rel_gap", 1e-3))
        self.solver_timeout = float(config.get("solver_timeout", 15.0))
        self.solver_num_steps = int(config.get("solver_num_steps", 256))
        # Fixed-point tolerance of the restarted-PDHG backend (the
        # objective-stall stop usually fires first; see eg_pdhg).
        self.pdhg_tol = float(config.get("pdhg_tol", 1e-4))
        # Preemption-aware planning: scale on the per-job measured
        # relaunch overheads the scheduler threads through add_job. 0
        # disables the switching-cost term even when overheads are known.
        self.switch_cost_weight = float(config.get("switch_cost_weight", 1.0))
        # Migration hysteresis of the stickiness pass (1.0: break-even).
        self.stickiness_hysteresis = float(
            config.get("stickiness_hysteresis", 1.0)
        )
        # Per-round planning deadline (seconds) for the degradation
        # ladder: primary backend -> restarted PDHG -> relaxed PGD ->
        # native greedy, each rung budgeted against what remains. None
        # (default) keeps the single-backend behavior; the ladder also
        # engages when fault injection is armed.
        raw_deadline = config.get("plan_deadline_s")
        self.plan_deadline_s = (
            float(raw_deadline) if raw_deadline is not None else None
        )
        # Ladder outcome of the most recent solve (consumed by
        # _record_solve to tag degraded rounds in solve_records).
        self._last_ladder: Optional[dict] = None
        # (thread, result box) of rungs abandoned at their deadline; a
        # device fault one of them ends in is raised by the next ladder.
        self._abandoned: List[tuple] = []
        # Plan-ahead pipelining (policies/speculation.py): the scheduler
        # supplies predicted outcomes; the planner reconciles. A repair
        # reconcile sets the flag: the next solve goes through the
        # delta-patched, warm-started PDHG path first.
        self._init_speculation(config)
        self._repair_with_spec = False

        self.round_index = 0
        self.recompute_flag = False
        self.schedules: "OrderedDict[int, list]" = OrderedDict()
        self.job_metadata: "OrderedDict[object, JobMetadata]" = OrderedDict()
        self.finish_time_estimates: Dict[object, list] = {}
        # Per-job measured relaunch overhead (seconds); 0.0 = overhead-blind.
        self.job_overheads: Dict[object, float] = {}
        # Jobs scheduled in the round that just executed — the incumbent
        # placements a replan is charged for dropping.
        self.last_round_jobs: List[object] = []
        # One record per plan solve ({"backend": the backend that
        # actually solved — "tpu" dispatches to native or level per
        # problem size — "seconds" of wall clock, "ok", "round",
        # "num_jobs", and "error" on failures}).
        self.solve_records: List[dict] = []
        # HiGHS's status of every MILP call of the ``reference`` backend
        # (solver/eg_milp.py: 0 optimal within the gap, 1 the time limit).
        self.milp_statuses: List[int] = []
        # Worker-type tag when owned by a PoolSetPlanner (flight-recorder
        # records carry it so per-pool decisions stay attributable).
        self.pool_label: Optional[str] = None
        # The last committed replan's per-job spend (job key ->
        # chip-rounds) for the scheduler's per-tenant spend gauges.
        # Telemetry only: not part of state_dict or replay.
        self.last_market: Optional[dict] = None

    # -- scheduler-facing interface -------------------------------------
    def add_job(
        self, job_id, profile: dict, round_len: float, scale_factor: int,
        submit_time: Optional[float] = None, overhead_s: float = 0.0,
    ) -> None:
        md = JobMetadata(profile, round_len, scale_factor)
        if submit_time is not None:
            md.submit(submit_time)
        self.job_metadata[job_id] = md
        self.job_overheads[job_id] = float(overhead_s)

    def remove_job(self, job_id) -> None:
        self.job_metadata.pop(job_id, None)
        self.finish_time_estimates.pop(job_id, None)
        self.job_overheads.pop(job_id, None)

    def record_round_throughput(self, job_id, round_id, throughput, bs) -> None:
        md = self.job_metadata.get(job_id)
        if md is not None:
            md.record_round_throughput(round_id, throughput, bs)

    def mark_complete(self, job_id) -> None:
        md = self.job_metadata.get(job_id)
        if md is not None:
            md.complete()

    def set_progress(self, job_id, num_epochs: int) -> None:
        md = self.job_metadata.get(job_id)
        if md is not None:
            md.complete(min(int(num_epochs), md.total_epochs))

    def get_metadata(self, job_id) -> Optional[JobMetadata]:
        """The job's predictor state (calibration scoring reads the live
        remaining-runtime forecast through this)."""
        return self.job_metadata.get(job_id)

    def set_capacity(self, num_gpus: int) -> None:
        """Capacity changed under the planner: solve the next plan against
        the fleet that exists, clamped to >= 1 chip (reference
        shockwave.py:196-206)."""
        num_gpus = max(1, int(num_gpus))
        if num_gpus == self.num_gpus:
            return
        self.num_gpus = num_gpus
        self.config["num_gpus"] = num_gpus
        self.recompute_flag = True

    def increment_round(self) -> None:
        # The round at the cursor has just executed: its jobs are the
        # incumbents the next replan's switching-cost term protects.
        self.last_round_jobs = list(self.schedules.get(self.round_index, []))
        self.round_index += 1

    def set_recompute_flag(self, jobs=None) -> None:
        """Force a replan (``jobs`` names the jobs whose state changed)."""
        self.recompute_flag = True

    @property
    def num_jobs(self) -> int:
        return len(self.job_metadata)

    # -- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        """Plain dicts and arrays: config, round cursor, plan cache,
        per-job predictor metadata and finish-time history (reference
        shockwave.py:220-245, the same keys)."""
        return {
            "config": dict(self.config),
            "backend": self.backend,
            "round_index": self.round_index,
            "recompute_flag": self.recompute_flag,
            "schedules": OrderedDict(
                (r, list(s)) for r, s in self.schedules.items()
            ),
            "job_metadata": OrderedDict(
                (j, md.state_dict()) for j, md in self.job_metadata.items()
            ),
            "finish_time_estimates": {
                j: list(h) for j, h in self.finish_time_estimates.items()
            },
            "job_overheads": dict(self.job_overheads),
            "last_round_jobs": list(self.last_round_jobs),
            "solve_times": [r["seconds"] for r in self.solve_records],
            "solve_records": [dict(r) for r in self.solve_records],
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "ShockwavePlanner":
        """Restore a :meth:`state_dict` either package wrote (reference
        shockwave.py:247-271); its device solves run on ``device``."""
        planner = cls(state["config"], backend=state["backend"],
                      device=device)
        planner.round_index = int(state["round_index"])
        planner.recompute_flag = bool(state["recompute_flag"])
        planner.schedules = OrderedDict(
            (r, list(s)) for r, s in state["schedules"].items()
        )
        planner.job_metadata = OrderedDict(
            (j, JobMetadata.from_state(md))
            for j, md in state["job_metadata"].items()
        )
        planner.finish_time_estimates = {
            j: list(h) for j, h in state["finish_time_estimates"].items()
        }
        planner.job_overheads = dict(state.get("job_overheads", {}))
        planner.last_round_jobs = list(state.get("last_round_jobs", []))
        # Set in a plan record made by a ladder rung below the primary
        # (recorded by this package only; see _replan).
        planner._replay_as_fallback = bool(state.get("replay_as_fallback"))
        if state.get("pdhg_warm_start") is not None:
            # Replayed snapshot: the plan cache this vector was derived
            # from is not in the record — carry the vector itself.
            planner._replay_warm_start = list(state["pdhg_warm_start"])
        planner.solve_records = [
            dict(r) for r in state.get("solve_records", [])
        ]
        return planner

    # -- plan-ahead pipelining ------------------------------------------
    # speculate_next_round, _reconcile_speculation and _observe_boundary
    # come from SpeculativePlannerMixin; the hooks below are this planner
    # kind's reconcile semantics (reference shockwave.py:274-350).
    def _spec_solve_base(self) -> int:
        """Solve-record count at snapshot time (an install appends only
        the clone's records past it)."""
        return len(self.solve_records)

    def _augment_mismatch(self, mismatch: dict) -> dict:
        """External staleness (a batch-size switch, a capacity change) the
        fingerprints cannot see is churn too."""
        if self.recompute_flag:
            mismatch = dict(mismatch)
            mismatch.setdefault("", []).append("recompute_flagged")
        return mismatch

    def _install_speculation(self, spec) -> None:
        """No-churn boundary: adopt the clone's plan window, the
        finish-time history its problem build appended, and its solve
        records. The live predictor inputs stay as they are (in
        simulation they equal the clone's by exact prediction)."""
        clone = spec.clone
        if not spec.solved:
            return  # the boundary serves from cache either way
        self.schedules = OrderedDict(
            (r, list(s)) for r, s in clone.schedules.items()
        )
        self.finish_time_estimates = {
            j: list(h) for j, h in clone.finish_time_estimates.items()
        }
        self.solve_records.extend(
            dict(r) for r in clone.solve_records[spec.base_solve_records:]
        )
        self.recompute_flag = False

    def _boundary_stale(self) -> bool:
        """Whether the boundary would replan: recompute flagged, no cached
        round at the cursor, or a cached round whose jobs all completed
        while incomplete jobs remain (as :meth:`current_round_schedule`)."""
        if self.recompute_flag or self.round_index not in self.schedules:
            return True
        schedule = self.schedules[self.round_index]
        live = [
            j
            for j in schedule
            if j in self.job_metadata
            and self.job_metadata[j].completed_epochs
            < self.job_metadata[j].total_epochs
        ]
        return not live and self._has_incomplete_jobs()

    def _prepare_repair(self, spec, mismatch: dict) -> bool:
        """Churned boundary. Only when the boundary was going to replan
        anyway (so pipelining never replans more eagerly than serial):
        the speculative window, when one was solved, becomes the plan
        cache's warm basis, and the replan goes through the delta-patched
        PDHG path. Returns whether a repair solve was armed."""
        if not self._boundary_stale():
            return False
        if spec.solved:
            self.schedules = OrderedDict(
                (r, list(s)) for r, s in spec.clone.schedules.items()
            )
        self.recompute_flag = True
        self._repair_with_spec = True
        return True

    def current_round_schedule(self) -> list:
        """This round's job list, from the plan cache or a fresh solve
        (reference: shockwave.py:77-91). A cached round whose scheduled
        jobs have all since completed triggers a replan while incomplete
        jobs remain (the reference returns the stale empty round, which
        the scheduler reads as end-of-trace). A pending speculation for
        this boundary is reconciled first; the wall time this call spends
        on the reconcile and any solve is the exposed planning time."""
        start = time.perf_counter()
        reconciled = self._reconcile_speculation()
        if not self.recompute_flag and self.round_index in self.schedules:
            schedule = self.schedules[self.round_index]
            live = [
                j
                for j in schedule
                if j in self.job_metadata
                and self.job_metadata[j].completed_epochs
                < self.job_metadata[j].total_epochs
            ]
            if live or not self._has_incomplete_jobs():
                if reconciled is not None:
                    self._observe_boundary(time.perf_counter() - start)
                return schedule
        self._replan()
        self.recompute_flag = False
        self._observe_boundary(time.perf_counter() - start)
        return self.schedules[self.round_index]

    def _has_incomplete_jobs(self) -> bool:
        return any(
            md.completed_epochs < md.total_epochs
            for md in self.job_metadata.values()
        )

    # -- planning -------------------------------------------------------
    def _build_problem(self):
        """Predictor state -> EGProblem arrays + this window's priorities.

        Finish-time fairness per job (reference: shockwave.py:244-279):
        predicted JCT under contention divided by the window-weighted
        running average of its isolated finish-time estimates.
        """
        job_ids = [
            j
            for j, md in self.job_metadata.items()
            if md.completed_epochs < md.total_epochs
        ]
        # Plan-order job ids of the problem being built (the PDHG
        # backend's solution warm start maps cached future schedules
        # back onto problem rows through this).
        self._plan_job_ids = list(job_ids)
        if not job_ids:
            return None, []
        J = len(job_ids)
        completed = np.zeros(J)
        total = np.zeros(J)
        epoch_dur = np.zeros(J)
        remaining = np.zeros(J)
        nworkers = np.zeros(J)
        priorities = np.zeros(J)
        contention = self.num_jobs / self.num_gpus
        round_time = (self.round_index + self.future_rounds) * self.round_duration
        for i, job_id in enumerate(job_ids):
            md = self.job_metadata[job_id]
            md.recompute_epoch_durations()
            completed[i] = md.completed_epochs
            total[i] = md.total_epochs
            epoch_dur[i] = md.mean_epoch_duration()
            rem = md.remaining_runtime()
            remaining[i] = rem
            nworkers[i] = md.nworkers
            predicted_jct = round_time + rem * contention
            predicted_finish = (
                float(np.sum(md.epoch_durations[: md.completed_epochs])) + rem
            )
            history = self.finish_time_estimates.setdefault(job_id, [])
            history.append((self.round_index, predicted_finish))
            ftf = predicted_jct / self._interpolated_finish_time(job_id)
            priorities[i] = ftf ** self.priority_power
        # Switching-cost inputs: measured relaunch overhead per job and
        # the incumbent mask (who held workers in the round that just
        # ran). All-zero overheads leave the problem bit-identical to
        # the overhead-blind formulation.
        incumbent_set = set(self.last_round_jobs)
        switch_cost = np.array(
            [
                self.switch_cost_weight * self.job_overheads.get(j, 0.0)
                for j in job_ids
            ]
        )
        incumbent = np.array(
            [1.0 if j in incumbent_set else 0.0 for j in job_ids]
        )
        problem = EGProblem(
            priorities=priorities,
            completed_epochs=completed,
            total_epochs=total,
            epoch_duration=epoch_dur,
            remaining_runtime=remaining,
            nworkers=nworkers,
            num_gpus=self.num_gpus,
            round_duration=self.round_duration,
            future_rounds=self.future_rounds,
            regularizer=self.regularizer,
            log_bases=np.asarray(self.log_bases, dtype=np.float64),
            switch_cost=switch_cost,
            incumbent=incumbent,
        )
        return problem, job_ids

    def _interpolated_finish_time(self, job_id, alpha: float = 0.9) -> float:
        """Window-weighted running average blended with the latest estimate
        (reference: shockwave.py:224-242, including the quirk that the
        weight vector's length truncates the estimate list)."""
        history = self.finish_time_estimates[job_id]
        round_ids = np.array([r for r, _ in history], dtype=np.float64)
        windows = np.diff(round_ids)
        if windows.size == 0 or np.sum(windows) == 0:
            weights = np.array([1.0])
        else:
            weights = windows / np.sum(windows)
        finish_times = np.array([ft for _, ft in history[: weights.size]])
        avg = float(np.dot(weights, finish_times))
        return max(1e-6, alpha * avg + (1 - alpha) * history[-1][1])

    def _solve(self, problem: EGProblem) -> "Tuple[np.ndarray, str]":
        """Returns (schedule, backend_used): ``backend_used`` is the
        backend that actually produced the solve, which for the "tpu"
        dispatch differs per problem size. With a planning deadline
        (``plan_deadline_s``) or armed fault injection the solve runs
        down the degradation ladder (:meth:`_solve_with_ladder`);
        otherwise it is a straight dispatch to the configured backend
        (reference shockwave.py:485-544).

        A repair reconcile's solve goes through the ``pdhg`` backend
        first, warm-started from the speculative window, whatever the
        configured backend is: on a card, one launch of kernel A. Where
        that solve raises, the configured backend is the fallback, as in
        the reference, except for a device fault, which is raised."""
        from shockwave_tpu_torch.runtime import faults

        # A speculative clone never consumes injected solver faults: they
        # are the live ladder's events.
        injector = (
            None if getattr(self, "_speculative", False) else faults.active()
        )
        self._last_ladder = None
        repair = self._repair_with_spec
        self._repair_with_spec = False
        self._last_repair = repair
        self._attempted_backend = self.backend
        # Computed once per solve, before the plan cache is overwritten,
        # and only when a pdhg solve can happen this round.
        pdhg_possible = (
            self.backend == "pdhg"
            or repair
            or self.plan_deadline_s is not None
            or injector is not None
        )
        self._solve_warm_start = (
            self._solution_warm_start() if pdhg_possible else None
        )
        if getattr(self, "_replay_as_fallback", False):
            # A replayed plan that a ladder rung below the primary made:
            # its backend re-enters as that rung did.
            self._replay_as_fallback = False
            return self._solve_backend(self.backend, problem,
                                       as_fallback=True)
        if self.plan_deadline_s is None and injector is None:
            if repair and self.backend != "pdhg":
                try:
                    return self._solve_backend("pdhg", problem)
                except Exception as e:
                    if _is_device_fault(e):
                        raise
                    obs.counter(
                        "speculation_repair_fallbacks_total",
                        "repair solves that fell back to the "
                        "configured backend",
                    ).inc()
                    self._attempted_backend = self.backend
            return self._solve_backend(self.backend, problem)
        return self._solve_with_ladder(problem, injector, repair=repair)

    def _ladder_rungs(self) -> List[str]:
        """Degradation ladder: configured backend, then the restarted
        PDHG first-order solve, then the relaxed PGD solve, then the
        native greedy (host-only). Rungs the host cannot run (no C++
        toolchain) are dropped; the primary always stays."""
        from shockwave_tpu_torch import native

        rungs = [self.backend]
        for fallback in ("pdhg", "relaxed", "native"):
            if fallback not in rungs:
                rungs.append(fallback)
        if not native.available():
            rungs = [r for r in rungs if r != "native"] or [self.backend]
        return rungs

    def _rung_stream(self):
        """The stream a deadline-bounded rung runs on: a new one on a
        card (module docstring), none on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    def _solve_with_ladder(
        self, problem: EGProblem, injector, repair: bool = False
    ) -> "Tuple[np.ndarray, str]":
        """Run the solve down the degradation ladder under the round's
        planning budget (reference shockwave.py:562-710). Every rung but
        the last is bounded by the remaining deadline (a rung that blows
        it is abandoned: its thread is left to finish into the void);
        the final rung runs to completion unconditionally, because a
        plan is mandatory. Injected solver faults are consumed one per
        attempt: ``solver_timeout`` charges the rung as timed out
        without burning wall clock, ``solver_slowdown`` stretches the
        attempt by ``delay_s`` so a real deadline can overrun. A repair
        solve puts the ``pdhg`` rung first."""
        import threading

        self._raise_abandoned_device_fault()
        if self.device.type == "cuda":
            from shockwave_tpu_torch.ops import _build

            for name in ("eg_pdhg", "eg_relaxed"):
                _build.library(name)
        start = time.monotonic()
        deadline = self.plan_deadline_s
        rungs = self._ladder_rungs()
        if repair and "pdhg" in rungs:
            rungs = ["pdhg"] + [r for r in rungs if r != "pdhg"]
        attempts: List[dict] = []
        faults_hit: list = []
        last_error: Optional[BaseException] = None
        for i, backend in enumerate(rungs):
            is_last = i == len(rungs) - 1
            fault = (
                injector.next_solver_fault(self.round_index)
                if injector is not None
                else None
            )
            if fault is not None:
                faults_hit.append(fault)
                injector.mark_applied(
                    fault, round=self.round_index, backend=backend
                )
                obs.counter(
                    "fault_injected_total",
                    "fault events delivered by the injector",
                ).inc(kind=fault.kind)
            if (
                fault is not None
                and fault.kind == "solver_timeout"
                and not is_last
            ):
                # A plan is mandatory: an injected timeout charges every
                # rung but the last, which always runs.
                attempts.append(
                    {"backend": backend, "outcome": "timeout_injected"}
                )
                last_error = TimeoutError(
                    f"injected solver timeout (fault {fault.event_id})"
                )
                continue
            remaining = (
                None
                if deadline is None
                else deadline - (time.monotonic() - start)
            )
            if remaining is not None and remaining <= 0 and not is_last:
                attempts.append(
                    {"backend": backend, "outcome": "skipped_budget"}
                )
                continue
            delay_s = fault.delay_s if fault is not None else 0.0
            box: dict = {}

            def run_attempt(backend=backend, delay_s=delay_s, fb=(i > 0),
                            stream=contextlib.nullcontext):
                try:
                    if delay_s:
                        time.sleep(delay_s)
                    with stream():
                        box["result"] = self._solve_backend(
                            backend, problem, as_fallback=fb
                        )
                except Exception as e:  # noqa: BLE001 - re-raised below
                    box["error"] = e

            if remaining is None or is_last:
                run_attempt()
            else:
                worker = threading.Thread(
                    target=run_attempt, daemon=True,
                    kwargs={"stream": self._rung_stream},
                )
                worker.start()
                worker.join(remaining)
                if worker.is_alive():
                    self._abandoned.append((worker, box))
                    attempts.append(
                        {"backend": backend, "outcome": "timeout"}
                    )
                    last_error = TimeoutError(
                        f"{backend} solve exceeded the remaining "
                        f"{remaining:.3f}s of the {deadline}s plan budget"
                    )
                    continue
            if "error" in box:
                if _is_device_fault(box["error"]):
                    raise box["error"]
                attempts.append(
                    {
                        "backend": backend,
                        "outcome": type(box["error"]).__name__,
                    }
                )
                last_error = box["error"]
                continue
            Y, used = box["result"]
            attempts.append({"backend": used, "outcome": "ok"})
            degraded = i > 0
            self._last_ladder = {
                "degraded": degraded,
                "fallback_from": rungs[0] if degraded else None,
                "attempts": attempts,
            }
            if degraded:
                obs.counter(
                    "shockwave_solver_degraded_total",
                    "plan solves that fell down the degradation ladder",
                ).inc(backend=used)
                obs.instant(
                    "solver_degraded", cat="plan", pid="solver",
                    tid="planner",
                    args={
                        "round": self.round_index,
                        "fallback_from": rungs[0],
                        "backend": used,
                        "attempts": len(attempts),
                    },
                )
            recorder = obs.get_recorder()
            for fault in faults_hit:
                how = "ladder_fallback" if degraded else "ladder_absorbed"
                injector.mark_recovered(
                    fault.event_id, how=how, backend=used
                )
                if recorder.enabled:
                    record = {
                        "fault_id": fault.event_id,
                        "kind": fault.kind,
                        "round": self.round_index,
                        "pool": self.pool_label,
                    }
                    recorder.record_fault(record)
                    recorder.record_recovery(
                        {**record, "how": how, "backend": used}
                    )
            return Y, used
        if last_error is not None:
            raise last_error
        raise RuntimeError("degradation ladder produced no plan")

    def _raise_abandoned_device_fault(self) -> None:
        """Raise the device fault an abandoned rung ended in, if any;
        forget the abandoned rungs that have ended."""
        ended = [box for worker, box in self._abandoned
                 if not worker.is_alive()]
        self._abandoned = [(worker, box) for worker, box in self._abandoned
                           if worker.is_alive()]
        for box in ended:
            if _is_device_fault(box.get("error")):
                raise box["error"]

    def _solve_backend(
        self, backend: str, problem: EGProblem, as_fallback: bool = False
    ) -> "Tuple[np.ndarray, str]":
        """One backend's solve (the ladder's rung body), then the
        per-round reorder. ``_attempted_backend`` tracks the in-flight
        choice so a raising solver is attributed to the backend that
        actually raised. ``as_fallback`` marks a ladder rung below the
        primary: the relaxed rung then skips its PDHG polish, so a
        failing (or deadline-blowing) PDHG kernel cannot take out the
        rung that exists to recover from it."""
        from shockwave_tpu_torch import native
        from shockwave_tpu_torch.solver.eg_level import solve_eg_level
        from shockwave_tpu_torch.solver.rounding import reorder_rounds

        self._attempted_backend = backend
        if backend == "reference":
            # The exact MILP on the host, then the MILP reorder of the
            # unfair jobs into the earliest rounds.
            from shockwave_tpu_torch.solver.eg_milp import (
                reorder_unfair_jobs_milp,
                solve_eg_milp,
            )

            Y = solve_eg_milp(problem, rel_gap=self.solver_rel_gap,
                              time_limit=self.solver_timeout,
                              statuses=self.milp_statuses)
            return (
                reorder_unfair_jobs_milp(
                    Y, problem, rel_gap=self.solver_rel_gap,
                    time_limit=self.solver_timeout,
                    statuses=self.milp_statuses),
                "reference",
            )
        used = backend
        if backend == "native":
            Y = native.solve_eg_greedy_native(problem)
        elif backend == "level":
            Y = solve_eg_level(problem, self.device)
        elif backend == "sharded":
            # The level solve forced onto the solve mesh: one problem's
            # job slots over every card visible beside the planner's
            # device. Its counts are the level backend's in every bit, so
            # are its plans.
            from shockwave_tpu_torch.solver import eg_sharded

            Y = eg_sharded.solve_eg_level_sharded(problem, device=self.device)
        elif backend == "pdhg":
            # Restarted PDHG on the exact continuous relaxation,
            # solution-warm-started from the previous plan's round
            # counts when one is cached.
            from shockwave_tpu_torch.solver.eg_pdhg import solve_eg_pdhg

            Y = solve_eg_pdhg(
                problem,
                s0=getattr(self, "_solve_warm_start", None),
                tol=self.pdhg_tol,
                device=self.device,
            )
        elif backend == "relaxed":
            # Projected-gradient ascent on the exact continuous
            # relaxation, then integer rounding + per-round placement on
            # the host.
            from shockwave_tpu_torch.solver.eg_relaxed import (
                solve_eg_relaxed,
            )
            from shockwave_tpu_torch.solver.rounding import (
                schedule_from_relaxed,
            )

            s = solve_eg_relaxed(
                problem,
                num_steps=self.solver_num_steps,
                pdhg_polish=not as_fallback,
                device=self.device,
            )
            Y = schedule_from_relaxed(
                s,
                problem.priorities,
                problem.nworkers,
                problem.num_gpus,
                problem.future_rounds,
                problem=problem,
            )
        else:
            # "tpu", the production path: latency-aware dispatch. Small
            # solves go to the C++ host core, where the device's fixed
            # launch and fetch latency would dominate; above the work
            # threshold the level-set solve runs on the device. Both
            # optimize the same objective.
            Y = None
            if problem.num_jobs >= sharded_dispatch_min_jobs():
                # Fleet scale comes before the native fast path: with
                # more than one card visible, shard the one solve over
                # them all (counts equal to the one-card solve's).
                from shockwave_tpu_torch.parallel import mesh
                from shockwave_tpu_torch.solver import eg_sharded

                if len(mesh.visible_devices(self.device)) > 1:
                    self._attempted_backend = "sharded"
                    Y = eg_sharded.solve_eg_level_sharded(
                        problem, device=self.device)
                    used = "sharded"
            work = (
                float(problem.num_gpus)
                * problem.future_rounds
                * problem.num_jobs
            )
            if Y is None and work < NATIVE_MAX_WORK and native.available():
                self._attempted_backend = "native"
                Y = native.solve_eg_greedy_native(problem)
                used = "native"
            if Y is None:
                self._attempted_backend = "level"
                Y = solve_eg_level(problem, self.device)
                used = "level"
        return (
            reorder_rounds(
                Y, problem.priorities, problem.nworkers, problem.num_gpus
            ),
            used,
        )

    def _solution_warm_start(self) -> "Optional[np.ndarray]":
        """Previous-plan round counts delta-patched onto the new job
        set, or None (reference shockwave.py:855-928).

        The cached schedules for rounds >= the cursor are the
        still-valid tail of the last plan; counting each job's
        occurrences gives the s-vector that plan chose, a near-feasible
        saddle-point guess for the incremental replan.
        :func:`shockwave_tpu_torch.solver.warm_start.delta_patch_counts`
        aligns it across the churn delta. A replayed planner carries the
        derived vector instead (``_replay_warm_start``), consumed once."""
        override = getattr(self, "_replay_warm_start", None)
        job_ids = getattr(self, "_plan_job_ids", None)
        if override is not None:
            # One recorded vector, one solve: clear on consumption, and
            # drop it if it no longer matches the problem rows.
            self._replay_warm_start = None
            if job_ids is not None and len(override) == len(job_ids):
                return np.asarray(override, dtype=np.float64)
        if not job_ids:
            return None
        future = [
            s for r, s in self.schedules.items() if r >= self.round_index
        ]
        if not future:
            return None
        prev_counts: Dict[object, int] = {}
        for schedule in future:
            for j in schedule:
                prev_counts[j] = prev_counts.get(j, 0) + 1
        if not prev_counts:
            return None
        from shockwave_tpu_torch.solver import warm_start

        prev_ids = list(prev_counts)
        nworkers = np.array(
            [
                float(self.job_metadata[j].nworkers)
                if j in self.job_metadata
                else 1.0
                for j in job_ids
            ]
        )
        patched = warm_start.delta_patch_counts(
            prev_ids,
            np.array([float(prev_counts[j]) for j in prev_ids]),
            job_ids,
            nworkers,
            self.num_gpus,
            self.future_rounds,
        )
        if patched is not None:
            arrivals = sum(1 for j in job_ids if j not in prev_counts)
            if arrivals:
                obs.counter(
                    "planner_delta_arrivals_total",
                    "new jobs absorbed into a replan via the "
                    "delta-patched warm start",
                ).inc(arrivals)
        return patched

    def _record_solve(
        self, seconds: float, backend: str, num_jobs: int,
        ok: bool, error: Optional[str] = None,
    ) -> None:
        """Every solve attempt lands in ``solve_records``, failed ones
        too, tagged with the backend that produced it."""
        record = {
            "backend": backend,
            "seconds": seconds,
            "ok": ok,
            "round": self.round_index,
            "num_jobs": num_jobs,
        }
        if error is not None:
            record["error"] = error
        ladder = self._last_ladder
        if ladder is not None and ladder["degraded"]:
            # A degraded round is tagged where operators look.
            record["degraded"] = True
            record["fallback_from"] = ladder["fallback_from"]
            record["ladder"] = [dict(a) for a in ladder["attempts"]]
        if getattr(self, "_last_repair", False):
            # A repair solve: churn re-planned against a speculative
            # window through the delta-patched PDHG path.
            record["repair"] = True
        self.solve_records.append(record)
        obs.histogram(
            "shockwave_solve_seconds",
            "plan-solve wall time per backend (ok=False: failed solves)",
        ).observe(seconds, backend=backend, ok=str(ok))
        if not ok:
            obs.counter(
                "shockwave_solve_failures_total",
                "plan solves that raised or timed out",
            ).inc(backend=backend)

    def _replan(self) -> None:
        # Flight recorder: snapshot the pre-replan planner state
        # (_build_problem appends to the finish-time history it reads),
        # so replay re-enters from exactly this point.
        recorder = obs.get_recorder()
        pre_state = self.state_dict() if recorder.enabled else None
        self._replan_epoch += 1
        # Past rounds are never read again; keep the cache bounded.
        for r in [r for r in self.schedules if r < self.round_index]:
            del self.schedules[r]
        phase_h = obs.histogram(
            "shockwave_plan_phase_seconds",
            "wall time of each planning phase (build/solve/stickiness/"
            "backfill)",
        )
        with obs.span(
            "replan", cat="plan", pid="solver", tid="planner",
            args={"round": self.round_index, "backend": self.backend},
        ):
            start = time.time()
            problem, job_ids = self._build_problem()
            phase_h.observe(time.time() - start, phase="build")
            if problem is None:
                for i in range(self.future_rounds):
                    self.schedules[self.round_index + i] = []
                return
            start = time.time()
            try:
                with obs.span(
                    "solve", cat="plan", pid="solver", tid="planner",
                    args={"num_jobs": problem.num_jobs},
                ):
                    Y, backend_used = self._solve(problem)
            except Exception as e:
                elapsed = time.time() - start
                phase_h.observe(elapsed, phase="solve")
                self._record_solve(
                    elapsed, self._attempted_backend, problem.num_jobs,
                    ok=False, error=type(e).__name__,
                )
                raise
            elapsed = time.time() - start
            phase_h.observe(elapsed, phase="solve")
            self._record_solve(elapsed, backend_used, problem.num_jobs,
                               ok=True)
            start = time.time()
            Y = self._apply_stickiness(Y, problem)
            phase_h.observe(time.time() - start, phase="stickiness")
            start = time.time()
            Y = self._backfill(Y, problem)
            phase_h.observe(time.time() - start, phase="backfill")
            for r in range(self.future_rounds):
                self.schedules[self.round_index + r] = [
                    job_ids[j] for j in range(len(job_ids)) if Y[j, r]
                ]
            if pre_state is not None:
                # The backend that actually produced the plan (a ladder
                # fallback replays through it), and the pdhg warm start
                # derived from the plan cache the recorder slims out.
                pre_state["backend"] = backend_used
                if self._last_ladder is not None and (
                        self._last_ladder["degraded"]):
                    # A rung below the primary made the plan, and a rung
                    # solves as a fallback (the relaxed rung skips its
                    # polish): replay re-enters it so. The JAX package
                    # records no such flag and replays the rung as a
                    # primary (ROADMAP.md, queue 3).
                    pre_state["replay_as_fallback"] = True
                warm = getattr(self, "_solve_warm_start", None)
                pre_state["pdhg_warm_start"] = (
                    None if warm is None else [float(x) for x in warm]
                )
                recorder.record_plan(
                    planner_state=pre_state,
                    plan={
                        r: list(self.schedules[self.round_index + r])
                        for r in range(self.future_rounds)
                    },
                    backend=backend_used,
                    objective=float(problem.objective_value(Y)),
                    solve_record=self.solve_records[-1],
                    problem_summary={
                        "job_ids": list(job_ids),
                        "remaining_runtime_s": problem.remaining_runtime,
                        "priorities": problem.priorities,
                        "switch_cost": problem.switch_cost,
                        "incumbent": problem.incumbent,
                        "nworkers": problem.nworkers,
                        "num_gpus": problem.num_gpus,
                        "future_rounds": problem.future_rounds,
                    },
                    pool=self.pool_label,
                    tags=self._plan_record_tags,
                )
            self._market_attribution(problem, job_ids, Y, backend_used)

    def _market_attribution(self, problem: EGProblem, job_ids: list,
                            Y: np.ndarray, backend_used: str) -> None:
        """Market explainability tap (the JAX package's
        shockwave.py:1062-1152): the dual/price report at the final plan
        (host float64, solver/duals.py), the fleet price gauges, and with
        the recorder on the per-(job, round) attribution record that
        pairs with this replan's plan record. Pure reads of ``(problem,
        Y)``; with the recorder and metrics off, one flags check."""
        speculative = bool(
            self._plan_record_tags
            and self._plan_record_tags.get("speculative")
        )
        recorder = obs.get_recorder()
        if not (recorder.enabled or obs.metrics_enabled()):
            return
        from shockwave_tpu_torch.solver.duals import dual_report

        report = dual_report(problem, Y=Y)
        if not speculative:
            # A clone's prices commit only if the reconcile accepts its
            # plan; the gauges track committed plans.
            obs.gauge(
                "market_price",
                "fleet congestion price (budget dual) of the last plan",
            ).set(report.budget_dual)
            obs.gauge(
                "market_fairness_drift",
                "budget-weighted fair-share deficit of the last plan "
                "[0,1]",
            ).set(report.fairness_drift)
            self.last_market = {
                "round": int(self.round_index),
                "keys": [str(j) for j in job_ids],
                "spend": [float(x) for x in report.spend],
                "price": float(report.budget_dual),
            }
        if not recorder.enabled:
            return
        from shockwave_tpu_torch.obs.recorder import _job_key

        bonus = problem.switch_bonus()
        granted = report.s >= 0.5
        bonus_state = [
            ("applied" if g else "forfeited") if b > 0.0 else "none"
            for b, g in zip(bonus, granted)
        ]
        solve_record = self.solve_records[-1] if self.solve_records else {}
        detail = {
            "round": int(self.round_index),
            "backend": backend_used,
            "market": report.to_dict(),
            "degraded": bool(solve_record.get("degraded", False)),
            "fallback_from": solve_record.get("fallback_from"),
            "jobs": {
                "keys": [_job_key(j) for j in job_ids],
                "share": [float(x) for x in report.s],
                "fair_share": [float(x) for x in report.fair_share],
                "welfare": [float(x) for x in report.welfare_contribution],
                "marginal": [float(x) for x in report.marginal_welfare],
                "price": [float(x) for x in report.price],
                "spend": [float(x) for x in report.spend],
                "bonus": [float(x) for x in bonus],
                "bonus_state": bonus_state,
                "switch_cost": [float(x) for x in problem.switch_cost],
                "makespan_binding": [
                    int(x) for x in report.makespan_binding
                ],
                "predicted_finish_s": [
                    float(self.finish_time_estimates[j][-1][1])
                    if self.finish_time_estimates.get(j)
                    else None
                    for j in job_ids
                ],
            },
        }
        if self.pool_label is not None:
            detail["pool"] = self.pool_label
        if speculative:
            # The narrative builder admits this record only when the
            # boundary reconcile commits the speculative plan.
            detail["speculative"] = True
        recorder.record_attribution(detail)

    def _apply_stickiness(self, Y: np.ndarray, problem: EGProblem) -> np.ndarray:
        """Lease stickiness: pull granted incumbents into the plan's first
        round so the scheduler's keep-previous-workers pass can hold their
        placements.

        The switching-cost term decides WHETHER an incumbent keeps any
        rounds; this pass decides WHERE. All moves preserve per-job round
        counts and per-round capacity, so utility and makespan are
        untouched — only the (secondary) unfairness-reordering objective
        can regress, and a swap is taken only when the avoided relaunch
        delay beats that regression in the reorder program's own currency
        (priority-rate x rounds): displacing job k from round 0 to round
        r costs (rate_k - rate_j) * r, keeping incumbent j running saves
        it a rate_j * overhead_j / round_duration re-launch delay.
        """
        bonus = problem.switch_bonus()
        if not np.any(bonus > 0.0):
            return Y
        J, R = Y.shape
        counts = Y.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = np.where(
                counts > 0, problem.priorities / np.maximum(counts, 1), 0.0
            )
        free0 = float(problem.num_gpus) - float(
            np.sum(problem.nworkers * Y[:, 0])
        )
        # Largest overheads first: they have the strongest claim on the
        # scarce round-0 capacity.
        for j in np.argsort(-bonus):
            if bonus[j] <= 0.0 or Y[j, 0] == 1 or counts[j] == 0:
                continue
            r_star = int(np.argmax(Y[j] == 1))
            if problem.nworkers[j] <= free0:
                # Free capacity in round 0: moving j earlier also
                # improves the reordering objective. Always take it.
                Y[j, 0], Y[j, r_star] = 1, 0
                free0 -= problem.nworkers[j]
                continue
            # Swap with a round-0 occupant: never preempt another
            # incumbent-with-overhead to save this one, keep both rounds
            # within capacity, and require the relaunch delay avoided to
            # beat the fairness-ordering regression.
            delay_rounds = problem.switch_cost[j] / max(
                problem.round_duration, 1e-9
            )
            load_r = float(np.sum(problem.nworkers * Y[:, r_star]))
            best_k, best_delta = None, None
            for k in range(J):
                if k == j or Y[k, 0] == 0 or Y[k, r_star] == 1:
                    continue
                if bonus[k] > 0.0:
                    continue
                if problem.nworkers[j] - problem.nworkers[k] > free0:
                    continue
                if (
                    load_r - problem.nworkers[j] + problem.nworkers[k]
                    > problem.num_gpus
                ):
                    continue
                delta = (rate[k] - rate[j]) * r_star  # reorder regression
                if rate[j] * delay_rounds <= self.stickiness_hysteresis * delta:
                    continue
                if best_delta is None or delta < best_delta:
                    best_k, best_delta = k, delta
            if best_k is not None:
                Y[j, 0], Y[j, r_star] = 1, 0
                Y[best_k, 0], Y[best_k, r_star] = 0, 1
                free0 += problem.nworkers[best_k] - problem.nworkers[j]
        return Y

    def _backfill(self, Y: np.ndarray, problem: EGProblem) -> np.ndarray:
        """Fill any round left completely idle while unfinished jobs exist
        (the scheduler treats an empty round as end-of-trace)."""
        J, R = Y.shape
        order = np.argsort(-problem.priorities, kind="stable")
        for r in range(R):
            if Y[:, r].any():
                continue
            capacity = float(problem.num_gpus)
            for j in order:
                if problem.nworkers[j] <= capacity:
                    Y[j, r] = 1
                    capacity -= problem.nworkers[j]
                if capacity <= 0:
                    break
        return Y


class PoolSetPlanner:
    """Heterogeneous Shockwave: one independent EG plan per worker-type
    pool (reference shockwave.py:1245-1427).

    The reference's own Shockwave plans a single homogeneous pool and
    leaves every other worker type idle; with ``"hetero_pools": true`` a
    mixed cluster gets one child :class:`ShockwavePlanner` per worker
    type, on the planner's device, so a pool above the native greedy's
    work threshold solves there, and a ``pdhg`` pool launches kernel A.
    The scheduler assigns each job to a pool at admission (it owns the
    throughput oracle) with its profile durations rescaled to that
    pool's speed, and every pool plans and runs its own jobs each round.

    It takes the calls a single planner takes, routed through the
    job-to-pool map, plus ``current_round_schedule_by_pool`` for
    pool-aware dispatch and ``pool_of`` for per-pool progress.
    """

    def __init__(self, config: dict, backend: str, pools: Dict[str, int],
                 device="cuda"):
        self.config = dict(config)
        self.backend = backend
        self.device = torch.device(device)
        self.pools = dict(pools)
        self.children: "OrderedDict[str, ShockwavePlanner]" = OrderedDict(
            (wt, ShockwavePlanner({**config, "num_gpus": n}, backend=backend,
                                  device=self.device))
            for wt, n in sorted(pools.items())
        )
        for wt, child in self.children.items():
            child.pool_label = wt
        self.job_pool: Dict[object, str] = {}
        # Cumulative admissions per pool (the live load used for
        # balancing is pool_incomplete_jobs).
        self.assignments: Dict[str, int] = {wt: 0 for wt in self.children}

    # -- scheduler-facing interface (a single planner's vocabulary) ------
    def add_job(
        self, job_id, profile: dict, round_len: float, scale_factor: int,
        submit_time: Optional[float] = None, pool: Optional[str] = None,
        duration_scale: float = 1.0, overhead_s: float = 0.0,
    ) -> None:
        pool = pool if pool in self.children else next(iter(self.children))
        if duration_scale != 1.0:
            profile = dict(profile)
            profile["duration_every_epoch"] = [
                d * duration_scale for d in profile["duration_every_epoch"]
            ]
        self.job_pool[job_id] = pool
        self.assignments[pool] = self.assignments.get(pool, 0) + 1
        self.children[pool].add_job(
            job_id, profile, round_len, scale_factor, submit_time,
            overhead_s=overhead_s,
        )

    def pool_incomplete_jobs(self, pool: str) -> int:
        """Live count of the pool's incomplete jobs (the fair-share
        population the scheduler's assignment estimate divides by)."""
        child = self.children.get(pool)
        if child is None:
            return 0
        return sum(
            1
            for md in child.job_metadata.values()
            if md.completed_epochs < md.total_epochs
        )

    def _child_of(self, job_id) -> Optional[ShockwavePlanner]:
        pool = self.job_pool.get(job_id)
        return self.children.get(pool) if pool is not None else None

    def pool_of(self, job_id) -> Optional[str]:
        return self.job_pool.get(job_id)

    def remove_job(self, job_id) -> None:
        child = self._child_of(job_id)
        if child is not None:
            child.remove_job(job_id)
        self.job_pool.pop(job_id, None)

    def record_round_throughput(self, job_id, round_id, throughput, bs) -> None:
        child = self._child_of(job_id)
        if child is not None:
            child.record_round_throughput(job_id, round_id, throughput, bs)

    def mark_complete(self, job_id) -> None:
        child = self._child_of(job_id)
        if child is not None:
            child.mark_complete(job_id)

    def set_progress(self, job_id, num_epochs: int) -> None:
        child = self._child_of(job_id)
        if child is not None:
            child.set_progress(job_id, num_epochs)

    def get_metadata(self, job_id):
        child = self._child_of(job_id)
        return child.get_metadata(job_id) if child is not None else None

    def increment_round(self) -> None:
        for child in self.children.values():
            child.increment_round()

    def set_pool_capacity(self, worker_type: str, num_gpus: int) -> None:
        """Capacity change inside one pool (worker death or churn; the JAX
        package's shockwave.py:1346)."""
        child = self.children.get(worker_type)
        if child is None:
            return
        self.pools[worker_type] = max(1, int(num_gpus))
        child.set_capacity(num_gpus)

    def set_recompute_flag(self, jobs=None) -> None:
        """With ``jobs`` given, only the pools owning them go stale; a bare
        call, or a job no pool owns, stales every pool."""
        if jobs is not None:
            owners = [
                child
                for child in self.children.values()
                if any(j in child.job_metadata for j in jobs)
            ]
            if all(
                any(j in c.job_metadata for c in self.children.values())
                for j in jobs
            ):
                for child in owners:
                    child.set_recompute_flag(jobs)
                return
        for child in self.children.values():
            child.set_recompute_flag()

    @property
    def num_jobs(self) -> int:
        return sum(c.num_jobs for c in self.children.values())

    @property
    def solve_records(self) -> List[dict]:
        return [
            {**r, "pool": wt}
            for wt, c in self.children.items()
            for r in c.solve_records
        ]

    def current_round_schedule_by_pool(self) -> "OrderedDict[str, list]":
        return OrderedDict(
            (wt, child.current_round_schedule())
            for wt, child in self.children.items()
        )

    def current_round_schedule(self) -> list:
        return [
            j
            for schedule in self.current_round_schedule_by_pool().values()
            for j in schedule
        ]

    # -- serialization --------------------------------------------------
    def state_dict(self) -> dict:
        """The JAX package's ``pool_set`` state, key for key."""
        return {
            "kind": "pool_set",
            "config": dict(self.config),
            "backend": self.backend,
            "pools": dict(self.pools),
            "children": OrderedDict(
                (wt, c.state_dict()) for wt, c in self.children.items()
            ),
            "job_pool": dict(self.job_pool),
            "assignments": dict(self.assignments),
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "PoolSetPlanner":
        """Restore a ``pool_set`` state either package wrote; every pool's
        device solves run on ``device``."""
        planner = cls(state["config"], state["backend"], state["pools"],
                      device=device)
        planner.children = OrderedDict(
            (wt, ShockwavePlanner.from_state(cs, device=device))
            for wt, cs in state["children"].items()
        )
        for wt, child in planner.children.items():
            child.pool_label = wt
        planner.job_pool = dict(state["job_pool"])
        planner.assignments = dict(state.get("assignments", {}))
        return planner


def planner_from_state(state: dict, device="cuda"):
    """Restore whichever planner kind a state dict carries (reference
    shockwave.py:1429): a ``pool_set``, a ``cell_set`` federation or a
    flat planner, its device solves on ``device``."""
    if state.get("kind") == "pool_set":
        return PoolSetPlanner.from_state(state, device=device)
    if state.get("kind") == "cell_set":
        from shockwave_tpu_torch.cells.planner import CellPlanner

        return CellPlanner.from_state(state, device=device)
    return ShockwavePlanner.from_state(state, device=device)


class ShockwavePolicy(Policy):
    """Marker policy selecting the Shockwave mechanism path in the
    scheduler; carries the planner factory and the level solve's
    device."""

    def __init__(self, backend: str = "tpu", device="cuda"):
        self.backend = backend
        self.device = torch.device(device)
        self.name = {
            "reference": "Shockwave",
            "native": "Shockwave_Native",
            "level": "Shockwave_TPU_Level",
            "sharded": "Shockwave_TPU_Sharded",
            "relaxed": "Shockwave_TPU_Relaxed",
            "pdhg": "Shockwave_TPU_PDHG",
            "cells": "Shockwave_TPU_Cells",
        }.get(backend, "Shockwave_TPU")

    def make_planner(self, config: dict):
        """The ``cells`` backend, or any backend with ``cells`` >= 2 in
        the config, plans through the cell-decomposed market; otherwise
        one global planner (reference shockwave.py:1451-1460)."""
        if self.backend == "cells" or int(config.get("cells", 0) or 0) >= 2:
            from shockwave_tpu_torch.cells.planner import CellPlanner

            return CellPlanner(config, backend=self.backend,
                               device=self.device)
        return ShockwavePlanner(config, backend=self.backend,
                                device=self.device)
