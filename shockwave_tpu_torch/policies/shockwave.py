"""The Shockwave policy: per-round Volatile Fisher Market planning.

The port of the JAX package's ``shockwave_tpu/policies/shockwave.py``
for the backends of the simulation main path:
  * ``tpu`` — the production dispatch: the C++ host greedy below a work
    of 4e6 (num_gpus x future_rounds x jobs), else the level-set solve
    on the planner's device;
  * ``level`` — the level-set solve forced
    (:func:`shockwave_tpu_torch.solver.eg_level.solve_eg_level`);
  * ``native`` — the C++ greedy forced.
The other backends (``reference``, ``relaxed``, ``sharded``, ``pdhg``,
``cells``), the degradation ladder, ``PoolSetPlanner`` and
``planner_from_state`` raise ``NotImplementedError`` naming
``ROADMAP.md``. The device of the level solve is passed explicitly
(``ShockwavePolicy(backend, device=...)``).
"""

from __future__ import annotations

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

# Fleet scale at which the reference's "tpu" dispatch shards one solve
# over every visible device (shockwave_tpu/policies/shockwave.py:49). The
# sharded solve is not ported, so with more than one card visible the
# dispatch raises at this scale rather than quietly solving on one.
# (The reference's SHOCKWAVE_SHARDED_MIN_JOBS override is not ported.)
SHARDED_DISPATCH_MIN_JOBS = 8192

# Work (num_gpus x future_rounds x jobs) below which the "tpu" dispatch
# takes the C++ host greedy: the reference's default
# (shockwave_tpu/policies/shockwave.py:831), kept as it is. The H100's
# measured crossover between the two is in PERF.md.
NATIVE_MAX_WORK = 4e6

BACKENDS = ("tpu", "level", "native")
_NOT_PORTED = "is not ported to shockwave_tpu_torch yet (ROADMAP.md, queue 1)"


class ShockwavePlanner(SpeculativePlannerMixin):
    """Plans a boolean (job x future-round) schedule each planning window.

    State: per-job predictor metadata, finish-time-estimate history, the
    schedule cache keyed by absolute round index, and the recompute flag
    (set on batch-size changes; reference: scheduler/scheduler.py:3590-3591).
    """

    def __init__(self, config: dict, backend: str = "tpu", device="cuda"):
        if backend not in BACKENDS:
            raise NotImplementedError(f"the {backend!r} backend {_NOT_PORTED}")
        if config.get("plan_deadline_s") is not None:
            raise NotImplementedError(f"the degradation ladder {_NOT_PORTED}")
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
        # Preemption-aware planning: scale on the per-job measured
        # relaunch overheads the scheduler threads through add_job. 0
        # disables the switching-cost term even when overheads are known.
        self.switch_cost_weight = float(config.get("switch_cost_weight", 1.0))
        # Migration hysteresis of the stickiness pass (1.0: break-even).
        self.stickiness_hysteresis = float(
            config.get("stickiness_hysteresis", 1.0)
        )
        self._init_speculation(config)

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

    def current_round_schedule(self) -> list:
        """This round's job list, from the plan cache or a fresh solve
        (reference: shockwave.py:77-91). A cached round whose scheduled
        jobs have all since completed triggers a replan while incomplete
        jobs remain (the reference returns the stale empty round, which
        the scheduler reads as end-of-trace)."""
        start = time.perf_counter()
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
        """Returns (schedule, backend_used): the reference's straight
        dispatch when there is no plan deadline and no fault injector
        (shockwave.py:529-543), the only case ported."""
        self._attempted_backend = self.backend
        return self._solve_backend(self.backend, problem)

    def _solve_backend(
        self, backend: str, problem: EGProblem
    ) -> "Tuple[np.ndarray, str]":
        """One backend's solve, then the per-round reorder.
        ``_attempted_backend`` tracks the in-flight choice so a raising
        solver is attributed to the backend that actually raised."""
        from shockwave_tpu_torch import native
        from shockwave_tpu_torch.solver.eg_level import solve_eg_level
        from shockwave_tpu_torch.solver.rounding import reorder_rounds

        self._attempted_backend = backend
        used = backend
        if backend == "native":
            Y = native.solve_eg_greedy_native(problem)
        elif backend == "level":
            Y = solve_eg_level(problem, self.device)
        else:
            # "tpu", the production path: latency-aware dispatch. Small
            # solves go to the C++ host core, where the device's fixed
            # launch and fetch latency would dominate; above the work
            # threshold the level-set solve runs on the device. Both
            # optimize the same objective.
            Y = None
            if (
                problem.num_jobs >= SHARDED_DISPATCH_MIN_JOBS
                and self.device.type == "cuda"
                and torch.cuda.device_count() > 1
            ):
                raise NotImplementedError(
                    f"the sharded multi-card solve {_NOT_PORTED}; at "
                    f"{problem.num_jobs} jobs with "
                    f"{torch.cuda.device_count()} cards the reference "
                    "would shard")
            work = (
                float(problem.num_gpus)
                * problem.future_rounds
                * problem.num_jobs
            )
            if work < NATIVE_MAX_WORK and native.available():
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
        self.solve_records.append(record)
        obs.histogram(
            "shockwave_solve_seconds",
            "plan-solve wall time per backend (ok=False: failed solves)",
        ).observe(seconds, backend=backend, ok=str(ok))

    def _replan(self) -> None:
        # Past rounds are never read again; keep the cache bounded.
        for r in [r for r in self.schedules if r < self.round_index]:
            del self.schedules[r]
        problem, job_ids = self._build_problem()
        if problem is None:
            for i in range(self.future_rounds):
                self.schedules[self.round_index + i] = []
            return
        start = time.time()
        try:
            Y, backend_used = self._solve(problem)
        except Exception as e:
            self._record_solve(
                time.time() - start, self._attempted_backend,
                problem.num_jobs, ok=False, error=type(e).__name__,
            )
            raise
        self._record_solve(
            time.time() - start, backend_used, problem.num_jobs, ok=True
        )
        Y = self._apply_stickiness(Y, problem)
        Y = self._backfill(Y, problem)
        for r in range(self.future_rounds):
            self.schedules[self.round_index + r] = [
                job_ids[j] for j in range(len(job_ids)) if Y[j, r]
            ]

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
    """Heterogeneous Shockwave (one EG plan per worker-type pool)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"PoolSetPlanner (hetero_pools) {_NOT_PORTED}")


def planner_from_state(state: dict):
    raise NotImplementedError(
        f"planner checkpoints (planner_from_state) {_NOT_PORTED}")


class ShockwavePolicy(Policy):
    """Marker policy selecting the Shockwave mechanism path in the
    scheduler; carries the planner factory and the level solve's
    device."""

    def __init__(self, backend: str = "tpu", device="cuda"):
        self.backend = backend
        self.device = torch.device(device)
        self.name = {
            "native": "Shockwave_Native",
            "level": "Shockwave_TPU_Level",
        }.get(backend, "Shockwave_TPU")

    def make_planner(self, config: dict) -> ShockwavePlanner:
        if int(config.get("cells", 0) or 0) >= 2:
            raise NotImplementedError(f"the cells market {_NOT_PORTED}")
        return ShockwavePlanner(config, backend=self.backend,
                                device=self.device)
