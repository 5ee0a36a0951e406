"""The round-based scheduler's trace-driven simulation.

The port of the simulation path of the JAX package's
``shockwave_tpu/core/scheduler.py``: ``Scheduler.simulate`` (:2046) over
a static trace, strided worker assignment, micro-task completion
merging, batch-size adaptation and the metrics getters. Time is divided
into fixed rounds (``time_per_iteration`` seconds), and every round a
policy picks which jobs occupy which workers, by one of two paths:

* the Shockwave planner's hooks (``_shockwave_schedule_helper`` :1356,
  ``_shockwave_scheduler_update`` :2011) under a Shockwave policy;
* Gavel's round path under every other policy: the policy's allocation
  (``_compute_allocation`` :1028, recomputed when jobs or workers come
  and go, at most once per ``minimum_time_between_allocation_resets``),
  per-type priorities from the allocation over the time each job
  received (``_update_priorities`` :1113) and a greedy pass in priority
  order (``_schedule_jobs_on_workers_helper`` :1157).

Under a packed policy (``Packing`` in its name) the schedulable units are
single jobs and pairs of jobs of the same scale factor that space-share
a worker (``JobId(a, b)``): every admitted job registers its pairs with
the jobs already there, their co-located throughputs from the oracle
(``_populate_job_combination_metadata`` :859), and a pair is allocated,
prioritised, placed and run like a job, each member at its co-located
rate. Under an SLO policy (``SLO`` in its name) each job with an SLO gets
the deadline SLO x its isolated duration from its submission, and the
policy sees the time left to it.

Under a Shockwave policy with ``"hetero_pools": true`` a mixed cluster
plans one pool a worker type (``PoolSetPlanner``): each job joins the
pool with the earliest fair-share completion estimate for its gang, its
profile rescaled to that pool's speed, and its finish-time fairness is
judged against that pool's isolated duration. With ``"speculate":
true`` the scheduler predicts each round's outcome as it dispatches the
round, and the planner solves the next round from it ahead of the
boundary (``policies/speculation.py``). ``simulate(checkpoint_threshold=,
checkpoint_file=)`` saves the scheduler's and the planner's state once
that many jobs were admitted and resumes from an existing file
(:meth:`Scheduler.save_checkpoint`).

An armed fault plan (``runtime/faults.py``) lands at round boundaries
before the completion drain (``_apply_cluster_fault_events``): a crashed
or reclaimed worker takes its running micro-tasks down with zero
progress (not charged as a failed attempt), the workers leave the
cluster and the planner replans for the capacity left
(``_sync_planner_capacity``); ``worker_add`` restores capacity up to the
plan's ``max_capacity``; ``scheduler_crash`` / ``scheduler_restart`` push
the whole control plane and the loop's running and queued jobs through
the HA codec's JSON (``ha/codec.py``) and restore them in place, which
must leave the run bit-identical (:meth:`Scheduler.ha_state_dict`).
Under a packed policy with ``profiling_percentage < 1`` or
``num_reference_models`` set, the allocator sees estimated pair
throughputs (``core/throughput_estimator.py``: the new job's profiled
colocations completed by masked ALS on the scheduler's device, then
matched to the nearest reference type), while execution runs at the
oracle's. ``per_worker_type_prices`` charges each micro-task's time at
the worker type's price (``get_total_cost``), and every admission,
round and completion goes to the round log (``save_round_log``).

With ``simulate=False`` the scheduler is the base of physical mode
(``core/physical.py``): measured throughputs fold in as an EMA, dispatch
marks jobs running, and a micro-task fails when any worker reports no
progress. ``simulate(submitter=...)`` admits the trace through the
streaming admission queue (``runtime/admission.py``) in virtual time.
"""

from __future__ import annotations

import copy
import heapq
import json
import math
import os
import pickle
import random
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.data.workload_info import (
    MAX_BATCH_SIZES,
    MIN_BATCH_SIZES,
    num_epochs as epochs_for_steps,
    steps_per_epoch,
    total_steps_for_epochs,
)
from shockwave_tpu_torch.utils.logging import make_logger

DEFAULT_THROUGHPUT = 1
MAX_FAILED_ATTEMPTS = 5
# The least time between two recomputations of a Gavel policy's
# allocation: the reference's default ``minimum_time_between_allocation_resets``
# (scheduler.py:161), which only its physical mode changes.
MIN_RESET_INTERVAL_S = 1920.0
# Physical mode: the throughput of a job not yet measured, and the weight
# of a new measurement in the EMA (the JAX package's scheduler.py:45-47).
INFINITY = int(1e9)
EMA_ALPHA = 0.5

# Batch-size scaling directions.
BS_BIG = 0
BS_SMALL = 1


def resolve_preemption_overhead(overheads, job_type: str) -> float:
    """Per-job relaunch overhead (seconds) from an overhead table: a
    scalar, or a dict keyed by family name (the part of ``job_type``
    before " (batch size N)") with an optional "default" entry. Absent
    families cost 0."""
    if overheads is None:
        return 0.0
    if isinstance(overheads, (int, float)):
        return float(overheads)
    family = job_type.split(" (")[0]
    return float(overheads.get(family, overheads.get("default", 0.0)))


def autosize_round_duration(
    overheads,
    base_round_s: float,
    max_overhead_fraction: float = 0.25,
    max_round_s: Optional[float] = None,
) -> float:
    """Overhead-aware round length: long enough that the worst per-family
    relaunch overhead costs at most ``max_overhead_fraction`` of one
    round; never shorter than ``base_round_s``, at most ``max_round_s``."""
    if not 0.0 < max_overhead_fraction <= 1.0:
        raise ValueError(
            f"max_overhead_fraction must be in (0, 1], got "
            f"{max_overhead_fraction}"
        )
    if overheads is None:
        worst = 0.0
    elif isinstance(overheads, (int, float)):
        worst = float(overheads)
    elif isinstance(overheads, dict):
        worst = max(
            (float(v) for k, v in overheads.items() if k != "default"),
            default=0.0,
        )
        worst = max(worst, float(overheads.get("default", 0.0)))
    else:
        raise TypeError(
            "preemption overheads must be None, a scalar, or a "
            f"{{family: seconds}} dict, got {type(overheads).__name__}"
        )
    sized = max(float(base_round_s), worst / max_overhead_fraction)
    if max_round_s is not None:
        sized = min(sized, float(max_round_s))
    return max(sized, float(base_round_s))


class Scheduler:
    def __init__(
        self,
        policy,
        simulate: bool = True,
        throughputs: Optional[dict] = None,
        seed: int = 0,
        time_per_iteration: float = 360.0,
        profiles: Optional[dict] = None,
        shockwave_config: Optional[dict] = None,
        log_level=None,
        profiling_percentage: float = 1.0,
        num_reference_models: Optional[int] = None,
        preemption_overheads=None,
        round_overhead_fraction: Optional[float] = None,
        per_worker_type_prices: Optional[dict] = None,
        device=None,
        minimum_time_between_allocation_resets: float = MIN_RESET_INTERVAL_S,
    ):
        self._is_shockwave = policy.name.startswith("Shockwave")
        self._simulate = simulate
        self._min_reset_interval = float(
            minimum_time_between_allocation_resets
        )
        if self._is_shockwave and shockwave_config is None:
            raise ValueError("Shockwave policies require shockwave_config")
        self._policy = policy
        self._oracle_throughputs = throughputs
        self._time_per_iteration = float(time_per_iteration)
        # Preemption awareness: per-family relaunch overheads (seconds;
        # scalar or {family: seconds}) feed the planner's switching-cost
        # term, and with round_overhead_fraction auto-size the round.
        if preemption_overheads is None and shockwave_config is not None:
            preemption_overheads = shockwave_config.get("preemption_overheads")
        self._preemption_overheads = preemption_overheads
        if round_overhead_fraction is not None:
            sized = autosize_round_duration(
                preemption_overheads,
                self._time_per_iteration,
                max_overhead_fraction=round_overhead_fraction,
            )
            if sized != self._time_per_iteration:
                self._time_per_iteration = sized
                if shockwave_config is not None:
                    shockwave_config = dict(shockwave_config)
                    shockwave_config["time_per_iteration"] = sized
        self._profiles = profiles or {}
        # The profiles the scheduler was built with are configuration, as
        # its policy is; the HA state carries only those synthesized at
        # admission.
        self._configured_profiles = frozenset(self._profiles)
        # $/accelerator-hour per worker type: a constant or a
        # [[time_s, price], ...] schedule (data/spot_prices.py); None
        # disables cost accounting.
        self._per_worker_type_prices = per_worker_type_prices

        self._current_timestamp: float = 0.0
        self._num_completed_rounds = 0
        # The reference's RNG fan-out (reference: scheduler.py:378-392):
        # the worker-type shuffle draws from the seed + 5 stream.
        self._worker_type_shuffler = random.Random(seed + 5)

        # Job state.
        self._job_id_counter = 0
        self._jobs: "OrderedDict[JobId, Job]" = OrderedDict()
        self._completed_jobs: set = set()
        self._running_jobs: set = set()
        self._steps_run_so_far: Dict[JobId, Dict[str, int]] = {}
        self._total_steps_run: Dict[JobId, int] = {}
        self._job_time_so_far: Dict[JobId, Dict[str, float]] = {}
        self._job_cost_so_far: Dict[JobId, float] = {}
        # Processing seconds each job has received: what the calibration
        # tracker scores the predictor's remaining-runtime forecasts
        # against. Scheduling decisions never read it.
        self._job_total_run_time: Dict[JobId, float] = {}
        self._throughputs: Dict[JobId, dict] = {}
        self._original_bs: Dict[JobId, int] = {}
        self._bs_scale: Dict[JobId, Optional[int]] = {}
        self._num_failures_per_job: Dict[JobId, int] = {}
        self._per_job_start_timestamps: Dict[JobId, float] = {}
        self._per_job_latest_timestamps: Dict[JobId, Optional[float]] = {}
        # Under hetero_pools a job admitted to a pool has its profile
        # rescaled by base/pool throughput, and its finish-time fairness
        # is judged against the same pool-speed baseline (absent: 1.0).
        self._pool_ftf_scale: Dict[int, float] = {}
        self._job_completion_times: "OrderedDict[JobId, Optional[float]]" = OrderedDict()
        self._num_jobs_in_trace = 0
        self._in_progress_updates: Dict[JobId, list] = {}
        # Micro-tasks with a completion synthesized for a dead worker in
        # their in-flight merge (_done_callback's fault flag).
        self._fault_tainted: set = set()
        # Per-job, per-rank iterator log lines (physical mode fills them;
        # a simulation keeps them empty).
        self._job_timelines: Dict[JobId, list] = {}
        # Per-job causal root contexts (obs/propagate.py), kept only while
        # tracing is on and the chain is sampled.
        self._job_trace_ctx: Dict[JobId, object] = {}
        # Tenant-spend gauges: the planner replan last published and the
        # tenant labels last set (a tenant whose jobs all left is zeroed).
        self._tenant_spend_round: Optional[int] = None
        self._tenant_spend_seen: set = set()
        # The structured event log (job admissions, rounds, completions)
        # that scripts/analysis/postprocess_log.py reads.
        self._round_log: list = []
        # Absolute deadlines, kept only under SLO policies and kept after
        # completion for get_num_SLO_violations.
        self._slos: Optional[Dict[JobId, float]] = (
            {} if "SLO" in policy.name else None
        )
        # Packed policies schedule pairs of jobs beside single jobs.
        self._job_packing = "Packing" in policy.name

        # Worker state.
        self._worker_id_counter = 0
        self._worker_ids: List[int] = []
        self._worker_types: List[str] = []
        self._cluster_spec: Dict[str, int] = {}
        self._worker_id_to_worker_type: Dict[int, str] = {}
        # worker_type -> list of per-server worker-id lists.
        self._worker_type_to_worker_ids: Dict[str, List[List[int]]] = {}
        self._worker_start_times: Dict[int, float] = {}
        self._cumulative_worker_time_so_far: Dict[int, float] = {}
        self._worker_time_so_far: Dict[str, float] = {}

        # Allocation state of the Gavel round path.
        self._allocation: Dict[JobId, Dict[str, float]] = {}
        self._priorities: Dict[str, Dict[JobId, float]] = {}
        self._deficits: Dict[str, Dict[JobId, float]] = {}
        self._need_to_update_allocation = True
        self._last_reset_time: float = 0.0
        # The policy's allocation calls and their wall seconds.
        self.num_allocations = 0
        self.allocation_s = 0.0
        self._current_worker_assignments: "OrderedDict[JobId, tuple]" = OrderedDict()
        self._current_round_scheduled_jobs: List[JobId] = []
        # Preemptions: a still-active job that held workers last round
        # and this round is either unscheduled or moved to a different
        # worker set.
        self._num_preemptions = 0
        self._num_lease_extensions = 0
        self._num_lease_extension_opportunities = 0

        self._logger = make_logger(
            "scheduler", lambda: self._current_timestamp, level=log_level
        )
        # Telemetry: with tracing on, trace timestamps follow this
        # scheduler's virtual clock (the JAX package's
        # scheduler.py:288-301). A weak reference: the tracer is
        # process-global and must not keep a finished scheduler alive.
        if obs.trace_enabled():
            import weakref

            self_ref = weakref.ref(self)

            def _trace_clock():
                sched = self_ref()
                return (sched.get_current_timestamp() if sched is not None
                        else 0.0)

            obs.set_trace_clock(_trace_clock)
        # Plan-ahead pipelining: the scheduler owns the execution model,
        # so it supplies the predicted round outcome; the planner
        # snapshots, solves and reconciles (policies/speculation.py).
        self._speculate = bool((shockwave_config or {}).get("speculate"))
        self._shockwave = (
            policy.make_planner(shockwave_config) if self._is_shockwave
            else None)

        # Online throughput estimation (the JAX package's
        # scheduler.py:329-357): under a packed policy with partial
        # colocation profiling or a subset of reference models, the
        # allocator sees estimated pair throughputs while execution runs
        # at the oracle's. The completion runs on ``device`` (default:
        # the policy's, else cuda).
        self._estimate_throughputs = self._job_packing and (
            profiling_percentage < 1.0 or num_reference_models is not None
        )
        if self._estimate_throughputs:
            from shockwave_tpu_torch.core.throughput_estimator import (
                ThroughputEstimator,
            )
            from shockwave_tpu_torch.data.job_table import build_job_table

            if throughputs is None:
                raise ValueError(
                    "throughput estimation requires an oracle to profile "
                    "against"
                )
            job_types = [(t.model, 1) for t in build_job_table()]
            if num_reference_models is None:
                num_reference_models = len(job_types)
            if device is None:
                device = getattr(policy, "device", "cuda")
            self._throughput_estimator = ThroughputEstimator(
                throughputs,
                sorted(throughputs.keys()),
                job_types,
                num_reference_models,
                profiling_percentage,
                seed=seed + 4,
                device=device,
            )
            self._reference_throughputs = (
                self._throughput_estimator.get_reference_throughputs()
            )
            self._reference_job_map: Dict[JobId, Tuple[str, int]] = {}

    # ------------------------------------------------------------------
    # Workers and jobs.
    # ------------------------------------------------------------------
    def register_worker(self, worker_type: str, num_gpus: int = 1) -> List[int]:
        """Register one server with ``num_gpus`` workers of ``worker_type``
        (reference: scheduler.py:2854-2940)."""
        if worker_type not in self._worker_type_to_worker_ids:
            if self._shockwave_is_pool_set():
                # The pool set took the cluster at first admission; chips
                # of a type registered later are never planned.
                self._logger.warning(
                    "worker type %r registered after the Shockwave pool "
                    "set was fixed; its chips will not be planned",
                    worker_type,
                )
            self._worker_types = sorted([*self._worker_types, worker_type])
            self._cluster_spec[worker_type] = 0
            self._worker_type_to_worker_ids[worker_type] = []
            self._worker_time_so_far[worker_type] = 0.0
            self._priorities[worker_type] = {}
            self._deficits[worker_type] = {}
            for job_id in self._jobs:
                self._steps_run_so_far[job_id][worker_type] = 0
                self._set_initial_throughput(job_id, worker_type)
                self._job_time_so_far[job_id][worker_type] = (
                    self._time_per_iteration / 2.0
                )
        server_ids = []
        for _ in range(num_gpus):
            worker_id = self._worker_id_counter
            self._worker_id_counter += 1
            server_ids.append(worker_id)
            self._worker_ids.append(worker_id)
            self._worker_id_to_worker_type[worker_id] = worker_type
            self._cluster_spec[worker_type] += 1
            self._worker_start_times[worker_id] = self._current_timestamp
            self._cumulative_worker_time_so_far[worker_id] = 0.0
        self._worker_type_to_worker_ids[worker_type].append(server_ids)
        self._need_to_update_allocation = True
        return server_ids

    def remove_worker(self, worker_id: int) -> None:
        """Unregister a dead or reclaimed worker (the JAX package's
        scheduler.py:415). Jobs holding it lose their assignment and are
        placed again at the next round; the per-worker accounting keeps
        its entries, so utilization and cost over the worker's life stay
        whole."""
        worker_type = self._worker_id_to_worker_type.pop(worker_id, None)
        if worker_type is None:
            return
        self._worker_ids.remove(worker_id)
        self._cluster_spec[worker_type] -= 1
        servers = self._worker_type_to_worker_ids[worker_type]
        for server in servers:
            if worker_id in server:
                server.remove(worker_id)
        self._worker_type_to_worker_ids[worker_type] = [
            s for s in servers if s
        ]
        for key in [
            k
            for k, ids in self._current_worker_assignments.items()
            if worker_id in ids
        ]:
            del self._current_worker_assignments[key]
        self._need_to_update_allocation = True
        self._sync_planner_capacity()

    def _sync_planner_capacity(self) -> None:
        """Carry a capacity change (death, reclaim, re-add) into the
        Shockwave planner, so the next replan solves for the fleet that
        exists (the JAX package's scheduler.py:444). Not called at the
        initial registration, which keeps the configured ``num_gpus``."""
        if self._shockwave is None:
            return
        if self._shockwave_is_pool_set():
            for wt in list(self._shockwave.children):
                count = self._cluster_spec.get(wt, 0)
                if count > 0 and count != self._shockwave.pools.get(wt):
                    self._shockwave.set_pool_capacity(wt, count)
            return
        try:
            pool_type = self._shockwave_pool_type()
        except ValueError:
            return
        count = self._cluster_spec.get(pool_type, 0)
        if count > 0:
            self._shockwave.set_capacity(count)

    # ------------------------------------------------------------------
    # Fault application (the JAX package's scheduler.py:471-593).
    # ------------------------------------------------------------------
    def _apply_cluster_fault_events(
        self, injector, running_jobs, queued_jobs=None
    ) -> None:
        """Apply every cluster event of the armed plan due by now. A crash
        or reclaim force-completes the victims' running micro-tasks with
        zero steps (``fault=True``: no failed attempt is charged), removes
        the workers and flags a replan; ``worker_add`` registers one-GPU
        servers, clamped to the plan's ``max_capacity``; a scheduler kill
        round-trips the control plane through the HA codec's JSON. Each
        applied event is marked recovered with how it was answered."""
        from shockwave_tpu_torch.runtime import faults as faults_mod

        recorder = obs.get_recorder()
        for event in injector.due_cluster_events(self._current_timestamp):
            now = self._current_timestamp
            obs.counter(
                "fault_injected_total",
                "fault events delivered by the injector",
            ).inc(kind=event.kind)
            if event.kind in faults_mod.SCHEDULER_KINDS:
                detail = self._sim_scheduler_restart_roundtrip(
                    running_jobs, queued_jobs
                )
                how = (
                    "journal_state_restored"
                    if detail.get("roundtrip_exact")
                    else "journal_state_restored_INEXACT"
                )
            elif event.kind == "worker_add":
                capacity = sum(self._cluster_spec.values())
                count = event.count
                if injector.plan.max_capacity is not None:
                    count = min(
                        count, max(injector.plan.max_capacity - capacity, 0)
                    )
                worker_type = event.worker_type or self._worker_types[0]
                added = []
                for _ in range(count):
                    added.extend(
                        self.register_worker(worker_type, num_gpus=1)
                    )
                self._sync_planner_capacity()
                if added:
                    obs.counter(
                        "scheduler_capacity_adds_total",
                        "workers restored by churn/spot re-add events",
                    ).inc(len(added))
                detail = {"added_workers": added}
                how = "capacity_restored"
            else:  # worker_crash / capacity_reclaim
                victims = faults_mod.select_victims(
                    injector.plan, event, self._worker_id_to_worker_type
                )
                requeued = self._crash_workers(victims, running_jobs, now)
                if victims:
                    obs.counter(
                        "scheduler_worker_deaths_total",
                        "workers lost to crash or capacity reclamation",
                    ).inc(len(victims), kind=event.kind)
                detail = {
                    "workers": victims,
                    "requeued": [str(k) for k in requeued],
                }
                how = "requeued_and_replanned"
            obs.instant(
                "fault", cat="fault", tid="faults",
                args={"fault_id": event.event_id, "kind": event.kind,
                      **{k: str(v) for k, v in detail.items()}},
            )
            record = {
                "fault_id": event.event_id,
                "kind": event.kind,
                "round": self._num_completed_rounds,
                "time": now,
                **detail,
            }
            if recorder.enabled:
                recorder.record_fault(record)
                recorder.record_recovery({**record, "how": how})
            injector.mark_applied(event, **detail)
            injector.mark_recovered(event.event_id, how=how, **detail)

    def _crash_workers(self, victims, running_jobs, now) -> list:
        """Kill ``victims``: every running micro-task holding one of them
        completes with zero progress (the round's work is lost), then the
        workers are unregistered. Returns the requeued job keys."""
        victim_set = set(victims)
        requeued = []
        if not victim_set:
            return requeued
        survivors = []
        while running_jobs:
            entry = heapq.heappop(running_jobs)
            _, job_id, worker_ids, _, round_start = entry
            if victim_set & set(worker_ids):
                elapsed = max(now - round_start, 0.0)
                n = len(job_id.singletons())
                for wid in worker_ids:
                    self._done_callback(
                        job_id, wid, [0] * n, [elapsed] * n, fault=True
                    )
                requeued.append(job_id)
                self._num_preemptions += 1
                obs.counter(
                    "scheduler_preemptions_total",
                    "still-active jobs that lost their workers "
                    "at a round boundary",
                ).inc()
            else:
                survivors.append(entry)
        for entry in survivors:
            heapq.heappush(running_jobs, entry)
        for worker_id in victims:
            self.remove_worker(worker_id)
        return requeued

    def add_job(self, job: Job, timestamp: Optional[float] = None) -> JobId:
        """(reference: scheduler.py:537-619)"""
        job_id = JobId(self._job_id_counter)
        self._job_id_counter += 1
        job.job_id = job_id.integer
        self._jobs[job_id] = job
        self._steps_run_so_far[job_id] = {}
        self._job_time_so_far[job_id] = {}
        self._job_cost_so_far[job_id] = 0.0
        self._job_total_run_time[job_id] = 0.0
        self._job_timelines[job_id] = [[] for _ in range(job.scale_factor)]
        self._throughputs[job_id] = {}
        self._original_bs[job_id] = job.batch_size
        self._num_jobs_in_trace += 1
        if self._estimate_throughputs and job.scale_factor == 1:
            # Profile the unseen job against the reference types and match
            # it (the JAX package's scheduler.py:615-622).
            self._reference_job_map[job_id] = (
                self._throughput_estimator.match_job_to_reference_job(
                    job.job_type_key()
                )
            )
        self._num_failures_per_job[job_id] = 0
        self._total_steps_run[job_id] = 0
        if self._slos is not None and job.SLO is not None and job.duration:
            # Deadline = SLO factor x isolated duration, from submission.
            self._slos[job_id] = (
                job.SLO * job.duration + self.get_current_timestamp()
            )
        for worker_type in self._worker_types:
            self._steps_run_so_far[job_id][worker_type] = 0
            self._set_initial_throughput(job_id, worker_type)
            if self._job_packing:
                self._populate_job_combination_metadata(job_id, worker_type)
            self._job_time_so_far[job_id][worker_type] = (
                self._time_per_iteration / 2.0
            )
        self._per_job_latest_timestamps[job_id] = None
        self._add_to_priorities(job_id)
        self._need_to_update_allocation = True
        self._bs_scale[job_id] = None
        if self._is_shockwave:
            if (
                job_id.integer not in self._profiles
                and self._oracle_throughputs is not None
            ):
                # No pre-computed profile: derive one from the throughput
                # oracle, the math synthesize_profiles applies to a trace.
                from shockwave_tpu_torch.data.profiles import (
                    synthesize_profile,
                )

                worker_type = (
                    self._worker_types[0] if self._worker_types else "v100"
                )
                self._profiles[job_id.integer] = synthesize_profile(
                    job, self._oracle_throughputs, worker_type
                )
            self._maybe_upgrade_shockwave_to_pools()
            pool_kwargs = {}
            if self._shockwave_is_pool_set():
                pool, scale = self._pick_shockwave_pool(
                    job, self._profiles[job_id.integer]
                )
                pool_kwargs = dict(pool=pool, duration_scale=scale)
                self._pool_ftf_scale[job_id.integer] = scale
            self._shockwave.add_job(
                job_id,
                self._profiles[job_id.integer],
                self._time_per_iteration,
                job.scale_factor,
                submit_time=self.get_current_timestamp(),
                overhead_s=resolve_preemption_overhead(
                    self._preemption_overheads, job.job_type
                ),
                **pool_kwargs,
            )
        if timestamp is None:
            timestamp = self.get_current_timestamp()
        self._per_job_start_timestamps[job_id] = timestamp
        self._round_log.append(
            {
                "event": "job",
                "job_id": job_id.integer,
                "arrival": timestamp,
                "job_type": job.job_type,
                "command": job.command,
                "working_directory": job.working_directory,
                "num_steps_arg": job.num_steps_arg,
                "needs_data_dir": job.needs_data_dir,
                "total_steps": job.total_steps,
                "scale_factor": job.scale_factor,
                "mode": job.mode,
                "priority_weight": job.priority_weight,
                "SLO": job.SLO,
                "duration": job.duration,
            }
        )
        obs.counter(
            "scheduler_jobs_admitted_total", "jobs admitted from the trace"
        ).inc()
        obs.gauge(
            "scheduler_queue_depth", "active (incomplete) jobs"
        ).set(len(self._jobs))
        trace_args = {}
        if obs.trace_enabled():
            from shockwave_tpu_torch.obs import propagate

            # Adopt the submitter's root (front-door jobs carry it) or
            # mint a fresh one; an unsampled chain traces locally only.
            root = propagate.from_wire(getattr(job, "trace_context", ""))
            if root is None:
                root = propagate.new_root()
            if root is not None and root.sampled:
                self._job_trace_ctx[job_id] = root
                trace_args = {
                    "trace_id": root.trace_id,
                    "parent_span_id": root.span_id,
                }
                now = self.get_current_timestamp()
                if now > timestamp:
                    # The admission-queue wait, as its own span under the
                    # job's root (arrival stamp -> admission).
                    wait_ctx = root.child()
                    obs.complete(
                        "queue_wait", ts_s=timestamp, dur_s=now - timestamp,
                        cat="job", tid="jobs",
                        args={"job_id": job_id.integer, **wait_ctx.args()},
                    )
        # ts is the monotone scheduler clock, not the arrival stamp.
        obs.instant(
            "job_admitted", cat="job", tid="jobs",
            ts_s=self.get_current_timestamp(),
            args={"job_id": job_id.integer, "job_type": job.job_type,
                  "scale_factor": job.scale_factor, "arrival_s": timestamp,
                  **trace_args},
        )
        self._logger.info("[Job dispatched]\tJob ID: %s", job_id)
        return job_id

    def _remove_job(self, job_id: JobId) -> None:
        """(reference: scheduler.py:627-705)"""
        self._completed_jobs.add(job_id)
        duration = (
            self._per_job_latest_timestamps[job_id]
            - self._per_job_start_timestamps[job_id]
        )
        del self._jobs[job_id]
        if self._num_failures_per_job[job_id] >= MAX_FAILED_ATTEMPTS:
            self._job_completion_times[job_id] = None
        else:
            self._job_completion_times[job_id] = duration
        self._round_log.append(
            {
                "event": "complete",
                "job_id": job_id.integer,
                "time": self.get_current_timestamp(),
                "duration": self._job_completion_times[job_id],
            }
        )
        if obs.enabled():
            self._record_completion_telemetry(
                job_id, self._job_completion_times[job_id]
            )
        calibration = obs.get_calibration()
        if calibration.enabled:
            if self._job_completion_times[job_id] is not None:
                calibration.record_outcome(
                    job_id.integer,
                    self._job_total_run_time.get(job_id, 0.0),
                )
            else:
                # A job dropped after repeated failures never realized
                # its remaining runtime; its forecasts are unjudgeable.
                calibration.discard(job_id.integer)
        del self._steps_run_so_far[job_id]
        del self._job_time_so_far[job_id]
        del self._throughputs[job_id]
        del self._num_failures_per_job[job_id]
        self._in_progress_updates.pop(job_id, None)
        # Deadlines are kept after completion for get_num_SLO_violations.
        if self._job_packing:
            stale_pairs = [
                other
                for other in self._throughputs
                if other.is_pair and job_id.overlaps_with(other)
            ]
            for other in stale_pairs:
                del self._throughputs[other]
                self._job_time_so_far.pop(other, None)
                self._in_progress_updates.pop(other, None)
        self._remove_from_priorities(job_id)
        self._need_to_update_allocation = True
        self._job_trace_ctx.pop(job_id, None)
        self._logger.info("Remaining active jobs: %d", len(self._jobs))

    def _record_completion_telemetry(self, job_id: JobId, duration) -> None:
        """Per-job completion series (the JAX package's
        scheduler.py:809-845): JCT and finish-time fairness at completion
        (rho = JCT / (isolated duration x contention), over the
        population seen so far)."""
        now = self.get_current_timestamp()
        obs.counter(
            "scheduler_jobs_completed_total", "jobs run to completion"
        ).inc()
        obs.gauge(
            "scheduler_queue_depth", "active (incomplete) jobs"
        ).set(len(self._jobs))
        args = {"job_id": job_id.integer}
        root = self._job_trace_ctx.get(job_id)
        if root is not None:
            args["trace_id"] = root.trace_id
            args["parent_span_id"] = root.span_id
        if duration is not None:
            obs.histogram(
                "scheduler_job_jct_seconds", "per-job completion time"
            ).observe(duration)
            args["jct_s"] = round(duration, 3)
            ftf = self._finish_time_rho(job_id, duration)
            if ftf is not None:
                obs.histogram(
                    "scheduler_job_ftf",
                    "finish-time fairness rho at completion",
                ).observe(ftf)
                args["ftf"] = round(ftf, 3)
        else:
            obs.counter(
                "scheduler_jobs_failed_total",
                "jobs dropped after MAX_FAILED_ATTEMPTS",
            ).inc()
        obs.instant(
            "job_complete", cat="job", tid="jobs", ts_s=now, args=args
        )

    def _set_initial_throughput(self, job_id: JobId, worker_type: str) -> None:
        assert not job_id.is_pair
        if self._oracle_throughputs is not None:
            key = self._jobs[job_id].job_type_key()
            self._throughputs[job_id][worker_type] = self._oracle_throughputs[
                worker_type
            ][key]["null"]
        else:
            self._throughputs[job_id][worker_type] = DEFAULT_THROUGHPUT

    def _populate_job_combination_metadata(
        self, job_id: JobId, worker_type: str
    ) -> None:
        """Register the co-located throughputs of every same-scale pair of
        ``job_id`` with a job already admitted (the JAX package's
        scheduler.py:859): the oracle's, or under online estimation the
        matched reference types' co-located fractions scaled by the two
        jobs' own isolated throughputs."""
        job = self._jobs[job_id]
        job_type_key = job.job_type_key()
        for other_job_id in self._jobs:
            if other_job_id == job_id:
                continue
            other = self._jobs[other_job_id]
            if job.scale_factor != other.scale_factor:
                continue
            merged = JobId(job_id[0], other_job_id[0])
            if merged not in self._throughputs:
                self._throughputs[merged] = {}
                self._job_time_so_far[merged] = {}
            self._job_time_so_far[merged][worker_type] = 0.0
            if self._oracle_throughputs is None:
                self._throughputs[merged][worker_type] = [0.0, 0.0]
                continue
            oracle = self._oracle_throughputs[worker_type]
            other_key = other.job_type_key()
            if (
                self._estimate_throughputs
                and job_id in self._reference_job_map
                and other_job_id in self._reference_job_map
            ):
                refs = [
                    self._reference_job_map[job_id],
                    self._reference_job_map[other_job_id],
                ]
                isolated = [
                    oracle[job_type_key]["null"],
                    oracle[other_key]["null"],
                ]
                ref_oracle = self._reference_throughputs[worker_type]
                if job_id < other_job_id:
                    fractions = ref_oracle[refs[0]][refs[1]]
                else:
                    fractions = ref_oracle[refs[1]][refs[0]]
                    isolated = isolated[::-1]
                self._throughputs[merged][worker_type] = [
                    f * t for f, t in zip(fractions, isolated)
                ]
                continue
            keys = (
                (job_type_key, other_key)
                if job_id < other_job_id
                else (other_key, job_type_key)
            )
            pair_entry = oracle.get(keys[0], {}).get(keys[1])
            self._throughputs[merged][worker_type] = (
                list(pair_entry) if pair_entry is not None else [0.0, 0.0]
            )

    def _update_throughput(
        self, job_id, worker_type, all_num_steps, all_execution_times
    ) -> None:
        """The planner's measured-throughput record of the round and,
        under online estimation in simulation, a pair that ran takes the
        oracle's throughputs in place of its estimate; in physical mode the
        measured rate folds into the throughput as an EMA (the JAX
        package's scheduler.py:921-971)."""
        if job_id not in self._throughputs:
            return
        if self._shockwave is not None:
            current_round = self._num_completed_rounds
            for i, single in enumerate(job_id.singletons()):
                tput = (
                    0.0
                    if all_execution_times[i] <= 0
                    else all_num_steps[i] / all_execution_times[i]
                )
                if single in self._jobs:
                    self._shockwave.record_round_throughput(
                        single, current_round, tput,
                        self._jobs[single].batch_size
                    )
        if self._simulate and self._estimate_throughputs and job_id.is_pair:
            if all(s in self._jobs for s in job_id.singletons()):
                oracle = self._oracle_throughputs[worker_type]
                keys = [
                    self._jobs[s].job_type_key() for s in job_id.singletons()
                ]
                self._throughputs[job_id][worker_type] = list(
                    oracle[keys[0]][keys[1]]
                )
            return
        if not self._simulate:
            singles = job_id.singletons()
            old = self._throughputs[job_id][worker_type]
            old_list = list(old) if job_id.is_pair else [old]
            new_list = []
            for i in range(len(singles)):
                measured = (
                    0.0
                    if all_execution_times[i] <= 0
                    else all_num_steps[i] / all_execution_times[i]
                )
                if old_list[i] != INFINITY:
                    measured = (EMA_ALPHA * measured
                                + (1 - EMA_ALPHA) * old_list[i])
                new_list.append(measured)
            if np.min(all_execution_times) <= 0 and job_id.is_pair:
                new_list = [0.0, 0.0]
            self._throughputs[job_id][worker_type] = (
                new_list if job_id.is_pair else new_list[0]
            )

    def _get_remaining_steps(self, job_id: JobId) -> int:
        return self._jobs[job_id].total_steps - self._total_steps_run[job_id]

    # ------------------------------------------------------------------
    # Priorities and allocation: the Gavel round path. A schedulable unit
    # is a single job or, under a packed policy, a pair.
    # ------------------------------------------------------------------
    def _add_to_priorities(self, job_id: JobId) -> None:
        """The job and, under a packed policy, its pairs (the JAX
        package's scheduler.py:979; only packed policies have pairs, so
        the others skip the walk over every unit)."""
        for worker_type in self._worker_types:
            self._priorities[worker_type][job_id] = 0.0
            self._deficits[worker_type][job_id] = 0.0
            if not self._job_packing:
                continue
            for other in self._throughputs:
                if other.is_pair and job_id.overlaps_with(other):
                    self._priorities[worker_type][other] = 0.0
                    self._deficits[worker_type][other] = 0.0

    def _remove_from_priorities(self, job_id: JobId) -> None:
        """Drop the job and every pair holding it (the JAX package's
        scheduler.py:988)."""
        for worker_type in self._worker_types:
            stale = [job_id]
            if self._job_packing:
                stale = [other for other in self._priorities[worker_type]
                         if job_id.overlaps_with(other)]
            for other in stale:
                self._priorities[worker_type].pop(other, None)
                self._deficits[worker_type].pop(other, None)

    def _get_allocation_state(self) -> dict:
        """The policy's inputs, keyed by single job (throughputs by
        schedulable unit) (the JAX package's scheduler.py:1001)."""
        throughputs = {}
        scale_factors = {}
        priority_weights = {}
        times_since_start = {}
        num_steps_remaining = {}
        for job_id, per_type in self._throughputs.items():
            singles = job_id.singletons()
            if not all(s in self._jobs for s in singles):
                continue
            throughputs[job_id] = dict(per_type)
            for s in singles:
                scale_factors[s] = self._jobs[s].scale_factor
                priority_weights[s] = self._jobs[s].priority_weight
                times_since_start[s] = self.get_current_timestamp() - (
                    self._per_job_start_timestamps.get(s, 0.0)
                )
                num_steps_remaining[s] = self._get_remaining_steps(s)
        return {
            "throughputs": throughputs,
            "scale_factors": scale_factors,
            "priority_weights": priority_weights,
            "times_since_start": times_since_start,
            "num_steps_remaining": num_steps_remaining,
            "cluster_spec": dict(self._cluster_spec),
        }

    def _compute_allocation(self) -> Dict[JobId, Dict[str, float]]:
        """Call the policy with the signature its family expects, by its
        name's prefix (the JAX package's scheduler.py:1028)."""
        state = self._get_allocation_state()
        name = self._policy.name
        throughputs = state["throughputs"]
        scale_factors = state["scale_factors"]
        cluster_spec = state["cluster_spec"]
        if not throughputs or not cluster_spec:
            return {}
        if name == "AlloX_Perf":
            allocation = self._policy.get_allocation(
                throughputs,
                scale_factors,
                state["times_since_start"],
                state["num_steps_remaining"],
                cluster_spec,
            )
        elif name.startswith("FinishTimeFairness"):
            allocation = self._policy.get_allocation(
                throughputs,
                scale_factors,
                state["priority_weights"],
                state["times_since_start"],
                state["num_steps_remaining"],
                cluster_spec,
            )
        elif name.startswith("MaxMinFairness"):
            allocation = self._policy.get_allocation(
                throughputs, scale_factors, state["priority_weights"],
                cluster_spec,
            )
        elif name.startswith("MinTotalDuration"):
            allocation = self._policy.get_allocation(
                throughputs, scale_factors, state["num_steps_remaining"],
                cluster_spec,
            )
        elif "SLO" in name:
            # The policy sees each active job's time left to its deadline.
            now = self.get_current_timestamp()
            slos_remaining = {
                job_id: max(deadline - now, 1e-3)
                for job_id, deadline in self._slos.items()
                if job_id in self._jobs
            }
            allocation = self._policy.get_allocation(
                throughputs,
                scale_factors,
                cluster_spec,
                SLOs=slos_remaining,
                num_steps_remaining=state["num_steps_remaining"],
            )
        else:
            # FIFO, Isolated, Gandiva and the throughput sums.
            allocation = self._policy.get_allocation(
                throughputs, scale_factors, cluster_spec
            )
        if isinstance(allocation, tuple):
            # Strategy-proof max-min returns (allocation, discounts),
            # which the round path cannot take; the JAX package's
            # scheduler fails on it as well (a ValueError from numpy).
            raise ValueError(
                f"the {name} policy returned (allocation, discount "
                "factors); the round path takes an allocation"
            )
        return allocation or {}

    def _reset_time_run_so_far(self) -> None:
        """Fold the time each job received since the last reset against
        what its allocation promised into its deficit (the JAX package's
        scheduler.py:1089)."""
        current_time = self.get_current_timestamp()
        elapsed = current_time - self._last_reset_time
        for worker_type in self._worker_types:
            self._worker_time_so_far[worker_type] = 0.0
            for job_id in self._job_time_so_far:
                time_received = self._job_time_so_far[job_id].get(
                    worker_type, self._time_per_iteration / 2.0
                ) - (self._time_per_iteration / 2.0)
                if job_id in self._allocation:
                    should_have = self._allocation[job_id][worker_type] * elapsed
                else:
                    should_have = 0.0
                self._deficits[worker_type].setdefault(job_id, 0.0)
                self._deficits[worker_type][job_id] += should_have - time_received
                self._job_time_so_far[job_id][worker_type] = (
                    self._time_per_iteration / 2.0
                )
                self._worker_time_so_far[worker_type] += (
                    self._time_per_iteration / 2.0
                )
        self._last_reset_time = current_time

    def _update_priorities(self) -> None:
        """Recompute the allocation when it is stale and the reset interval
        has passed, then each job's priority per type: its allocation over
        the share of time it received (the JAX package's scheduler.py:1113,
        its simulation branch)."""
        current_time = self.get_current_timestamp()
        interval_ok = (
            current_time - self._last_reset_time >= self._min_reset_interval
            or self._last_reset_time == 0
        )
        if self._need_to_update_allocation and interval_ok:
            self._reset_time_run_so_far()
            start = time.perf_counter()
            self._allocation = self._compute_allocation()
            self.allocation_s += time.perf_counter() - start
            self.num_allocations += 1
            self._need_to_update_allocation = False

        fractions: Dict[str, Dict[JobId, float]] = {}
        for worker_type in self._worker_types:
            fractions[worker_type] = {}
            worker_time = self._worker_time_so_far[worker_type]
            for job_id in self._job_time_so_far:
                if (worker_time == 0.0
                        or worker_type not in self._job_time_so_far[job_id]):
                    fractions[worker_type][job_id] = 0.0
                else:
                    fractions[worker_type][job_id] = (
                        self._job_time_so_far[job_id][worker_type] / worker_time
                    )
            for job_id in self._priorities[worker_type]:
                if job_id not in self._allocation:
                    self._priorities[worker_type][job_id] = 0.0
                    continue
                alloc = self._allocation[job_id][worker_type]
                new_priority = alloc * 1e9
                tput = self._throughputs[job_id][worker_type]
                tput_zero = (
                    (tput[0] == 0 or tput[1] == 0) if job_id.is_pair
                    else tput == 0
                )
                if alloc == 0.0 or tput_zero:
                    new_priority = 0.0
                elif fractions[worker_type][job_id] > 0.0:
                    new_priority = alloc / fractions[worker_type][job_id]
                self._priorities[worker_type][job_id] = new_priority

    # ------------------------------------------------------------------
    # Per-round scheduling.
    # ------------------------------------------------------------------
    def _schedule_jobs_on_workers_helper(
        self, worker_types: List[str]
    ) -> Dict[str, List[Tuple[JobId, int]]]:
        """Greedy selection in (priority, deficit, allocation) order,
        highest first; equal keys keep the priorities' insertion order (the
        JAX package's scheduler.py:1157)."""
        already_scheduled: set = set()
        scheduled_jobs: Dict[str, List[Tuple[JobId, int]]] = {
            wt: [] for wt in worker_types
        }
        num_workers_left = {wt: self._cluster_spec[wt] for wt in worker_types}

        entries = []
        for worker_type in worker_types:
            per_type = []
            for job_id in self._priorities[worker_type]:
                allocation = 0.0
                if self._allocation and job_id in self._allocation:
                    allocation = self._allocation[job_id][worker_type]
                per_type.append(
                    (
                        job_id,
                        worker_type,
                        self._priorities[worker_type][job_id],
                        self._deficits[worker_type][job_id],
                        allocation,
                    )
                )
            per_type.sort(key=lambda x: (x[2], x[3], x[4]), reverse=True)
            entries += per_type

        is_fifo = self._policy.name.startswith("FIFO")
        for job_id, worker_type, priority, _, _ in entries:
            if num_workers_left[worker_type] == 0:
                continue
            singles = job_id.singletons()
            if any(s in already_scheduled for s in singles):
                continue
            tput = self._throughputs[job_id][worker_type]
            if job_id.is_pair:
                if tput[0] <= 0 or tput[1] <= 0:
                    continue
                sf0 = self._jobs[singles[0]].scale_factor
                if sf0 != self._jobs[singles[1]].scale_factor:
                    continue
                scale_factor = sf0
            else:
                if tput <= 0:
                    continue
                scale_factor = self._jobs[job_id].scale_factor
            if is_fifo and priority <= 0.0:
                continue
            if scale_factor > num_workers_left[worker_type]:
                continue
            num_workers_left[worker_type] -= scale_factor
            already_scheduled.update(singles)
            scheduled_jobs[worker_type].append((job_id, scale_factor))
        return scheduled_jobs

    # ------------------------------------------------------------------
    # Shockwave pool sets (hetero_pools).
    # ------------------------------------------------------------------
    def _shockwave_is_pool_set(self) -> bool:
        from shockwave_tpu_torch.policies.shockwave import PoolSetPlanner

        return isinstance(self._shockwave, PoolSetPlanner)

    def _maybe_upgrade_shockwave_to_pools(self) -> None:
        """With ``"hetero_pools": true`` in the Shockwave config, a
        heterogeneous cluster swaps the single-pool planner for a
        PoolSetPlanner (one EG plan per worker type) before any job is
        admitted (the JAX package's scheduler.py:1224). Opt-in, so the
        reference's single-pool plans stay the default."""
        from shockwave_tpu_torch.policies.shockwave import (
            PoolSetPlanner,
            ShockwavePlanner,
        )

        if isinstance(self._shockwave, PoolSetPlanner):
            return  # already upgraded
        if not isinstance(self._shockwave, ShockwavePlanner):
            # A CellPlanner is not upgraded: cells x pools is not a
            # composition either package has.
            if getattr(self._shockwave, "config", {}).get(
                "hetero_pools", False
            ):
                self._logger.warning(
                    "hetero_pools requested but the planner is %s; "
                    "per-worker-type pools are not composed with it, "
                    "keeping the existing planner",
                    type(self._shockwave).__name__,
                )
            return
        if not self._shockwave.config.get("hetero_pools", False):
            return
        if self._oracle_throughputs is None:
            self._logger.warning(
                "hetero_pools requested but no throughput oracle is "
                "configured; keeping single-pool planning"
            )
            return
        if self._shockwave.num_jobs > 0:
            return
        if len(self._worker_type_to_worker_ids) <= 1:
            return
        # The pool set takes the cluster as it stands at first admission.
        pools = {
            wt: self._cluster_spec[wt]
            for wt in self._worker_type_to_worker_ids
        }
        self._shockwave = PoolSetPlanner(
            self._shockwave.config, self._shockwave.backend, pools,
            device=self._shockwave.device,
        )

    def _pick_shockwave_pool(self, job, profile) -> Tuple[str, float]:
        """(pool, duration_scale) for a newly admitted job (the JAX
        package's scheduler.py:1282): among the pools wide enough for its
        gang, the one with the earliest fair-share completion estimate,
        duration (at the pool's speed) x (the pool's incomplete jobs + 1)
        / capacity. ``duration_scale`` rebases the profile's durations to
        that pool's speed from the type they were synthesized against
        (the config's ``profile_base_type``, else v100 if present, else
        the first registered type)."""
        base_type = self._shockwave.config.get("profile_base_type") or (
            "v100" if "v100" in self._worker_type_to_worker_ids
            else next(iter(self._worker_type_to_worker_ids))
        )
        key = job.job_type_key()

        def tput(wt):
            try:
                return float(self._oracle_throughputs[wt][key]["null"])
            except (KeyError, TypeError):
                return 0.0

        base_tput = max(tput(base_type), 1e-9)
        duration = float(sum(profile.get("duration_every_epoch", ())))
        best_wt, best_finish = None, float("inf")
        widest_wt = max(
            self._shockwave.pools, key=lambda wt: self._shockwave.pools[wt]
        )
        for wt, capacity in self._shockwave.pools.items():
            if capacity < job.scale_factor:
                continue  # a gang the pool can never place
            t = tput(wt)
            if t <= 0:
                continue
            population = self._shockwave.pool_incomplete_jobs(wt)
            finish = (duration * (base_tput / t) * (population + 1)
                      / max(capacity, 1))
            if finish < best_finish:
                best_wt, best_finish = wt, finish
        if best_wt is None:
            # No pool fits: the widest pool, durations unscaled, as on a
            # homogeneous cluster.
            return widest_wt, 1.0
        return best_wt, base_tput / max(tput(best_wt), 1e-9)

    def _shockwave_pool_type(self) -> str:
        """The homogeneous pool the planner plans onto: v100 when present,
        else the cluster's sole worker type (reference: v100-only,
        scheduler.py:991-1014)."""
        if "v100" in self._worker_type_to_worker_ids:
            return "v100"
        types = list(self._worker_type_to_worker_ids)
        if len(types) == 1:
            return types[0]
        raise ValueError(
            "Shockwave plans a homogeneous pool: need a 'v100' "
            f"pool or a single worker type, got {types}"
        )

    def _shockwave_schedule_helper(self) -> Dict[str, List[Tuple[JobId, int]]]:
        """This round's job list from the planner (reference:
        scheduler.py:991-1014); under a pool set, every pool's own."""
        if self._shockwave_is_pool_set():
            by_pool = self._shockwave.current_round_schedule_by_pool()
            self._current_round_scheduled_jobs = [
                j for schedule in by_pool.values() for j in schedule
            ]
            return {
                wt: [
                    (j, self._jobs[j].scale_factor)
                    for j in schedule
                    if j in self._jobs
                ]
                for wt, schedule in by_pool.items()
            }
        worker_type = self._shockwave_pool_type()
        scheduled: Dict[str, List[Tuple[JobId, int]]] = {worker_type: []}
        self._current_round_scheduled_jobs = self._shockwave.current_round_schedule()
        for job_id in self._current_round_scheduled_jobs:
            if job_id in self._jobs:
                scheduled[worker_type].append(
                    (job_id, self._jobs[job_id].scale_factor)
                )
        return scheduled

    def _assign_workers_to_job(
        self, job_id, scale_factor, worker_state, worker_assignments
    ) -> None:
        """Strided server-local placement (reference: scheduler.py:838-889)."""
        worker_ids = worker_state["worker_ids"]
        assigned = worker_state["assigned_worker_ids"]
        ptr = worker_state["server_id_ptr"]
        ids_for_job = list(worker_assignments.get(job_id, ()))
        while len(ids_for_job) < scale_factor and ptr < len(worker_ids):
            if not worker_ids[ptr]:
                ptr += 1
                continue
            candidate = worker_ids[ptr][0]
            if candidate not in assigned:
                ids_for_job.append(candidate)
                assigned.add(candidate)
            worker_ids[ptr].pop(0)
        if len(ids_for_job) != scale_factor:
            raise RuntimeError(f"Could not assign workers to job {job_id}")
        worker_assignments[job_id] = tuple(ids_for_job)
        worker_state["server_id_ptr"] = ptr
        # Physical mode marks jobs running at dispatch instead.
        if self._simulate:
            for single in job_id.singletons():
                self._per_job_latest_timestamps[single] = (
                    self.get_current_timestamp())
                self._running_jobs.add(single)

    def _schedule_jobs_on_workers(self) -> "OrderedDict[JobId, tuple]":
        """(reference: scheduler.py:1017-1129)"""
        if not self._is_shockwave:
            self._update_priorities()

        # The reference's fixed goodness order for its GPU vocabulary;
        # other worker types come after, alphabetically.
        known = ["v100", "p100", "k80"]
        worker_types = [
            wt for wt in known if wt in self._worker_type_to_worker_ids
        ] + sorted(
            wt for wt in self._worker_type_to_worker_ids if wt not in known
        )
        # Only policies whose name holds neither "Perf" nor "Packing"
        # (Shockwave's among them) shuffle, and the shuffle draws from
        # the seeded stream.
        name = self._policy.name
        if "Perf" not in name and "Packing" not in name:
            self._worker_type_shuffler.shuffle(worker_types)

        if self._is_shockwave:
            scheduled_jobs = self._shockwave_schedule_helper()
            worker_types = [wt for wt in worker_types if wt in scheduled_jobs]
        else:
            scheduled_jobs = self._schedule_jobs_on_workers_helper(worker_types)

        new_assignments: "OrderedDict[JobId, tuple]" = OrderedDict()
        worker_state = {}
        for worker_type in worker_types:
            scheduled_jobs[worker_type].sort(key=lambda x: x[1], reverse=True)
            worker_state[worker_type] = {
                "worker_ids": copy.deepcopy(
                    self._worker_type_to_worker_ids[worker_type]
                ),
                "assigned_worker_ids": set(),
                "server_id_ptr": 0,
            }

        prev_worker_types = {
            job_id: self._worker_id_to_worker_type[ids[0]]
            for job_id, ids in self._current_worker_assignments.items()
        }

        for worker_type in worker_types:
            state = worker_state[worker_type]
            assigned = state["assigned_worker_ids"]
            scale_factors = sorted(
                {sf for _, sf in scheduled_jobs[worker_type]}, reverse=True
            )
            for current_sf in scale_factors:
                # First pass: keep jobs on their previous workers if intact.
                for job_id, sf in scheduled_jobs[worker_type]:
                    if sf != current_sf:
                        continue
                    if prev_worker_types.get(job_id) != worker_type:
                        continue
                    prev_ids = self._current_worker_assignments[job_id]
                    if any(wid in assigned for wid in prev_ids):
                        continue
                    new_assignments[job_id] = prev_ids
                    assigned.update(prev_ids)
                # Second pass: everyone else, strided.
                for job_id, sf in scheduled_jobs[worker_type]:
                    if sf != current_sf:
                        continue
                    if not self._is_shockwave and job_id not in self._allocation:
                        continue
                    self._assign_workers_to_job(
                        job_id, sf, state, new_assignments
                    )

        counts: Dict[int, int] = {}
        for ids in new_assignments.values():
            for wid in ids:
                counts[wid] = counts.get(wid, 0) + 1
                if counts[wid] > 1:
                    raise RuntimeError(f"Worker {wid} assigned twice")
        return new_assignments

    # ------------------------------------------------------------------
    # Micro-task accounting.
    # ------------------------------------------------------------------
    def _get_num_steps(self, job_id, worker_type, single_job_id) -> int:
        """The steps ``single_job_id`` of ``job_id`` makes in a round: at
        its isolated rate, or, in a simulated pair, at the oracle's
        co-located rate of the pair's current job types (reference:
        scheduler.py:1131-1165)."""
        if self._simulate and job_id.is_pair:
            oracle = self._oracle_throughputs[worker_type]
            index = job_id.as_tuple().index(single_job_id[0])
            sf = self._jobs[single_job_id].scale_factor
            keys = [(self._jobs[s].job_type, sf) for s in job_id.singletons()]
            tput = oracle[keys[0]][keys[1]][index]
        else:
            tput = self._throughputs[job_id][worker_type]
            if job_id.is_pair:
                tput = tput[job_id.as_tuple().index(single_job_id[0])]
        num_steps = int(tput * self._time_per_iteration)
        return min(num_steps, self._get_remaining_steps(single_job_id))

    def _get_job_steps_and_finish_times(self, job_id, worker_type):
        """(reference: scheduler.py:1166-1212)"""
        max_finish_time = self.get_current_timestamp()
        all_num_steps = []
        true_pair_tputs = None
        if self._simulate and self._estimate_throughputs and job_id.is_pair:
            # Execution runs at the oracle's rate even where the allocator
            # saw estimates (the JAX package's scheduler.py:1512).
            oracle = self._oracle_throughputs[worker_type]
            keys = [self._jobs[s].job_type_key() for s in job_id.singletons()]
            true_pair_tputs = oracle[keys[0]][keys[1]]
        for i, single in enumerate(job_id.singletons()):
            num_steps = self._get_num_steps(job_id, worker_type, single)
            all_num_steps.append(num_steps)
            if true_pair_tputs is not None:
                tput = true_pair_tputs[i]
            else:
                tput = self._throughputs[job_id][worker_type]
                if job_id.is_pair:
                    tput = tput[i]
            if tput <= 0:
                raise RuntimeError(
                    f"Throughput for job {single} on {worker_type} is <= 0"
                )
            finish_time = self.get_current_timestamp() + num_steps / tput
            max_finish_time = max(max_finish_time, finish_time)
            self._running_jobs.add(single)
        return all_num_steps, max_finish_time

    def _micro_task_scale_factor(self, job_id) -> int:
        """Gang size of the micro-task being merged. Physical mode
        overrides this with the dispatch-time record, since assignments
        may have rotated by the time a Done report arrives."""
        return len(self._current_worker_assignments[job_id])

    def _done_callback(
        self, job_id, worker_id, all_num_steps, all_execution_times,
        fault: bool = False,
    ) -> None:
        """Merge per-worker completions for a micro-task; update steps, time
        and batch-size adaptation; remove finished jobs
        (reference: scheduler.py:3223-3482, simulation paths).
        ``fault=True`` marks a completion synthesized for a worker that
        died under the job: its zero progress is not charged as a failed
        attempt, for the whole gang's merge."""
        to_remove: List[JobId] = []
        worker_type = self._worker_id_to_worker_type[worker_id]
        is_active = {s: s in self._jobs for s in job_id.singletons()}
        if not any(is_active.values()):
            return

        scale_factor = self._micro_task_scale_factor(job_id)
        updates = self._in_progress_updates.setdefault(job_id, [])
        updates.append((worker_id, all_num_steps, all_execution_times))
        if fault:
            self._fault_tainted.add(job_id)
        if len(updates) < scale_factor:
            return
        fault = fault or job_id in self._fault_tainted
        self._fault_tainted.discard(job_id)
        updates.sort(key=lambda x: x[0])
        micro_task_succeeded = True
        merged_steps = [0] * len(job_id.singletons())
        merged_times = [0.0] * len(job_id.singletons())
        for _, steps_i, times_i in updates:
            for j, single in enumerate(job_id.singletons()):
                if (
                    not self._simulate
                    and is_active[single]
                    and (steps_i[j] <= 0 or times_i[j] <= 0)
                ):
                    # Physical mode: any worker reporting no progress
                    # means the micro-task failed (reference:
                    # scheduler.py:3326-3328).
                    micro_task_succeeded = False
                merged_steps[j] += steps_i[j]
                merged_times[j] = max(merged_times[j], times_i[j])
        if self._simulate:
            # A gang's steps are split across workers and the final sliver
            # of a job can be smaller than its gang, leaving some workers
            # with 0 steps: success is judged on the merged totals.
            for j, single in enumerate(job_id.singletons()):
                if is_active[single] and (
                    merged_steps[j] <= 0 or merged_times[j] <= 0
                ):
                    micro_task_succeeded = False
        self._in_progress_updates[job_id] = []

        if not micro_task_succeeded:
            self._logger.info("[Micro-task failed]\tJob ID: %s", job_id)
            if not fault and not job_id.is_pair and is_active[job_id]:
                self._num_failures_per_job[job_id] += 1
                if self._num_failures_per_job[job_id] >= MAX_FAILED_ATTEMPTS:
                    to_remove.append(job_id)
            self._need_to_update_allocation = True
        else:
            for single, num_steps, execution_time in zip(
                job_id.singletons(), merged_steps, merged_times
            ):
                if not is_active[single]:
                    continue
                if self._per_worker_type_prices is not None:
                    from shockwave_tpu_torch.data.spot_prices import (
                        latest_price,
                    )

                    self._job_cost_so_far[single] += (
                        latest_price(
                            self._per_worker_type_prices,
                            worker_type,
                            self.get_current_timestamp(),
                        )
                        * execution_time
                        / 3600.0
                        * scale_factor
                    )
                if single in self._running_jobs:
                    self._running_jobs.remove(single)
                    self._steps_run_so_far[single][worker_type] += num_steps
                    self._total_steps_run[single] += num_steps
                    self._job_total_run_time[single] = (
                        self._job_total_run_time.get(single, 0.0)
                        + execution_time
                    )
                    if self._get_remaining_steps(single) <= 0:
                        to_remove.append(single)
            max_execution_time = max(merged_times)
            if job_id in self._job_time_so_far:
                self._job_time_so_far[job_id][worker_type] += max_execution_time
                self._worker_time_so_far[worker_type] += max_execution_time
            for wid, _, _ in updates:
                self._cumulative_worker_time_so_far[wid] += max_execution_time

        self._update_throughput(job_id, worker_type, merged_steps,
                                merged_times)

        for single in job_id.singletons():
            self._scale_bs_and_iters(single)
            self._bs_scale[single] = None

        for single in to_remove:
            self._remove_job(single)
            if self._is_shockwave:
                self._shockwave.remove_job(single)

    # ------------------------------------------------------------------
    # Batch-size adaptation (simulation).
    # ------------------------------------------------------------------
    def _simulate_gns(self, job_id: JobId) -> None:
        """(reference: scheduler.py:1308-1334)"""
        from shockwave_tpu_torch.data import bs_patterns

        job = self._jobs[job_id]
        model = job.model
        batch_size = job.batch_size
        current_epoch = epochs_for_steps(
            model, batch_size, self._total_steps_run[job_id]
        )
        pattern = bs_patterns.gns_pattern(
            job.job_type,
            self._original_bs[job_id],
            max(760, current_epoch + 2),
            job.scale_factor,
        )
        if (
            pattern[current_epoch + 1] > batch_size
            or pattern[current_epoch] > batch_size
        ):
            if MAX_BATCH_SIZES.get(model) != batch_size:
                self._bs_scale[job_id] = BS_BIG

    def _simulate_accordion(self, job_id: JobId) -> None:
        """(reference: scheduler.py:1336-1363)"""
        from shockwave_tpu_torch.data import bs_patterns

        job = self._jobs[job_id]
        model = job.model
        if model == "Transformer":
            return
        batch_size = job.batch_size
        original = self._original_bs[job_id]
        current_epoch = epochs_for_steps(
            model, batch_size, self._total_steps_run[job_id]
        )
        in_critical = bs_patterns.accordion_in_critical_regime(
            model, original, current_epoch
        )
        if batch_size == original and not in_critical:
            if MAX_BATCH_SIZES.get(model) != batch_size:
                self._bs_scale[job_id] = BS_BIG
        elif batch_size != original and in_critical:
            if MIN_BATCH_SIZES.get(model) != batch_size:
                self._bs_scale[job_id] = BS_SMALL

    def _scale_bs_and_iters(self, job_id: JobId) -> None:
        """Apply a pending batch-size change: rewrite the job's command and
        type, refresh throughputs, and rescale total/completed steps so epoch
        progress is preserved (reference: scheduler.py:3504-3591)."""
        if job_id is None or self._bs_scale.get(job_id) is None:
            return
        job = self._jobs[job_id]
        old_bs = job.batch_size
        model = job.model
        original = self._original_bs[job_id]
        if MAX_BATCH_SIZES.get(model) == original:
            self._bs_scale[job_id] = None
            return
        if job.mode == "gns":
            if self._bs_scale[job_id] != BS_BIG:
                raise RuntimeError(f"gns job {job_id} asked to shrink")
            new_bs = 2 * old_bs
        elif job.mode == "accordion":
            new_bs = (
                MAX_BATCH_SIZES[model]
                if self._bs_scale[job_id] == BS_BIG
                else original
            )
        else:
            new_bs = old_bs
        job.update_batch_size(new_bs)
        for worker_type in self._worker_types:
            key = job.job_type_key()
            if key not in self._oracle_throughputs[worker_type]:
                self._logger.error(
                    "Reverting job %s bs: %s -> %s", job_id, new_bs, old_bs
                )
                self._bs_scale[job_id] = None
                job.update_batch_size(old_bs)
                return
            self._throughputs[job_id][worker_type] = self._oracle_throughputs[
                worker_type
            ][key]["null"]

        total_steps = job.total_steps
        total_steps_run = self._total_steps_run[job_id]
        old_total_epochs = epochs_for_steps(model, old_bs, total_steps)
        new_total_steps = math.ceil(total_steps * old_bs / new_bs)
        if epochs_for_steps(model, new_bs, new_total_steps) != old_total_epochs:
            new_total_steps = total_steps_for_epochs(model, new_bs, old_total_epochs)
        job.total_steps = new_total_steps

        completed_epochs = epochs_for_steps(model, old_bs, total_steps_run)
        new_steps_run = total_steps_for_epochs(model, new_bs, completed_epochs)
        # Rescale each worker type's step history proportionally.
        old_total = self._total_steps_run[job_id]
        for worker_type in self._worker_types:
            old_per_type = self._steps_run_so_far[job_id].get(worker_type, 0)
            if old_total > 0:
                self._steps_run_so_far[job_id][worker_type] = round(
                    old_per_type * new_steps_run / old_total
                )
            else:
                self._steps_run_so_far[job_id][worker_type] = 0
        self._total_steps_run[job_id] = new_steps_run

        self._bs_scale[job_id] = None
        if self._is_shockwave:
            self._shockwave.set_recompute_flag(jobs=[job_id])

    def _shockwave_scheduler_update(self) -> None:
        """Push epoch progress into the planner and advance its round
        (reference: scheduler.py:3598-3621); under a pool set each job's
        steps on its own pool's type."""
        is_pool_set = self._shockwave_is_pool_set()
        default_pool = (
            self._shockwave_pool_type()
            if not is_pool_set and self._current_round_scheduled_jobs
            else None
        )
        for job_id in self._current_round_scheduled_jobs:
            if job_id in self._completed_jobs:
                self._shockwave.mark_complete(job_id)
                continue
            pool_type = (
                self._shockwave.pool_of(job_id) if is_pool_set
                else default_pool
            )
            steps_run = self._steps_run_so_far.get(job_id, {}).get(
                pool_type, 0
            )
            if job_id in self._jobs:
                bs = self._jobs[job_id].batch_size
                model = self._jobs[job_id].model
                current_epoch = steps_run // steps_per_epoch(model, bs)
                self._shockwave.set_progress(job_id, current_epoch)
        self._shockwave.increment_round()

    # ------------------------------------------------------------------
    # Observability planes (the JAX package's scheduler.py:1778-1915).
    # ------------------------------------------------------------------
    def _round_observability(self, assignments, preempted=None) -> None:
        """Per-round taps of the planes beyond plain metrics: the flight
        recorder's round context, the predictor-calibration forecasts
        and the health watchdog. One flags check when every plane is
        off, the default."""
        recorder = obs.get_recorder()
        calibration = obs.get_calibration()
        watchdog = obs.get_watchdog()
        metrics_on = obs.metrics_enabled()
        if not (recorder.enabled or calibration.enabled or watchdog.enabled
                or metrics_on):
            return
        if metrics_on:
            self._publish_tenant_spend()
            # Ring-buffer history sampling and the cardinality
            # governor's decay: one pass over the series a round.
            obs.scale_tick(self.get_current_timestamp())
        if not (recorder.enabled or calibration.enabled or watchdog.enabled):
            return
        now = self.get_current_timestamp()
        if recorder.enabled:
            recorder.record_round_context(
                self._num_completed_rounds,
                now,
                assignments=assignments,
                job_steps={
                    j.integer: self._total_steps_run.get(j, 0)
                    for j in self._jobs
                },
                preempted=preempted,
            )
        if calibration.enabled and self._shockwave is not None:
            for j in self._jobs:
                md = self._shockwave.get_metadata(j)
                if md is None or md.completed_epochs >= md.total_epochs:
                    continue
                run_so_far = self._job_total_run_time.get(j, 0.0)
                # Score the now-to-finish forecast, its credible interval
                # shifted by the same offset; the posterior is evaluated
                # once and threaded through.
                base = md.remaining_runtime()
                predicted = md.remaining_runtime_to_completion(
                    run_so_far, base=base
                )
                lo, hi = md.remaining_runtime_interval(mean=base)
                offset = predicted - base
                calibration.record_forecast(
                    j.integer,
                    run_so_far,
                    predicted,
                    lo + offset,
                    hi + offset,
                    ts_s=now,
                    ape_floor_s=md.mean_epoch_duration(),
                )
        if watchdog.enabled:
            watchdog.check_round(
                self._num_completed_rounds,
                now,
                job_steps={
                    j.integer: self._total_steps_run.get(j, 0)
                    for j in self._jobs
                },
                scheduled=[
                    s.integer for key in assignments
                    for s in key.singletons()
                ],
            )

    def _publish_tenant_spend(self) -> None:
        """Per-tenant spend gauges from the planner's last committed
        replan: ``market_tenant_spend{tenant}`` sums each tenant's
        chip-rounds in the plan (the market's per-job ``spend``). Jobs
        without a tenant land under ``default``; a tenant whose jobs all
        finished is zeroed. The labeled gauge keeps the top
        ``SHOCKWAVE_OBS_EXEMPLARS`` (10) spenders; two unlabeled rollups
        stay exact."""
        market = getattr(self._shockwave, "last_market", None)
        if market is None or market["round"] == self._tenant_spend_round:
            return
        self._tenant_spend_round = market["round"]
        tenant_by_key = {
            str(j): (getattr(job, "tenant", "") or "default")
            for j, job in self._jobs.items()
        }
        by_tenant: dict = {}
        for key, spend in zip(market["keys"], market["spend"]):
            tenant = tenant_by_key.get(key)
            if tenant is None:
                continue  # departed since the replan
            by_tenant[tenant] = by_tenant.get(tenant, 0.0) + spend
        k = max(1, int(os.environ.get("SHOCKWAVE_OBS_EXEMPLARS", 10)))
        top = dict(sorted(by_tenant.items(), key=lambda kv: -kv[1])[:k])
        gauge = obs.gauge(
            "market_tenant_spend",
            "chip-rounds of the last committed plan per tenant "
            "(top spenders only; see market_tenant_spend_total)",
        )
        for tenant in self._tenant_spend_seen - set(top):
            gauge.remove(tenant=tenant)
        for tenant, spend in top.items():
            gauge.set(float(spend), tenant=tenant)
            obs.offer_exemplar(
                "tenant_top_spend",
                tenant,
                float(spend),
                help="tenants with the largest chip-round spend in the "
                "last committed plan",
                spend=round(float(spend), 6),
            )
        obs.gauge(
            "market_tenant_spend_total",
            "chip-rounds of the last committed plan summed over ALL "
            "tenants (exact, unlabeled rollup)",
        ).set(float(sum(by_tenant.values())))
        obs.gauge(
            "market_tenants",
            "tenants with spend in the last committed plan",
        ).set(len(by_tenant))
        self._tenant_spend_seen = set(top)

    # ------------------------------------------------------------------
    # Plan-ahead pipelining (policies/speculation.py).
    # ------------------------------------------------------------------
    def _shockwave_can_speculate(self) -> bool:
        return (
            self._speculate
            and self._shockwave is not None
            and hasattr(self._shockwave, "speculate_next_round")
            and not self._shockwave_is_pool_set()
            and bool(self._current_round_scheduled_jobs)
        )

    def _predict_round_outcome(self, dispatch_preview):
        """The planner delta between now (round r's micro-tasks just
        dispatched) and the next boundary (the JAX package's
        scheduler.py:1929-1960). In simulation the prediction is exact:
        ``dispatch_preview`` maps each dispatched single job to the
        (steps, execution seconds) the completion merge will take.
        Returns None when the boundary is known to churn: a dispatched
        job with a pending batch-size switch has its steps rescaled and
        the planner flagged at the merge."""
        steps_map: dict = {}
        for job_id in self._current_round_scheduled_jobs:
            if self._jobs.get(job_id) is None:
                continue
            if (
                self._bs_scale.get(job_id) is not None
                and job_id in dispatch_preview
            ):
                return None
            steps_add, exec_s = dispatch_preview.get(job_id, (0, 0.0))
            steps_map[job_id] = (
                steps_add,
                steps_add / exec_s if exec_s > 0 else 0.0,
            )
        return self._spec_outcome_from_steps(steps_map)

    def _spec_outcome_from_steps(self, steps_map):
        """The round outcome both modes predict, from each scheduled
        single job's (steps, throughput) this round (the JAX package's
        scheduler.py:1962-2009): the throughput records the completion
        merge will append, each job's epoch progress after the
        boundary's ``set_progress`` pass, and the jobs that will
        finish."""
        from shockwave_tpu_torch.policies.speculation import SpecOutcome

        pool = self._shockwave_pool_type()
        next_round = self._num_completed_rounds
        progress: dict = {}
        throughputs: list = []
        completions: list = []
        for job_id in self._current_round_scheduled_jobs:
            job = self._jobs.get(job_id)
            if job is None:
                continue
            steps_add, tput = steps_map.get(job_id, (0, 0.0))
            if steps_add > 0:
                throughputs.append((job_id, next_round, tput, job.batch_size))
            if (
                steps_add > 0
                and self._total_steps_run[job_id] + steps_add
                >= job.total_steps
            ):
                completions.append(job_id)
            else:
                steps_after = (
                    self._steps_run_so_far.get(job_id, {}).get(pool, 0)
                    + steps_add
                )
                progress[job_id] = steps_after // steps_per_epoch(
                    job.model, job.batch_size
                )
        return SpecOutcome(
            target_round=self._shockwave.round_index + 1,
            progress=progress,
            throughputs=throughputs,
            completions=completions,
            capacity=self._shockwave.num_gpus,
        )

    # ------------------------------------------------------------------
    # Simulation.
    # ------------------------------------------------------------------
    def get_current_timestamp(self) -> float:
        return self._current_timestamp

    def simulate(
        self,
        cluster_spec: Dict[str, int],
        arrival_times: Optional[List[float]] = None,
        jobs: Optional[List[Job]] = None,
        num_gpus_per_server: Optional[Dict[str, int]] = None,
        jobs_to_complete: Optional[set] = None,
        max_rounds: Optional[int] = None,
        checkpoint_threshold: Optional[int] = None,
        checkpoint_file: Optional[str] = None,
        submitter=None,
        admission_capacity: Optional[int] = None,
        admission_retry_s: Optional[float] = None,
        admission_pricer=None,
    ) -> float:
        """Trace-driven simulation; returns the makespan
        (reference: scheduler.py:1365-1796, from_trace path).

        With ``checkpoint_threshold`` and ``checkpoint_file`` set, the
        scheduler's state, the planner's and the loop's are pickled to
        the file at the top of the loop once that many jobs have been
        admitted; a fresh scheduler given an existing ``checkpoint_file``
        resumes from there and ends where the unbroken run ends (the JAX
        package's scheduler.py:2054-2190).

        With ``submitter`` (a :class:`~shockwave_tpu_torch.runtime.
        admission.StreamingSubmitter`), jobs arrive through the bounded,
        token-deduplicated, backpressured admission queue the physical
        SubmitJobs RPC feeds, in virtual time: the loop idles through
        arrival gaps and ends when the submitter closed the stream, the
        queue drained and every admitted job completed; ``arrival_times``
        and ``jobs`` are then ignored (the JAX package's
        scheduler.py:2095-2130, 2277-2330)."""
        from shockwave_tpu_torch.runtime import admission as admission_mod
        from shockwave_tpu_torch.runtime import faults

        # The armed fault plan, if any: its cluster events land at round
        # boundaries below.
        fault_injector = faults.active()
        if submitter is not None:
            if checkpoint_threshold is not None or checkpoint_file is not None:
                # The admission queue is not part of the checkpoint.
                raise ValueError(
                    "checkpointing is not supported with a streaming "
                    "submitter (the admission queue is not part of the "
                    "checkpoint contract)"
                )
            remaining_jobs = submitter.total_jobs
            queued_jobs: list = []
            # Virtual-time admission queue, sharded one slice a cell
            # under a cell-decomposed planner.
            self._admission = admission_mod.build_queue(
                capacity=admission_capacity
                or admission_mod.DEFAULT_CAPACITY,
                retry_delay_s=(
                    admission_retry_s
                    if admission_retry_s is not None
                    else max(1.0, self._time_per_iteration / 4.0)
                ),
                clock=lambda: self._current_timestamp,
                shards=getattr(self._shockwave, "num_cells", 1) or 1,
                pricer=admission_pricer,
            )
        else:
            if arrival_times is None or jobs is None:
                raise ValueError(
                    "simulate needs the trace's jobs and arrivals")
            remaining_jobs = len(jobs)
            queued_jobs = list(zip(arrival_times, jobs))
        running_jobs: list = []
        consecutive_idle_rounds = 0
        checkpoint_saved = False

        for worker_type in sorted(cluster_spec):
            num_gpus = (
                num_gpus_per_server[worker_type]
                if num_gpus_per_server is not None
                else 1
            )
            for _ in range(cluster_spec[worker_type] // num_gpus):
                self.register_worker(worker_type, num_gpus=num_gpus)

        if checkpoint_file is not None and os.path.exists(checkpoint_file):
            extra = self.load_checkpoint(checkpoint_file)
            queued_jobs = extra["queued_jobs"]
            running_jobs = extra["running_jobs"]
            remaining_jobs = extra["remaining_jobs"]
            consecutive_idle_rounds = extra["consecutive_idle_rounds"]
            checkpoint_saved = True
            self._logger.info(
                "Resumed from checkpoint %s at t=%.1f (%d jobs queued)",
                checkpoint_file, self._current_timestamp, len(queued_jobs),
            )
        elif submitter is not None:
            first = submitter.next_due_time()
            self._current_timestamp = first if first is not None else 0.0
        else:
            self._current_timestamp = arrival_times[0]

        while True:
            # Saved at the top of the loop, the point a resume enters.
            if (
                checkpoint_threshold is not None
                and checkpoint_file is not None
                and not checkpoint_saved
                and self._job_id_counter >= checkpoint_threshold
            ):
                self.save_checkpoint(
                    checkpoint_file,
                    extra=dict(
                        queued_jobs=queued_jobs,
                        running_jobs=running_jobs,
                        remaining_jobs=remaining_jobs,
                        consecutive_idle_rounds=consecutive_idle_rounds,
                    ),
                )
                checkpoint_saved = True
                self._logger.info(
                    "Saved checkpoint to %s after job %d",
                    checkpoint_file, self._job_id_counter - 1,
                )
            if jobs_to_complete is not None and jobs_to_complete.issubset(
                self._completed_jobs
            ):
                break
            if remaining_jobs == 0:
                break
            if max_rounds is not None and self._num_completed_rounds >= max_rounds:
                break
            next_job_arrival_time = (
                submitter.next_due_time()
                if submitter is not None
                else (queued_jobs[0][0] if queued_jobs else None)
            )
            if next_job_arrival_time is None and not running_jobs:
                self._last_reset_time = 0

            # Advance the clock to the end of the round (latest micro-task
            # finish) or to the next arrival when idle.
            max_timestamp = 0.0
            if running_jobs and -running_jobs[0][0] > max_timestamp:
                max_timestamp = -running_jobs[0][0]
            if max_timestamp > 0:
                self._current_timestamp = max_timestamp
            elif next_job_arrival_time is not None:
                self._current_timestamp = max(
                    self._current_timestamp, next_job_arrival_time
                )

            # Injected churn lands before the completion drain: a worker
            # crashed mid-round takes its micro-task's progress with it.
            if fault_injector is not None:
                self._apply_cluster_fault_events(
                    fault_injector, running_jobs, queued_jobs=queued_jobs
                )

            # Complete every running micro-task (they all end by round end).
            while running_jobs:
                (
                    finish_time,
                    job_id,
                    worker_ids,
                    all_num_steps,
                    round_start,
                ) = running_jobs[0]
                finish_time = -finish_time
                if finish_time > self._current_timestamp:
                    break
                all_execution_times = []
                for single in job_id.singletons():
                    # Execution time runs from this micro-task's dispatch,
                    # so idle gaps between rounds are never billed as work.
                    all_execution_times.append(finish_time - round_start)
                    self._per_job_latest_timestamps[single] = finish_time
                self._in_progress_updates[job_id] = []
                scale_factor = len(worker_ids)
                total_steps = [0] * len(job_id.singletons())
                for i, worker_id in enumerate(worker_ids):
                    if i == len(worker_ids) - 1:
                        worker_steps = [
                            all_num_steps[j] - total_steps[j]
                            for j in range(len(all_num_steps))
                        ]
                    else:
                        worker_steps = [x // scale_factor for x in all_num_steps]
                    for j in range(len(worker_steps)):
                        total_steps[j] += worker_steps[j]
                    self._done_callback(
                        job_id, worker_id, worker_steps, all_execution_times
                    )
                for single in job_id.singletons():
                    if single not in self._jobs:
                        remaining_jobs -= 1
                heapq.heappop(running_jobs)

            # Batch-size adaptation flags for the next completion.
            for job_id in self._jobs:
                if self._jobs[job_id].mode == "accordion":
                    self._simulate_accordion(job_id)
                elif self._jobs[job_id].mode == "gns":
                    self._simulate_gns(job_id)

            if self._is_shockwave and self._num_completed_rounds >= 1:
                self._shockwave_scheduler_update()

            # Admit arrivals due by now: the streaming path pumps the
            # submitter and drains the admission queue; the static path
            # pops the trace.
            if submitter is not None:
                for token, job, enqueued in submitter.pump(
                    self._admission, self._current_timestamp
                ):
                    job_id = self.add_job(
                        job,
                        timestamp=getattr(job, "arrival_time", enqueued),
                    )
                    recorder = obs.get_recorder()
                    if recorder.enabled:
                        recorder.record_admission(
                            {
                                "kind": "admitted",
                                "token": token,
                                "job_id": job_id.integer,
                                "round": self._num_completed_rounds,
                                "time": self._current_timestamp,
                            }
                        )
            else:
                while (queued_jobs
                       and queued_jobs[0][0] <= self._current_timestamp):
                    arrival_time, job = queued_jobs.pop(0)
                    self.add_job(job, timestamp=arrival_time)

            if len(self._jobs) == 0:
                if submitter is not None:
                    if (
                        submitter.exhausted()
                        and self._admission.depth() == 0
                    ):
                        break
                    continue
                if not queued_jobs:
                    break
                continue

            scheduled_jobs = self._schedule_jobs_on_workers()
            # The planner's empty round means end of trace.
            if self._is_shockwave and len(scheduled_jobs) == 0:
                break
            stream_pending = submitter is not None and not (
                submitter.exhausted() and self._admission.depth() == 0
            )
            if (
                not scheduled_jobs
                and not running_jobs
                and not queued_jobs
                and not stream_pending
            ):
                # One idle iteration is recoverable: the reset of
                # _last_reset_time at the top of the loop forces an
                # allocation recompute next time around. Two in a row is
                # a deadlock.
                consecutive_idle_rounds += 1
                if consecutive_idle_rounds > 1:
                    raise RuntimeError(
                        "Scheduling deadlock: %d active jobs but nothing "
                        "schedulable" % len(self._jobs)
                    )
            else:
                consecutive_idle_rounds = 0
            preempted_this_round = []
            for job_id in self._current_worker_assignments:
                if any(s in self._jobs for s in job_id.singletons()):
                    self._num_lease_extension_opportunities += 1
                    kept = job_id in scheduled_jobs and set(
                        self._current_worker_assignments[job_id]
                    ) == set(scheduled_jobs[job_id])
                    if not kept:
                        self._num_preemptions += 1
                        preempted_this_round.append(job_id)
                        obs.counter(
                            "scheduler_preemptions_total",
                            "still-active jobs that lost their workers "
                            "at a round boundary",
                        ).inc()
                        obs.instant(
                            "preemption", cat="sched", tid="rounds",
                            args={"job_id": str(job_id)},
                        )
            for job_id in scheduled_jobs:
                if job_id in self._current_worker_assignments and set(
                    self._current_worker_assignments[job_id]
                ) == set(scheduled_jobs[job_id]):
                    self._num_lease_extensions += 1
                    obs.counter(
                        "scheduler_lease_extensions_total",
                        "round transitions where a job kept its exact "
                        "worker set",
                    ).inc()
            self._current_worker_assignments = scheduled_jobs
            self._round_log.append(
                {
                    "event": "round",
                    "round": self._num_completed_rounds,
                    "time": self._current_timestamp,
                    "jobs": {
                        str(job_id): len(worker_ids)
                        for job_id, worker_ids in scheduled_jobs.items()
                    },
                }
            )
            obs.counter(
                "scheduler_rounds_total", "scheduling rounds started"
            ).inc()
            obs.histogram(
                "scheduler_round_duration_seconds",
                "round length (simulated time in sim mode)",
            ).observe(self._time_per_iteration)
            obs.gauge(
                "scheduler_queue_depth", "active (incomplete) jobs"
            ).set(len(self._jobs))
            obs.gauge(
                "scheduler_scheduled_jobs", "jobs granted workers this round"
            ).set(len(scheduled_jobs))
            obs.complete(
                f"round {self._num_completed_rounds}",
                ts_s=self._current_timestamp,
                dur_s=self._time_per_iteration,
                cat="sched",
                tid="rounds",
                args={
                    "round": self._num_completed_rounds,
                    "scheduled_jobs": len(scheduled_jobs),
                    "active_jobs": len(self._jobs),
                },
            )
            self._round_observability(
                scheduled_jobs, preempted=preempted_this_round
            )

            dispatch_preview: dict = {}
            for job_id, worker_ids in scheduled_jobs.items():
                worker_type = self._worker_id_to_worker_type[worker_ids[0]]
                all_num_steps, max_finish_time = self._get_job_steps_and_finish_times(
                    job_id, worker_type
                )
                for i, single in enumerate(job_id.singletons()):
                    # What the completion merge will take for this
                    # micro-task: its steps, and its finish less the
                    # round's start.
                    dispatch_preview[single] = (
                        all_num_steps[i],
                        max_finish_time - self._current_timestamp,
                    )
                if obs.trace_enabled():
                    run_args = {
                        "round": self._num_completed_rounds,
                        "workers": len(worker_ids),
                        "worker_type": worker_type,
                    }
                    run_root = self._job_trace_ctx.get(
                        job_id.singletons()[0]
                    )
                    if run_root is not None:
                        run_args.update(run_root.child().args())
                    obs.complete(
                        f"run job {job_id}",
                        ts_s=self._current_timestamp,
                        dur_s=max_finish_time - self._current_timestamp,
                        cat="job",
                        pid="cluster",
                        tid=f"job {job_id}",
                        args=run_args,
                    )
                heapq.heappush(
                    running_jobs,
                    (
                        -max_finish_time,
                        job_id,
                        worker_ids,
                        all_num_steps,
                        self._current_timestamp,
                    ),
                )

            self._num_completed_rounds += 1

            # Plan-ahead pipelining: with this round's execution decided,
            # solve the next round from a snapshot and the predicted
            # outcome. Inline: solver wall time never advances virtual
            # time, so the overlap is free by construction.
            if self._shockwave_can_speculate():
                outcome = self._predict_round_outcome(dispatch_preview)
                if outcome is not None:
                    self._shockwave.speculate_next_round(outcome)

        self._logger.info(
            "Total duration: %.3f seconds (%.2f hours)",
            self._current_timestamp,
            self._current_timestamp / 3600.0,
        )
        return self._current_timestamp

    # ------------------------------------------------------------------
    # Simulator checkpoints (the JAX package's scheduler.py:2483-2595).
    # ------------------------------------------------------------------
    # The JAX package's checkpoint fields that the port's scheduler has
    # (the round log, costs and timelines among them), plus its
    # allocation counters. Like the JAX package, the checkpoint
    # leaves out the worker-type shuffle's RNG: a resumed run draws that
    # stream from the seed again, as the JAX package's resumed run does.
    _CHECKPOINT_FIELDS = [
        "_current_timestamp",
        "_num_completed_rounds",
        "_job_id_counter",
        "_jobs",
        "_completed_jobs",
        "_steps_run_so_far",
        "_total_steps_run",
        "_job_time_so_far",
        "_job_cost_so_far",
        "_job_total_run_time",
        "_throughputs",
        "_original_bs",
        "_bs_scale",
        "_num_failures_per_job",
        "_per_job_start_timestamps",
        "_per_job_latest_timestamps",
        "_pool_ftf_scale",
        "_job_completion_times",
        "_num_jobs_in_trace",
        "_allocation",
        "_priorities",
        "_deficits",
        "_last_reset_time",
        "_worker_time_so_far",
        "_cumulative_worker_time_so_far",
        "_num_lease_extensions",
        "_num_lease_extension_opportunities",
        "_num_preemptions",
        "_slos",
        "_in_progress_updates",
        "_fault_tainted",
        "_job_timelines",
        "_round_log",
        "_current_worker_assignments",
        # Loop-coupled state the checkpointed running_jobs heap depends
        # on: _done_callback credits steps only to singles in
        # _running_jobs, and the allocation's dirty flag steers the first
        # round after the resume.
        "_running_jobs",
        "_need_to_update_allocation",
        # Read by _shockwave_scheduler_update on the first round after
        # the resume.
        "_current_round_scheduled_jobs",
        "num_allocations",
        "allocation_s",
    ]

    def save_checkpoint(self, path: str, extra: Optional[dict] = None) -> None:
        """Pickle the scheduler's fields, ``extra`` (the simulate loop's
        queued and running jobs) and the planner's ``state_dict``. The
        pickle holds the port's own ``Job`` and ``JobId`` types, so only
        the port reads it back; a planner's state dict alone loads in
        either package."""
        state = {f: getattr(self, f) for f in self._CHECKPOINT_FIELDS}
        shockwave_state = (
            self._shockwave.state_dict() if self._shockwave is not None
            else None
        )
        with open(path, "wb") as f:
            pickle.dump({"fields": state, "extra": extra or {},
                         "shockwave": shockwave_state}, f)

    def load_checkpoint(self, path: str) -> dict:
        """Restore the fields and the planner (its device solves on this
        scheduler's planner's device); returns the ``extra`` dict."""
        from shockwave_tpu_torch.policies.shockwave import planner_from_state

        with open(path, "rb") as f:
            state = pickle.load(f)
        for field, value in state["fields"].items():
            setattr(self, field, value)
        shockwave_state = state.get("shockwave")
        if shockwave_state is not None:
            assert self._shockwave is not None, (
                "checkpoint carries Shockwave planner state but the "
                "resuming scheduler's policy is not Shockwave"
            )
            self._shockwave = planner_from_state(
                shockwave_state, device=self._shockwave.device)
        else:
            # A Shockwave run resumed from a planner-less checkpoint would
            # drive a planner that forgot the run.
            assert self._shockwave is None, (
                "Shockwave scheduler resuming from a checkpoint without "
                "planner state"
            )
        return state["extra"]

    # ------------------------------------------------------------------
    # HA control-plane state (the JAX package's scheduler.py:2595-2757):
    # the JSON-codec counterpart of save_checkpoint, in structures the
    # flight-recorder codec round-trips exactly.
    # ------------------------------------------------------------------
    # The port's fields that the JAX package's _HA_STATE_FIELDS name (its
    # scheduler has a few more), plus the allocation counters. Sets travel
    # apart, sorted, so that restore can coerce them back from lists and a
    # capture of the restored state hashes as the original's did.
    _HA_STATE_FIELDS = [
        # clock and cursors
        "_current_timestamp", "_num_completed_rounds", "_job_id_counter",
        "_num_jobs_in_trace", "_need_to_update_allocation",
        "_last_reset_time", "_num_lease_extensions",
        "_num_lease_extension_opportunities", "_num_preemptions",
        "num_allocations", "allocation_s",
        # per-job accounting
        "_steps_run_so_far", "_total_steps_run", "_job_time_so_far",
        "_job_cost_so_far", "_job_total_run_time", "_throughputs",
        "_original_bs", "_bs_scale",
        "_num_failures_per_job", "_per_job_start_timestamps",
        "_per_job_latest_timestamps", "_pool_ftf_scale",
        "_job_completion_times", "_slos", "_in_progress_updates",
        "_job_timelines", "_round_log", "_current_worker_assignments",
        "_current_round_scheduled_jobs",
        # allocation state
        "_allocation", "_priorities", "_deficits",
        # worker registry
        "_worker_id_counter", "_worker_ids", "_worker_types",
        "_cluster_spec", "_worker_id_to_worker_type",
        "_worker_type_to_worker_ids", "_worker_start_times",
        "_cumulative_worker_time_so_far", "_worker_time_so_far",
    ]
    _HA_SET_FIELDS = (
        "_completed_jobs", "_fault_tainted", "_running_jobs",
    )
    # The seeded streams scheduling decisions draw from (the port's
    # scheduler has only the worker-type shuffle of the JAX package's
    # four); random.Random.getstate round-trips as a tuple of ints.
    _HA_RNG_FIELDS = ("_worker_type_shuffler",)

    def ha_state_dict(self) -> dict:
        """The whole control plane as codec-encodable structures: the
        fields, the sets, every job, the profiles synthesized at admission
        (not those the scheduler was built with, which a restarted
        scheduler is built with too, unlike the JAX package's capture),
        the RNG positions and the planner's state dict."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        state = {
            "schema": "shockwave-ha-state-v1",
            "fields": {
                f: getattr(self, f) for f in self._HA_STATE_FIELDS
            },
            # Sorted: a set's iteration order depends on its history of
            # adds and removals, not on its members, so the codec's list
            # of a restored set could differ from the original's.
            "sets": {f: sorted(getattr(self, f))
                     for f in self._HA_SET_FIELDS},
            "jobs": OrderedDict(
                (job_id, ha_codec.job_state(job))
                for job_id, job in self._jobs.items()
            ),
            "profiles": {j: p for j, p in self._profiles.items()
                         if j not in self._configured_profiles},
            "rng": {
                name: getattr(self, name).getstate()
                for name in self._HA_RNG_FIELDS
            },
        }
        planner_state = ha_codec.planner_state_or_none(self)
        if planner_state is not None:
            state["planner"] = planner_state
        return state

    def restore_ha_state(self, state: dict) -> None:
        """Install a decoded :meth:`ha_state_dict` on a scheduler built
        with the same policy and configuration; the planner is restored
        on this scheduler's planner's device."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        fields = state["fields"]
        for f in self._HA_STATE_FIELDS:
            if f in fields:
                setattr(self, f, fields[f])
        for f in self._HA_SET_FIELDS:
            if f in state["sets"]:
                setattr(self, f, set(state["sets"][f]))
        self._jobs = OrderedDict(
            (job_id, ha_codec.job_from_state(job_fields))
            for job_id, job_fields in state["jobs"].items()
        )
        self._profiles = {
            **{j: p for j, p in self._profiles.items()
               if j in self._configured_profiles},
            **(state.get("profiles") or {})}
        for name, rng_state in (state.get("rng") or {}).items():
            if name in self._HA_RNG_FIELDS:
                getattr(self, name).setstate(rng_state)
        planner_state = state.get("planner")
        if planner_state is not None:
            from shockwave_tpu_torch.policies.shockwave import (
                planner_from_state,
            )

            self._shockwave = planner_from_state(
                planner_state, device=self._shockwave.device)

    def _sim_scheduler_restart_roundtrip(
        self, running_jobs, queued_jobs=None
    ) -> dict:
        """A simulated ``scheduler_crash`` / ``scheduler_restart``: the
        scheduler, the planner and the loop's running and queued jobs go
        through the codec's JSON and are restored in place. Returns the
        state's hash prefix and whether a second capture hashes the
        same."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        # One encoding of the state serves its hash and its round trip.
        text = ha_codec.to_json(self.ha_state_dict())
        fp_before = ha_codec.fingerprint(text)
        loop_state = ha_codec.json_roundtrip({
            "running_jobs": [tuple(entry) for entry in running_jobs],
            "queued_jobs": (
                [
                    (arrival, ha_codec.job_state(job))
                    for arrival, job in queued_jobs
                ]
                if queued_jobs is not None
                else None
            ),
        })
        self.restore_ha_state(ha_codec.from_json(text))
        running_jobs[:] = [
            tuple(entry) for entry in loop_state["running_jobs"]
        ]
        heapq.heapify(running_jobs)
        if queued_jobs is not None:
            queued_jobs[:] = [
                (arrival, ha_codec.job_from_state(job_fields))
                for arrival, job_fields in loop_state["queued_jobs"]
            ]
        fp_after = ha_codec.state_fingerprint(self.ha_state_dict())
        return {
            "state_sha": fp_before[:16],
            "roundtrip_exact": fp_before == fp_after,
        }

    def save_round_log(self, path: str) -> None:
        """The structured event log (job / round / complete records) as
        JSON lines, for scripts/analysis/postprocess_log.py, written
        atomically."""
        from shockwave_tpu_torch.utils.fileio import atomic_write_text

        atomic_write_text(
            path,
            "".join(json.dumps(record) + "\n" for record in self._round_log),
        )

    def save_job_timelines(self, directory: str) -> None:
        """One file a job of its per-rank iterator log lines, each written
        atomically (the JAX package's scheduler.py:2773)."""
        from shockwave_tpu_torch.utils.fileio import atomic_write_text

        os.makedirs(directory, exist_ok=True)
        for job_id, timelines in self._job_timelines.items():
            atomic_write_text(
                os.path.join(directory, f"job_{job_id.integer}.log"),
                "".join(
                    f"[rank {rank}] {line}\n"
                    for rank, lines in enumerate(timelines)
                    for line in lines
                ),
            )

    # ------------------------------------------------------------------
    # Metrics.
    # ------------------------------------------------------------------
    def get_average_jct(self, job_ids=None, verbose: bool = False):
        """(reference: scheduler.py:2131-2189)"""
        if len(self._job_completion_times) == 0:
            return None
        if job_ids is None:
            job_ids = sorted(self._job_completion_times.keys())
        else:
            job_ids = sorted(job_ids)
        times = [
            self._job_completion_times[j]
            for j in job_ids
            if self._job_completion_times.get(j) is not None
        ]
        if not times:
            return None
        avg = float(np.mean(times))
        if verbose:
            print(
                "Average job completion time: %.3f seconds (%.2f hours)"
                % (avg, avg / 3600.0)
            )
        return avg

    def get_cluster_utilization(self):
        """(reference: scheduler.py:2202-2220)"""
        utilizations = []
        for worker_id, worker_time in self._cumulative_worker_time_so_far.items():
            total = self._current_timestamp - self._worker_start_times[worker_id]
            if total <= 0:
                continue
            utilization = worker_time / total
            if utilization > 1.0 and not self._job_packing:
                return None
            utilizations.append(utilization)
        if not utilizations:
            return None
        return float(np.mean(utilizations))

    def _finish_time_rho(self, job_id: JobId, jct: float):
        """rho = JCT / (isolated duration x contention factor); None when
        the job has no profile (no isolated baseline)."""
        profile = self._profiles.get(job_id.integer)
        if profile is None:
            return None
        # A job of a slower pool runs at that pool's speed, so its
        # isolated baseline takes its profile's rescale.
        isolated = sum(profile["duration_every_epoch"]) * (
            self._pool_ftf_scale.get(job_id.integer, 1.0)
        )
        if isolated <= 0:
            return None
        contention = max(
            1.0, self._num_jobs_in_trace / max(1, len(self._worker_ids))
        )
        return jct / (isolated * contention)

    def get_finish_time_fairness(self, job_ids=None):
        """rho per completed job; also the percentage of jobs with
        rho > 1.1 (reference: scheduler.py:3627-3655)."""
        if len(self._job_completion_times) == 0:
            return [], 0.0
        ftf_list = []
        for job_id in sorted(self._job_completion_times.keys()):
            if job_ids is not None and job_id not in job_ids:
                continue
            jct = self._job_completion_times[job_id]
            if jct is None:
                continue
            rho = self._finish_time_rho(job_id, jct)
            if rho is None:
                continue
            ftf_list.append(round(rho, 3))
        if not ftf_list:
            return [], 0.0
        unfair_fraction = 100.0 * sum(f > 1.1 for f in ftf_list) / len(ftf_list)
        return ftf_list, unfair_fraction

    def get_num_SLO_violations(self):
        """Jobs that finished past their absolute deadline, or never
        finished (the JAX package's scheduler.py:2902, which compares the
        absolute finish time with the deadline)."""
        violations = 0
        for job_id, deadline in (self._slos or {}).items():
            if job_id in self._jobs:
                continue  # still running: not yet decided
            finished_at = self._per_job_latest_timestamps.get(job_id)
            completed = self._job_completion_times.get(job_id) is not None
            violations += int((not completed) or finished_at > deadline)
        return violations

    def get_num_preemptions(self):
        """Round transitions where a still-active job lost its workers
        (unscheduled or moved)."""
        return self._num_preemptions

    def get_completed_steps(self, job_ids=None):
        if job_ids is None:
            job_ids = sorted(self._total_steps_run.keys())
        return {j: self._total_steps_run[j] for j in job_ids
                if j in self._total_steps_run}

    def get_num_lease_extensions(self):
        """The percentage of round transitions where a still-active job
        kept its exact worker set (reference: scheduler.py:2248-2265)."""
        if self._num_lease_extension_opportunities > 0:
            return (
                100.0
                * self._num_lease_extensions
                / self._num_lease_extension_opportunities
            )
        return 0.0

    def get_total_cost(self):
        """Dollars charged at ``per_worker_type_prices`` (0 without)."""
        return float(sum(self._job_cost_so_far.values()))
