"""Physical-cluster mode: the round loop over real workers, the port of
the JAX package's ``core/physical.py`` on the port's socket transport
(``runtime/rpc/wiring.py``).

Subclasses the simulator's Scheduler for all bookkeeping (priorities,
allocation, completion merging, batch-size adaptation, Shockwave planner
hooks) and adds what only exists with real machines: worker registration,
per-round dispatch, the lease state machine (init / refresh / extension),
straggler kills, and shutdown. Reference: scheduler/scheduler.py
_schedule_with_rounds :2080-2129, _begin/_mid/_end_round :1804-2078,
lease callbacks :2942-3096, _kill_job :3098-3170.

Timing shape per round (reference: SCHEDULE_RECOMPUTE_FRACTION=0.5,
JOB_COMPLETION_BUFFER_TIME=60):
  t=0        dispatch this round's assignments (skipping gang members whose
             worker set is unchanged — their leases are extended instead)
  t=0.5R     compute NEXT round's assignment so lease-update RPCs arriving
             late in the round learn about extensions
  t=R..R+B   wait for every dispatched micro-task's Done; kill stragglers

Under a Shockwave policy with ``"speculate": true`` the next round is
solved on a background thread while the workers execute it; on a card
that thread launches on a CUDA stream of the planner's own
(``policies/speculation.py::speculation_stream``), and the boundary's
reconcile waits on the event recorded there before it reads the plan.

With ``ha_journal`` and ``ha_election`` (``shockwave_tpu_torch/ha/``,
driven by ``python -m shockwave_tpu_torch.ha.standby``) every
state-changing event appends to the write-ahead journal, the lease's
fenced epoch rides every dispatch and kill, and a successor resumes from
the journal (:meth:`PhysicalScheduler.restore_from_journal`), its planner
restored onto the device the policy was built for.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.runtime import admission
from shockwave_tpu_torch.runtime.lease import INFINITY
from shockwave_tpu_torch.runtime.retry import PermanentRpcError

LOG = logging.getLogger("core.physical")


def _clock_gauges():
    """The per-worker clock-sync gauge pair — one definition so the
    heartbeat setter and the retirement remover can never drift onto
    different series."""
    return (
        obs.gauge(
            "worker_clock_offset_seconds",
            "per-worker NTP-style clock offset vs the scheduler "
            "(worker's min-RTT estimate, heartbeat-reported)",
        ),
        obs.gauge(
            "worker_clock_rtt_seconds",
            "round-trip time of the offset estimate's best sample",
        ),
    )


SCHEDULE_RECOMPUTE_FRACTION = 0.5
LEASE_UPDATE_FRACTION = 0.75
JOB_COMPLETION_BUFFER_SECONDS = 60.0
KILL_WAIT_SECONDS = 30.0


class PhysicalScheduler(Scheduler):
    def __init__(
        self,
        policy,
        port: int = 50060,
        completion_buffer_seconds: float = JOB_COMPLETION_BUFFER_SECONDS,
        heartbeat_timeout_s: Optional[float] = None,
        metrics_port: Optional[int] = None,
        ha_journal=None,
        ha_election=None,
        ha_checkpoint_rounds: Optional[int] = None,
        ha_restore_pending: bool = False,
        **kwargs,
    ):
        # The reference's fixed 1920s reset throttle assumes 360s rounds
        # (scheduler.py:100); scale it with the round length so short-round
        # deployments do not starve late arrivals of allocation updates.
        # Computed AFTER the base init so overhead-aware round auto-sizing
        # (round_overhead_fraction) is reflected in the throttle too.
        explicit_reset = "minimum_time_between_allocation_resets" in kwargs
        if not explicit_reset:
            kwargs["minimum_time_between_allocation_resets"] = 0.0
        super().__init__(policy, simulate=False, **kwargs)
        if not explicit_reset:
            self._min_reset_interval = (
                1920.0 / 360.0
            ) * self._time_per_iteration
        self._port = port
        self._completion_buffer = completion_buffer_seconds
        self._start_time = time.time()
        if obs.trace_enabled():
            # merge_traces.py alignment anchor: this process's trace
            # clock (wall-since-start, installed by the base __init__)
            # is zero at _start_time on the wall clock; the scheduler
            # IS the fleet's reference clock (offset 0).
            obs.get_tracer().set_meta(
                {
                    "role": "scheduler",
                    "clock": {
                        "wall_at_zero_s": self._start_time,
                        "offset_to_scheduler_s": 0.0,
                    },
                }
            )

        self._lock = sanitize.make_rlock(
            "core.physical.PhysicalScheduler._lock"
        )
        self._cv = sanitize.make_condition(self._lock)
        self._worker_connections: Dict[int, object] = {}
        self._worker_addrs: Dict[int, Tuple[str, int]] = {}
        self._round_id = 0
        # Legacy static-count contract (expect_jobs): still honored for
        # in-process drivers, but the streaming front door below is the
        # serving-system path — see _stream_done for the end-of-run
        # decision.
        self._num_expected_jobs: Optional[int] = None
        self._shutdown_requested = threading.Event()

        # Streaming admission front door: a bounded queue the SubmitJobs
        # RPC (and in-process submitters) feed and the round loop drains
        # at round boundaries. Timestamps ride the scheduler clock so
        # queue-latency metrics line up with every other series. With a
        # cell-decomposed planner the queue is sharded (one slice per
        # cell, coordinator-rebalanced); priority-aware drain and
        # per-tenant quotas ride env knobs (see admission.build_queue).
        self._admission = admission.build_queue(
            capacity=int(
                os.environ.get(
                    "SHOCKWAVE_ADMISSION_QUEUE_CAP",
                    admission.DEFAULT_CAPACITY,
                )
            ),
            retry_delay_s=float(
                os.environ.get(
                    "SHOCKWAVE_ADMISSION_RETRY_S",
                    max(1.0, self._time_per_iteration / 4.0),
                )
            ),
            clock=self.get_current_timestamp,
            shards=getattr(self._shockwave, "num_cells", 1) or 1,
        )

        # Per-job runtime state.
        self._dispatch_times: Dict[JobId, float] = {}
        self._round_end_time: float = 0.0
        # Jobs whose next-round worker set is identical: lease extensions.
        self._jobs_with_extended_lease: set = set()
        self._next_assignments: "OrderedDict[JobId, tuple]" = OrderedDict()
        # Gang lease agreement: job -> (max_steps, max_duration)
        # fixed by the first member to request an update
        # (reference: scheduler.py:3067-3096).
        self._max_steps_agreement: Dict[JobId, Tuple[int, float]] = {}
        # Last lease-protocol contact per job, for unresponsiveness
        # detection of extended-lease jobs (reference: scheduler.py:
        # 3196-3202,3220-3221 — an extended job that stops requesting
        # lease updates is declared unresponsive and killed).
        self._last_lease_contact: Dict[JobId, float] = {}
        # Micro-tasks dispatched this round and not yet reported done.
        self._outstanding: set = set()
        # Dispatch-time worker sets (assignments rotate before Done arrives).
        self._dispatched_worker_ids: Dict[JobId, tuple] = {}

        # Worker liveness: heartbeat timestamps under their OWN lock so
        # the (cheap, frequent) SendHeartbeat handler never queues
        # behind the round loop's long-held condition lock. Lock order
        # is strictly _cv -> _hb_lock (the reaper reads heartbeats
        # while planning; the handler takes only _hb_lock).
        self._hb_lock = sanitize.make_lock(
            "core.physical.PhysicalScheduler._hb_lock"
        )
        self._last_heartbeat: Dict[int, float] = {}
        # Workers already retired: a merely-stalled (not dead) worker
        # keeps heartbeating after its reap, and re-admitting its id to
        # the liveness map would leak an entry that can never expire
        # away (the worker is gone from every placement structure).
        self._retired_workers: set = set()
        # A worker silent past this many seconds is declared dead: its
        # outstanding micro-tasks are requeued with fault-completions,
        # capacity shrinks, and the planner replans. Registration seeds
        # the clock (registration IS the first lease) — a worker that
        # dies before its first heartbeat must still expire, or its
        # jobs stay pinned to a dead-but-registered host forever.
        # <= 0 disables (required for heartbeat-less worker agents).
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = max(15.0, 2.5 * self._time_per_iteration)
        self._heartbeat_timeout_s = float(heartbeat_timeout_s)

        # Fleet telemetry plane: periodic DumpMetrics pulls over every
        # worker agent merged under a worker label, served (with the
        # scheduler's own series) on a stdlib-HTTP Prometheus scrape
        # endpoint plus /healthz. Enabled by the metrics_port arg or
        # SHOCKWAVE_METRICS_PORT (0 = ephemeral; read the bound port
        # back from self._fleet.port). Off = None = zero overhead.
        self._fleet = None
        # worker_id -> (agent label, agent addr): fleet scrape targets
        # are per AGENT (one RPC client per address), labeled by the
        # agent's lowest worker id.
        self._fleet_agents: Dict[int, Tuple[str, Tuple[str, int]]] = {}
        if metrics_port is None:
            env_port = os.environ.get("SHOCKWAVE_METRICS_PORT")
            metrics_port = int(env_port) if env_port not in (None, "") else None
        if metrics_port is not None:
            from shockwave_tpu_torch.obs.fleet import FleetTelemetry

            self._fleet = FleetTelemetry(
                scrape_interval_s=float(
                    os.environ.get("SHOCKWAVE_FLEET_SCRAPE_S", "5.0")
                )
            )
            self._fleet.start(http_port=int(metrics_port))

        # HA plane (shockwave_tpu_torch/ha/): when armed, every
        # state-changing event appends to the write-ahead journal and the
        # lease's fenced epoch rides every dispatch and kill (0 with HA
        # off: the workers' epoch gate passes it). Both None keeps the
        # single-scheduler behaviour at one attribute check a hook.
        self._ha_journal = ha_journal
        self._ha_election = ha_election
        self._ha_epoch = (
            int(ha_election.epoch) if ha_election is not None else 0
        )
        self._ha_deposed = False
        self._ha_replaying = False
        # Set on a successor before the journal restore runs: the server
        # is live from construction, and a worker re-attaching into the
        # empty pre-restore registry would be minted fresh ids that the
        # restore then overwrites. Registrations bounce (a transient
        # error; the agent retries next beat) until restore_from_journal
        # clears it.
        self._ha_restore_pending = bool(ha_restore_pending)
        self._ha_replay_admit_debt: Dict[str, int] = {}
        # Token of the queued submission being drained into add_job
        # (round loop only, under _cv), so the admit entry can pop the
        # matching pending entry at replay.
        self._ha_drain_token: Optional[str] = None
        # scheduler_crash event ids an earlier incarnation already took
        # (journaled before its SIGKILL): a successor must not apply
        # them to itself again.
        self._ha_consumed_sched_faults: set = set()
        if ha_checkpoint_rounds is None:
            ha_checkpoint_rounds = int(
                os.environ.get("SHOCKWAVE_HA_CHECKPOINT_ROUNDS", "1")
            )
        self._ha_checkpoint_rounds = max(1, int(ha_checkpoint_rounds))
        if ha_election is not None:
            obs.gauge(
                "ha_leader_epoch", "this process's current fenced epoch"
            ).set(float(self._ha_epoch))
            ha_election.start_renewal(on_lost=self._ha_fenced)

        from shockwave_tpu_torch.runtime.rpc import scheduler_server

        self._server = scheduler_server.serve(
            port,
            {
                "register_worker": self._register_worker_rpc,
                "done": self._done_rpc,
                "heartbeat": self._heartbeat_rpc,
                # Coalesced metrics push: a heartbeat carrying the
                # agent's rendered registry lands here and pre-empts
                # the fleet plane's next DumpMetrics poll for it.
                "worker_metrics": self._worker_metrics_rpc,
                # Binary successor: a compressed sketch-snapshot frame
                # the fleet MERGES into exact fleet-wide quantiles
                # instead of concatenating text.
                "worker_metrics_frame": self._worker_metrics_frame_rpc,
                "init_job": self._init_job_rpc,
                "update_lease": self._update_lease_rpc,
                "submit_jobs": self._submit_jobs_rpc,
                # Fencing epoch echoed on heartbeat acks so workers
                # track leadership changes passively.
                "sched_epoch": lambda: self._ha_epoch,
                # /metrics-style text dump: any client (or grpcurl-style
                # tooling speaking the hand-rolled wire contract) can
                # scrape the scheduler's live registry.
                "dump_metrics": obs.render_prometheus,
                # Market explainability: one job's decision narrative,
                # derived from the live decision log (see obs/explain).
                "explain_job": self._explain_job_rpc,
            },
        )

    # -- wall-clock timestamps (simulator uses virtual time) ------------
    def get_current_timestamp(self, in_seconds: bool = False) -> float:
        return time.time() - self._start_time

    # -- HA hooks (shockwave_tpu_torch/ha/) ------------------------------
    def _ha_log(self, kind: str, payload: dict) -> None:
        """Append one control-plane delta to the write-ahead journal.
        Nothing with HA off, nor during a replay: a replayed add_job or
        Done entering the journal again would duplicate the tail for the
        next failover (the replay ends with a compacting checkpoint
        instead). The journal serializes appends under its own lock."""
        if self._ha_journal is None or self._ha_replaying:
            return
        self._ha_journal.append(kind, payload, epoch=self._ha_epoch)

    def _ha_fenced(self) -> None:
        """Deposed: a newer epoch owns the lease. Stop dispatching
        immediately and shut down WITHOUT touching the workers — they
        belong to the successor now, and our own dispatch/kill RPCs are
        already bounced by the workers' epoch gates."""
        LOG.error(
            "deposed: leader lease lost to a newer epoch; fencing this "
            "scheduler (epoch %d)", self._ha_epoch,
        )
        obs.counter(
            "ha_deposed_total",
            "leadership terms this process lost to a newer epoch",
        ).inc()
        self._ha_deposed = True
        self.shutdown()

    def _ha_checkpoint(self) -> None:
        """Write one compacted checkpoint of the whole control plane. The
        capture, the LSN reservation and the encode run together under
        the (reentrant) lock: the reservation puts every entry logged
        under the lock strictly before or after the checkpoint, and the
        encode is the deep snapshot, since ha_state_dict returns the live
        structures. Only the JSON dump and the write run unlocked."""
        if self._ha_journal is None:
            return
        from shockwave_tpu_torch.obs.recorder import encode

        with self._cv:
            seq, lsn = self._ha_journal.begin_checkpoint()
            encoded = encode(self.ha_state_dict())
        self._ha_journal.commit_checkpoint(
            seq, lsn, encoded, epoch=self._ha_epoch
        )

    def add_job(self, job, timestamp=None):
        """In-process admission entry. The gRPC server is live from
        construction, so a worker registration or a Done report can
        interleave with a driver thread's add_job even before the
        round loop starts — the base (simulator) implementation
        mutates allocation state and must run under the lock here."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        with self._cv:
            job_id = super().add_job(job, timestamp=timestamp)
            # The payload is built only when armed.
            if self._ha_journal is not None and not self._ha_replaying:
                self._ha_log(
                    "admit",
                    {
                        "job_id": job_id.integer,
                        "job": ha_codec.job_state(job),
                        "timestamp": self._per_job_start_timestamps[
                            job_id
                        ],
                        "token": self._ha_drain_token,
                    },
                )
            self._cv.notify_all()
            return job_id

    # -- RPC callbacks --------------------------------------------------
    def _register_worker_rpc(
        self,
        worker_type,
        num_accelerators,
        ip_addr,
        port,
        prev_worker_ids=None,
        outstanding_job_ids=None,
    ):
        """(reference: scheduler.py:2854-2940). With
        ``prev_worker_ids`` (an agent re-registering after an outage),
        the agent's previous identity is re-adopted when the registry
        still carries it: connections are rebuilt onto the old worker
        ids — no capacity is minted — and in-flight micro-tasks the
        agent no longer carries are reconciled as fault completions."""
        from shockwave_tpu_torch.runtime.rpc.scheduler_client import SchedulerRpcClient

        if self._ha_restore_pending:
            # A successor still replaying its journal: admitting this
            # agent into the empty pre-restore registry would mint fresh
            # ids the restore overwrites. The agent retries next beat.
            raise RuntimeError(
                "scheduler is restoring from the HA journal; "
                "re-register after failover completes"
            )
        with self._cv:
            # Idempotency gate: registration is retried with backoff, so
            # an agent whose RegisterWorker response was lost re-sends
            # it; handing out a second set of worker ids would double
            # the agent's capacity on paper. A known address whose
            # connections are gone falls through to the re-attach path.
            existing = sorted(
                wid
                for wid, addr in self._worker_addrs.items()
                if addr == (ip_addr, port)
            )
            if existing and all(
                wid in self._worker_connections for wid in existing
            ):
                return existing, self._time_per_iteration, self._ha_epoch, False
            prev = [int(w) for w in (prev_worker_ids or [])] or existing
            known = prev and all(
                wid in self._worker_id_to_worker_type
                and wid not in self._retired_workers
                for wid in prev
            )
            if known:
                worker_ids = self._reattach_worker_locked(
                    prev, ip_addr, port, outstanding_job_ids or []
                )
                self._cv.notify_all()
                return (
                    worker_ids, self._time_per_iteration,
                    self._ha_epoch, True,
                )
            worker_ids = self.register_worker(
                worker_type, num_gpus=num_accelerators
            )
            client = SchedulerRpcClient(ip_addr, port)
            for worker_id in worker_ids:
                self._worker_connections[worker_id] = client
                self._worker_addrs[worker_id] = (ip_addr, port)
            self._add_fleet_target(worker_ids, client, ip_addr, port)
            # Registration starts the liveness lease; see
            # _heartbeat_rpc / _dead_workers. Lock order _cv -> _hb_lock.
            now = time.monotonic()
            with self._hb_lock:
                for worker_id in worker_ids:
                    self._last_heartbeat[worker_id] = now
            self._ha_log(
                "register",
                {
                    "worker_ids": list(worker_ids),
                    "worker_type": str(worker_type),
                    "num_accelerators": int(num_accelerators),
                    "ip_addr": str(ip_addr),
                    "port": int(port),
                },
            )
            self._cv.notify_all()
        return worker_ids, self._time_per_iteration, self._ha_epoch, False

    def _add_fleet_target(self, worker_ids, client, ip_addr, port) -> None:
        """Caller holds the lock (_cv). One scrape target per agent
        process, labeled by its lowest worker id (the label the merged
        fleet series carry as worker="<id>")."""
        if self._fleet is None:
            return
        label = str(min(worker_ids))
        for worker_id in worker_ids:
            self._fleet_agents[worker_id] = (label, (ip_addr, port))
        self._fleet.add_target(label, client.dump_worker_metrics)

    def _reattach_worker_locked(
        self, worker_ids, ip_addr, port, reported_job_ids
    ) -> list:
        """Caller holds the lock (_cv). Re-adopt a surviving agent
        after a failover: rebuild its connections onto its previous
        worker ids, seed its liveness lease, and reconcile the restored
        outstanding set against the micro-task state it actually still
        carries — anything the agent no longer has (its process died in
        the crash window, or its Done was lost with the old leader's
        ack) becomes a fault completion, so in-flight work is neither
        lost nor double-charged."""
        from shockwave_tpu_torch.runtime.rpc.scheduler_client import SchedulerRpcClient

        client = SchedulerRpcClient(ip_addr, port)
        for worker_id in worker_ids:
            self._worker_connections[worker_id] = client
            self._worker_addrs[worker_id] = (ip_addr, port)
        self._add_fleet_target(worker_ids, client, ip_addr, port)
        now_mono = time.monotonic()
        with self._hb_lock:
            for worker_id in worker_ids:
                self._last_heartbeat[worker_id] = now_mono
        reported = {int(j) for j in reported_job_ids}
        reconciled = self._reconcile_reattach_locked(worker_ids, reported)
        obs.counter(
            "ha_worker_reattach_total",
            "agents re-adopted onto their previous worker ids after a "
            "failover",
        ).inc()
        if reconciled:
            LOG.warning(
                "re-attach of workers %s reconciled lost in-flight "
                "micro-tasks %s as fault completions",
                worker_ids, reconciled,
            )
        self._ha_log(
            "reattach",
            {
                "worker_ids": list(worker_ids),
                "ip_addr": str(ip_addr),
                "port": int(port),
                "reported_job_ids": sorted(reported),
                "reconciled": reconciled,
            },
        )
        return list(worker_ids)

    def _reconcile_reattach_locked(self, worker_ids, reported) -> list:
        """Caller holds the lock (_cv). The ONE reconcile pass shared
        by the live re-attach handler and its WAL replay (they must
        mutate identically or a successor's replayed state diverges
        from the state the dead leader actually had): every restored
        in-flight micro-task on ``worker_ids`` that the agent no
        longer carries (not in ``reported``) died in the crash window
        — fault-complete it so the job requeues without a
        failed-attempt charge. Returns the reconciled job keys."""
        reconciled = []
        for key, wid in list(self._outstanding):
            if wid not in worker_ids:
                continue
            if any(j in reported for j in key.as_tuple()):
                continue  # still running (or buffered) on the agent
            self._outstanding.discard((key, wid))
            self._jobs_with_extended_lease.discard(key)
            zeros = [0] * len(key.singletons())
            self._done_callback(
                key, wid, zeros, [0.0] * len(key.singletons()), fault=True
            )
            reconciled.append(str(key))
        return reconciled

    def _heartbeat_rpc(
        self, worker_id, est_offset_s: float = 0.0, est_rtt_s: float = 0.0
    ) -> None:
        """Liveness ping from a worker agent; deliberately does NOT take
        the round loop's condition lock (see _hb_lock). Heartbeats also
        carry the worker's best NTP-style clock-offset estimate
        (scheduler_clock - worker_clock; est_rtt_s > 0 marks it valid),
        exported as per-worker gauges for the clock_skew watchdog rule
        and merge_traces.py."""
        with self._hb_lock:
            worker_id = int(worker_id)
            if worker_id in self._retired_workers:
                return
            self._last_heartbeat[worker_id] = time.monotonic()
            if est_rtt_s > 0:
                # Inside _hb_lock so a concurrent retirement (which
                # marks retired THEN removes these series, also under
                # _hb_lock) cannot interleave with the set and leave a
                # frozen gauge behind for a dead worker.
                offset_gauge, rtt_gauge = _clock_gauges()
                offset_gauge.set(est_offset_s, worker=str(worker_id))
                rtt_gauge.set(est_rtt_s, worker=str(worker_id))

    def _worker_metrics_rpc(self, worker_id, text: str) -> None:
        """Coalesced metrics push riding a heartbeat: store the agent's
        rendered registry under the SAME fleet label the poll path
        uses (min worker id of the agent), so the next poll tick skips
        that target — one RPC where the wire carried beat + dump."""
        with self._cv:
            fleet = self._fleet
            entry = self._fleet_agents.get(int(worker_id))
        if fleet is None or entry is None:
            return
        fleet.accept_push(entry[0], text)

    def _worker_metrics_frame_rpc(self, worker_id, frame: bytes) -> None:
        """Binary sketch-frame push riding a heartbeat. Same label
        discipline as the text path; a frame from a worker whose agent
        has already been retired resolves to no fleet entry and is
        dropped here — a dead worker cannot re-plant its series."""
        with self._cv:
            fleet = self._fleet
            entry = self._fleet_agents.get(int(worker_id))
        if fleet is None or entry is None:
            return
        fleet.accept_frame(entry[0], frame)

    def _explain_job_rpc(self, job_id):
        """ExplainJob handler: the job's decision narrative, derived
        from the live decision log via the SAME builder the offline
        scripts/analysis/explain.py uses — so the live answer equals
        the offline replay-derived one field for field. Returns None
        (-> found=false on the wire) when the decision log is off."""
        rpc_start = time.perf_counter()
        try:
            recorder = obs.get_recorder()
            if not recorder.enabled or recorder.path is None:
                return None
            from shockwave_tpu_torch.obs.explain import narrative_from_log

            # Flush so the log on disk covers every committed round up
            # to now; the builder tolerates a mid-write truncated tail.
            recorder.flush()
            return narrative_from_log(recorder.path, job_id=str(job_id))
        finally:
            self._observe_rpc("ExplainJob", rpc_start)

    def _submit_jobs_rpc(self, token, specs, close):
        """Streaming-admission handler: validate the batch, offer it to
        the bounded queue (idempotent on the token; RETRY_AFTER under
        backpressure), and wake an idle round loop. Deliberately does
        NOT take the round loop's condition lock for the queue work —
        admission must stay cheap under a submission storm; only the
        wakeup notify touches _cv."""
        rpc_start = time.perf_counter()
        try:
            return self.submit_batch(token, specs, close)
        finally:
            self._observe_rpc("SubmitJobs", rpc_start)

    def submit_batch(self, token, specs, close):
        """The one admission entry behind every front-door socket (the
        scheduler's SubmitJobs handler and each HA admission shard's):
        validate, offer to the bounded queue, journal the accepted batch,
        wake the round loop."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        # A malformed spec raises ValueError here, BEFORE anything
        # is queued — the whole batch is rejected as INVALID so a
        # token never resolves to a partial admission. Validation
        # must be at least as strict as what add_job will demand at
        # drain time: a wire-valid batch that ACCEPTED and then
        # blew up the round loop at the round boundary would kill
        # the whole cluster for one bad submitter.
        jobs = [admission.job_from_spec_dict(s) for s in specs]
        for job in jobs:
            self._validate_job_runnable(job)
        status, retry_after_s, admitted = self._admission.submit(
            token, jobs, close=close
        )
        if status == admission.STATUS_ACCEPTED:
            # Every accepted batch journals, a ledger-deduped retransmit
            # too: replay is idempotent on the token, so the duplicate
            # entry is a no-op there. The payload is built only when
            # armed.
            if self._ha_journal is not None and not self._ha_replaying:
                self._ha_log(
                    "submit",
                    {
                        "token": str(token),
                        "jobs": [ha_codec.job_state(j) for j in jobs],
                        "close": bool(close),
                    },
                )
            with self._cv:
                self._cv.notify_all()
        return status, retry_after_s, admitted, self._admission.depth()

    def _validate_job_runnable(self, job) -> None:
        """Reject (ValueError -> INVALID on the wire) any job add_job
        would choke on at drain time: the job type must parse AND the
        throughput oracle must know the (model, batch size, gang) on
        this cluster's worker types — an oracle miss inside the round
        loop would take down scheduling for every running job."""
        from shockwave_tpu_torch.data.profiles import synthesize_profile

        if self._oracle_throughputs is None:
            return
        worker_type = self._worker_types[0] if self._worker_types else "v100"
        try:
            synthesize_profile(job, self._oracle_throughputs, worker_type)
        except KeyError as e:
            raise ValueError(
                f"unrunnable job {job.job_type!r} x{job.scale_factor}: "
                f"{e.args[0] if e.args else e}"
            ) from None

    def _drain_admission_queue(self) -> int:
        """Caller holds the lock (_cv). Admit every queued submission
        into the scheduler (batched admission: one replan covers the
        whole drain). Returns the number of jobs admitted. A job that
        add_job rejects despite the front-door validation is dropped
        LOUDLY (logged, counted, recorded) — one bad job must never
        kill the round loop under every running job."""
        drained = self._admission.drain(now=self.get_current_timestamp())
        recorder = obs.get_recorder()
        admitted = 0
        for token, job, enqueued_s in drained:
            try:
                # Re-validate before add_job mutates anything: add_job
                # has no rollback, so a failure MID-insert would leave
                # a half-registered job; the validation reproduces the
                # oracle check cheaply and raises before any mutation.
                self._validate_job_runnable(job)
                # The admit entry carries the token so that replay pops
                # the matching restored pending entry. The empty string
                # is a real front-door token (the queue stores it) and
                # stays apart from None (an in-process add_job).
                self._ha_drain_token = token
                try:
                    job_id = self.add_job(job, timestamp=enqueued_s)
                finally:
                    self._ha_drain_token = None
            except Exception:
                LOG.error(
                    "admitted job %r (token %s) rejected at drain; "
                    "dropping it rather than crashing the round loop",
                    job.job_type, token, exc_info=True,
                )
                obs.counter(
                    "admission_drain_failures_total",
                    "queued jobs add_job rejected at the round "
                    "boundary (dropped, not admitted)",
                ).inc()
                if recorder.enabled:
                    recorder.record_admission(
                        {
                            "kind": "drain_failed",
                            "token": token,
                            "job_type": job.job_type,
                            "round": self._round_id,
                        }
                    )
                continue
            admitted += 1
            if recorder.enabled:
                recorder.record_admission(
                    {
                        "kind": "admitted",
                        "token": token,
                        "job_id": job_id.integer,
                        "round": self._round_id,
                        "time": self.get_current_timestamp(),
                    }
                )
        return admitted

    def expect_stream(self) -> None:
        """Declare that a streaming submitter WILL connect: the round
        loop idles on an empty job table until the stream closes,
        instead of exiting before the first SubmitJobs RPC lands (the
        startup race of any out-of-process submitter)."""
        self._admission.open()

    def close_submissions(self) -> None:
        """End-of-stream signal for in-process drivers (the RPC path
        sends close on SubmitJobs): after the queue drains and every
        admitted job completes, the round loop exits instead of idling
        for more arrivals."""
        self._admission.close()
        self._ha_log("close", {})
        with self._cv:
            self._cv.notify_all()

    def _stream_done(self) -> bool:
        """Caller holds the lock (_cv). Whether an empty job table means
        the run is over. Pending submissions always keep the loop
        alive; an open stream (any front-door submit seen, no close
        yet) idles; the legacy expected-count contract is honored for
        drivers that still use it; with neither signal, empty means
        done (the seed behavior)."""
        if self._admission.depth() > 0:
            return False
        if self._admission.closed:
            return True
        expected = self._num_expected_jobs
        if expected is not None:
            return self._num_jobs_in_trace >= expected
        return not self._admission.opened

    # -- worker death ---------------------------------------------------
    def _dead_workers(self) -> list:
        """Workers whose heartbeats expired (the lease-expiry check).
        Caller holds the lock (_cv); takes _hb_lock inside — lock order
        _cv -> _hb_lock."""
        if self._heartbeat_timeout_s <= 0:
            return []
        now = time.monotonic()
        with self._hb_lock:
            return [
                wid
                for wid, last in self._last_heartbeat.items()
                if now - last > self._heartbeat_timeout_s
                and wid in self._worker_id_to_worker_type
            ]

    def _reap_dead_workers(self) -> list:
        """Caller holds the lock (_cv). Detect heartbeat-expired workers
        and recover: requeue their outstanding micro-tasks as
        fault-completions (no failed-attempt charged to the job),
        unregister them so capacity shrinks, and flag the planner to
        replan. Returns the reaped worker ids."""
        dead = self._dead_workers()
        for worker_id in dead:
            self._retire_worker(worker_id, kind="heartbeat_expired")
        return dead

    def _retire_worker(
        self, worker_id: int, kind: str, fault_id=None
    ) -> list:
        """Caller holds the lock (_cv). The single recovery path for a
        worker that is gone — heartbeat expiry, injected crash, or spot
        reclamation: requeue its outstanding micro-tasks as
        fault-completions, unregister it, stamp the fault+recovery pair
        into the flight recorder, and force a replan onto the surviving
        fleet. Returns the requeued job keys."""
        recorder = obs.get_recorder()
        now = self.get_current_timestamp()
        requeued = []
        for key, wid in list(self._outstanding):
            if wid != worker_id:
                continue
            self._outstanding.discard((key, wid))
            self._jobs_with_extended_lease.discard(key)
            zeros = [0] * len(key.singletons())
            self._done_callback(
                key, wid, zeros, [0.0] * len(key.singletons()),
                fault=True,
            )
            requeued.append(str(key))
        LOG.warning(
            "worker %s retired (%s); requeued %s, capacity %d -> %d",
            worker_id, kind, requeued or "nothing",
            len(self._worker_ids), len(self._worker_ids) - 1,
        )
        self.remove_worker(worker_id)
        obs.counter(
            "scheduler_worker_deaths_total",
            "workers lost to crash or capacity reclamation",
        ).inc(kind=kind)
        obs.instant(
            "worker_death", cat="fault", tid="faults",
            args={"worker_id": worker_id, "kind": kind,
                  "requeued": requeued},
        )
        if recorder.enabled:
            record = {
                "kind": kind,
                "worker_id": worker_id,
                "round": self._round_id,
                "time": now,
                "requeued": requeued,
            }
            if fault_id is not None:
                record["fault_id"] = fault_id
            recorder.record_fault(record)
            recorder.record_recovery(
                {**record, "how": "requeued_and_replanned"}
            )
        if self._shockwave is not None:
            self._shockwave.set_recompute_flag()
        self._ha_log(
            "retire", {"worker_id": int(worker_id), "kind": str(kind)}
        )
        self._cv.notify_all()
        return requeued

    def _apply_physical_fault_events(self, injector) -> None:
        """Caller holds the lock (_cv). Injected worker churn against
        the LIVE cluster: a worker_crash / capacity_reclaim event
        force-retires real registered workers (best-effort Reset RPC so
        their training processes die too, mirroring a spot preemption
        notice — fired on a side thread: a blocking RPC under the
        round loop's condition lock would stall every lease renewal
        behind a black-holed host); worker_add has no physical analog
        (machines cannot be conjured) and is skipped loudly."""
        from shockwave_tpu_torch.runtime import faults as faults_mod

        for event in injector.due_cluster_events(
            self.get_current_timestamp()
        ):
            obs.counter(
                "fault_injected_total",
                "fault events delivered by the injector",
            ).inc(kind=event.kind)
            if event.kind in faults_mod.SCHEDULER_KINDS:
                self._apply_scheduler_fault(injector, event)
                continue
            if event.kind == "worker_add":
                LOG.warning(
                    "fault event %d (worker_add) skipped: physical mode "
                    "cannot conjure machines", event.event_id,
                )
                injector.mark_applied(event, skipped="no_physical_analog")
                injector.mark_recovered(
                    event.event_id, how="skipped_no_physical_analog"
                )
                continue
            victims = faults_mod.select_victims(
                injector.plan, event, self._worker_id_to_worker_type
            )
            reset_clients = [
                self._worker_connections[worker_id]
                for worker_id in victims
                if worker_id in self._worker_connections
            ]
            requeued = []
            for worker_id in victims:
                requeued.extend(
                    self._retire_worker(
                        worker_id, kind=event.kind,
                        fault_id=event.event_id,
                    )
                )
            if reset_clients:
                threading.Thread(
                    target=self._reset_reclaimed_workers,
                    args=(reset_clients,),
                    daemon=True,
                ).start()
            injector.mark_applied(
                event, workers=victims, requeued=requeued
            )
            injector.mark_recovered(
                event.event_id, how="requeued_and_replanned",
                workers=victims,
            )

    def _apply_scheduler_fault(self, injector, event) -> None:
        """Caller holds the lock (_cv). The kill-the-brain drill:
        ``scheduler_crash`` SIGKILLs THIS process at its scheduled time
        (no cleanup, no flushes beyond what is durable already: the WAL
        appends are), and the hot standby or a cold restart takes over
        through the journal. ``scheduler_restart`` has no in-process
        action in physical mode: the successor IS the restart. A
        successor whose journal shows the crash already taken (the
        ``sched_fault`` marker) records the recovery instead of killing
        itself."""
        import signal as _signal

        recorder = obs.get_recorder()
        if (
            event.kind == "scheduler_restart"
            or event.event_id in self._ha_consumed_sched_faults
        ):
            how = (
                "successor_resumed"
                if event.kind == "scheduler_crash"
                else "standby_is_the_restart"
            )
            injector.mark_applied(event, skipped=how)
            injector.mark_recovered(event.event_id, how=how)
            if recorder.enabled and event.kind == "scheduler_crash":
                recorder.record_recovery(
                    {
                        "fault_id": event.event_id,
                        "kind": event.kind,
                        "round": self._round_id,
                        "time": self.get_current_timestamp(),
                        "how": how,
                        "epoch": self._ha_epoch,
                    }
                )
            return
        LOG.error(
            "fault event %d: scheduler_crash — SIGKILLing the leader "
            "(epoch %d) now", event.event_id, self._ha_epoch,
        )
        injector.mark_applied(event, epoch=self._ha_epoch)
        if recorder.enabled:
            recorder.record_fault(
                {
                    "fault_id": event.event_id,
                    "kind": event.kind,
                    "round": self._round_id,
                    "time": self.get_current_timestamp(),
                    "epoch": self._ha_epoch,
                }
            )
            recorder.flush()
        if self._ha_journal is not None:
            # The durable marker: a successor must not apply this event
            # to itself again.
            self._ha_journal.append(
                "sched_fault", {"event_id": event.event_id},
                epoch=self._ha_epoch,
            )
        os.kill(os.getpid(), _signal.SIGKILL)

    def remove_worker(self, worker_id: int) -> None:
        """Base removal plus the physical-only maps (connections,
        addresses, heartbeats, the staged next-round plan)."""
        super().remove_worker(worker_id)
        self._worker_connections.pop(worker_id, None)
        self._worker_addrs.pop(worker_id, None)
        agent = self._fleet_agents.pop(worker_id, None)
        if agent is not None and self._fleet is not None:
            label = agent[0]
            if not any(
                lbl == label for lbl, _ in self._fleet_agents.values()
            ):
                # Last worker of the agent gone: stop scraping it.
                self._fleet.remove_target(label)
        with self._hb_lock:
            self._last_heartbeat.pop(worker_id, None)
            self._retired_workers.add(worker_id)
            # Its clock gauges go with it, removed under the SAME lock
            # the heartbeat setter holds: a retired worker must not
            # serve a frozen offset to /metrics and the clock_skew
            # rule forever, and a racing stale heartbeat must not
            # re-create the series after this removal.
            offset_gauge, rtt_gauge = _clock_gauges()
            offset_gauge.remove(worker=str(worker_id))
            rtt_gauge.remove(worker=str(worker_id))
            # Sweep every remaining worker-labeled series — counters,
            # histograms (sketch included), and exemplar details — so a
            # retired worker serves nothing frozen from any family.
            obs.remove_series(worker=str(worker_id))
        self._next_assignments = OrderedDict(
            (key, ids)
            for key, ids in self._next_assignments.items()
            if worker_id not in ids
        )

    def _observe_rpc(self, method: str, start: float) -> None:
        obs.histogram(
            "rpc_handler_seconds",
            "scheduler-side RPC handler latency (lock wait included)",
        ).observe(time.perf_counter() - start, method=method)

    def _done_rpc(
        self, worker_id, job_ids, num_steps, execution_times, logs,
        trace_contexts=None,
    ):
        """(reference: scheduler_server.py:62-95 -> _done_callback).
        ``trace_contexts`` (parallel to ``job_ids``) carries each
        micro-task's worker-side run-span context; the completion
        handling joins the job's causal chain as its child."""
        rpc_start = time.perf_counter()
        if obs.trace_enabled() and trace_contexts:
            from shockwave_tpu_torch.obs import propagate

            for job_int, wire in zip(job_ids, trace_contexts):
                run_ctx = propagate.from_wire(wire)
                if run_ctx is None:
                    continue
                obs.instant(
                    "done_report", cat="rpc", tid="jobs",
                    args={"job_id": int(job_int),
                          "worker_id": int(worker_id),
                          "trace_id": run_ctx.trace_id,
                          "parent_span_id": run_ctx.span_id},
                )
        with self._cv:
            if len(job_ids) == 1:
                key = JobId(job_ids[0])
                steps_list = [num_steps[0]]
                times_list = [execution_times[0]]
            else:
                key = JobId(job_ids[0], job_ids[1])
                steps_list = list(num_steps)
                times_list = list(execution_times)
            # Idempotency gate: clients retry Done with backoff, so a
            # report whose response was lost can arrive twice; and a
            # worker reaped/killed while its report was in flight has
            # already had a completion synthesized. Every legitimate
            # first report has an outstanding entry (dispatch adds it);
            # anything else would double-credit steps or crash on a
            # retired worker's ids.
            if (key, worker_id) not in self._outstanding:
                obs.counter(
                    "scheduler_duplicate_done_total",
                    "Done reports dropped as retransmits or "
                    "already-reconciled micro-tasks",
                ).inc()
                self._observe_rpc("Done", rpc_start)
                return
            # The progress credit must survive a crash before the next
            # checkpoint: a successor replays it through the same
            # _done_callback. Logged after the idempotency gate and
            # before the change (a crash between them means the worker's
            # retransmit applies it). The payload is built only when
            # armed.
            if self._ha_journal is not None and not self._ha_replaying:
                self._ha_log(
                    "done",
                    {
                        "job_ids": list(key.as_tuple()),
                        "worker_id": int(worker_id),
                        "steps": [int(s) for s in steps_list],
                        "times": [float(t) for t in times_list],
                    },
                )
            now = self.get_current_timestamp()
            for single, log_text in zip(key.singletons(), logs):
                if single in self._job_timelines:
                    self._job_timelines[single][0].append(log_text)
                if single in self._jobs:
                    self._per_job_latest_timestamps[single] = now
            self._outstanding.discard((key, worker_id))
            # The process exited, so any granted extension is moot: the job
            # must be re-dispatched if scheduled again.
            if not any(
                (key, wid) in self._outstanding
                for wid in self._dispatched_worker_ids.get(key, ())
            ):
                self._jobs_with_extended_lease.discard(key)
            self._done_callback(key, worker_id, steps_list, times_list)
            self._cv.notify_all()
        self._observe_rpc("Done", rpc_start)

    def _init_job_rpc(self, job_id):
        """First lease of a micro-task: run until the round ends
        (reference: scheduler.py:2942-3029)."""
        rpc_start = time.perf_counter()
        with self._cv:
            key = JobId(int(job_id))
            now = self.get_current_timestamp()
            self._dispatch_times.setdefault(key, now)
            self._last_lease_contact[key] = now
            remaining = max(self._round_end_time - now, 1.0)
            obs.instant(
                "init_job", cat="lease", tid="leases",
                args={"job_id": str(key)},
            )
            self._observe_rpc("InitJob", rpc_start)
            return INFINITY, remaining, 0.0

    def _update_lease_rpc(
        self, job_id, worker_id, steps, duration, max_steps, max_duration
    ):
        """(reference: scheduler.py:3031-3096)"""
        rpc_start = time.perf_counter()
        try:
            return self._update_lease_locked(
                job_id, worker_id, steps, duration, max_steps, max_duration
            )
        finally:
            self._observe_rpc("UpdateLease", rpc_start)

    def _update_lease_locked(
        self, job_id, worker_id, steps, duration, max_steps, max_duration
    ):
        with self._cv:
            key = JobId(int(job_id))
            self._last_lease_contact[key] = self.get_current_timestamp()
            if key in self._jobs_with_extended_lease:
                # The job keeps the same workers next round: extend through
                # the next round's end (reference: scheduler.py:1868-1891).
                extra = self._time_per_iteration
                obs.instant(
                    "lease_extended", cat="lease", tid="leases",
                    args={"job_id": str(key), "extra_s": extra},
                )
                return max_steps or INFINITY, max_duration, extra
            if steps == 0 or duration < LEASE_UPDATE_FRACTION * max_duration:
                return max_steps or INFINITY, max_duration, 0.0
            # Convert the remaining time budget into a step bound so all
            # gang members stop on the same step: first updater computes,
            # the rest adopt (reference: scheduler.py:3067-3096).
            if key not in self._max_steps_agreement:
                throughput = steps / max(duration, 1e-9)
                agreed_steps = max(
                    int(steps + throughput * max(max_duration - duration, 0.0)),
                    int(steps) + 1,
                )
                self._max_steps_agreement[key] = (agreed_steps, max_duration)
            agreed_steps, agreed_duration = self._max_steps_agreement[key]
            return agreed_steps, agreed_duration, 0.0

    # -- dispatch -------------------------------------------------------
    def _gang_port(self, job_index: int) -> int:
        """The coordinator port of a gang's attempt this round. It must
        differ across a job's attempts: a relaunch that reuses the
        previous attempt's port can meet the stale coordination service
        and fail rendezvous forever after one bad round (the reference's
        formula, shockwave_tpu/core/physical.py:1198). Unlike the
        reference, it is shifted by this scheduler's own port, which no
        other live scheduler on the host holds: with the reference's
        formula, two clusters on one host (two card-driver runs at once)
        hand the same job of the same round one coordinator, and one
        gang's ranks join the other's."""
        return 10000 + ((job_index * 131 + self._round_id + self._port)
                        % 40000)

    def _job_description(self, job, num_steps, rank, scale_factor, lead_addr):
        command = job.command
        if scale_factor > 1:
            # Gang rendezvous args, appended the way the reference appends
            # DDP args (reference: scheduler.py:1943-1950); JAX workloads
            # map them onto jax.distributed.initialize.
            command = (
                f"{command} --distributed_addr {lead_addr}"
                f" --num_workers {scale_factor} --worker_rank {rank}"
            )
        return {
            "job_id": job.job_id,
            "job_type": job.job_type,
            "command": command,
            "working_directory": job.working_directory,
            "needs_data_dir": job.needs_data_dir,
            "num_steps_arg": job.num_steps_arg,
            "num_steps": num_steps,
            "has_duration": job.duration is not None,
            "duration": job.duration or 0,
        }

    def _dispatch(self, key: JobId, worker_ids) -> None:
        """Send RunJob for every worker of a (possibly packed) assignment."""
        lead_ip, lead_port = self._worker_addrs[worker_ids[0]]
        lead_addr = f"{lead_ip}:{self._gang_port(key.as_tuple()[0])}"
        scale_factor = len(worker_ids)
        self._dispatch_times[key] = self.get_current_timestamp()
        # A new attempt's silence runs from its dispatch: the previous
        # attempt's last lease contact would have a payload whose start-up
        # outlasts the rest of the window killed as unresponsive before
        # its first lease request (the JAX package keeps the stale
        # contact; ROADMAP.md queue 3).
        self._last_lease_contact[key] = self._dispatch_times[key]
        self._dispatched_worker_ids[key] = tuple(worker_ids)
        for single in key.singletons():
            # Progress accounting in _done_callback only credits running
            # jobs (reference marks them at dispatch, scheduler.py:1935).
            self._running_jobs.add(single)
            self._per_job_latest_timestamps[single] = self.get_current_timestamp()
        # A successor must know these micro-tasks are in flight: without
        # the entry, a crash after the dispatch and before the next
        # checkpoint would leave the restored outstanding set empty, and
        # the workers' buffered Done reports would be dropped as
        # duplicates. The payload is built only when armed.
        if self._ha_journal is not None and not self._ha_replaying:
            self._ha_log(
                "dispatch",
                {
                    "job_ids": list(key.as_tuple()),
                    "worker_ids": [int(w) for w in worker_ids],
                    "round": self._round_id,
                },
            )
        # Causal chain: one dispatch span per (possibly packed) key as a
        # child of each member job's root; the RunJob descriptions carry
        # the dispatch context so the worker's run spans hang under it.
        dispatch_ctx = {}
        for single in key.singletons():
            root = self._job_trace_ctx.get(single)
            if root is not None:
                dispatch_ctx[single] = root.child()
        span_args = {"job_id": str(key), "workers": scale_factor,
                     "round": self._round_id}
        first_ctx = (
            next(iter(dispatch_ctx.values())) if dispatch_ctx else None
        )
        if first_ctx is not None:
            span_args.update(first_ctx.args())
        dispatch_start = time.perf_counter()
        with obs.span(
            "dispatch", cat="rpc", tid="dispatch", args=span_args,
        ):
            # A packed pair has one dispatch span but one context per
            # member: the span is stamped with the first member's, so
            # the other members' contexts (whose span ids the workers
            # will parent their run spans to) must be emitted as their
            # own causal nodes or those chains dangle in the merge.
            for single, ctx in dispatch_ctx.items():
                if ctx is first_ctx:
                    continue
                obs.instant(
                    "dispatch_member", cat="rpc", tid="dispatch",
                    args={"job_id": str(single), **ctx.args()},
                )
            for rank, worker_id in enumerate(worker_ids):
                descriptions = []
                for single in key.singletons():
                    job = self._jobs[single]
                    remaining = self._get_remaining_steps(single)
                    descriptions.append(
                        self._job_description(
                            job, max(remaining, 1), rank, scale_factor,
                            lead_addr
                        )
                    )
                    ctx = dispatch_ctx.get(single)
                    if ctx is not None:
                        descriptions[-1]["trace_context"] = ctx.to_wire()
                self._outstanding.add((key, worker_id))
                rpc_start = time.perf_counter()
                client = self._worker_connections.get(worker_id)
                try:
                    if client is None:
                        raise KeyError(
                            f"worker {worker_id} has no connection "
                            "(died between planning and dispatch?)"
                        )
                    # The client retries with backoff internally; an
                    # exception here means every attempt failed.
                    client.run_job(
                        descriptions, worker_id, self._round_id,
                        sched_epoch=self._ha_epoch,
                    )
                except PermanentRpcError:
                    # The worker's epoch gate bounced us: a newer
                    # leader exists and every dispatch this process
                    # sends is dead on arrival. Fence immediately —
                    # do NOT fault-complete the micro-task; it is the
                    # successor's to manage.
                    self._outstanding.discard((key, worker_id))
                    self._ha_fenced()
                    return
                except Exception:
                    # A dispatch that cannot reach its worker must not
                    # leave the micro-task outstanding (the round-end
                    # wait would burn the whole completion buffer) nor
                    # crash the round loop: synthesize a zero-progress
                    # fault completion and let heartbeat expiry decide
                    # whether the worker is actually dead.
                    LOG.warning(
                        "dispatch of job %s to worker %s failed after "
                        "retries", key, worker_id, exc_info=True,
                    )
                    obs.counter(
                        "scheduler_dispatch_failures_total",
                        "RunJob dispatches that exhausted every retry",
                    ).inc()
                    self._outstanding.discard((key, worker_id))
                    zeros = [0] * len(key.singletons())
                    self._done_callback(
                        key, worker_id, zeros,
                        [0.0] * len(key.singletons()), fault=True,
                    )
                    continue
                obs.histogram(
                    "rpc_client_seconds",
                    "scheduler-to-worker RPC round-trip latency",
                ).observe(time.perf_counter() - rpc_start, method="RunJob")
        obs.counter(
            "scheduler_dispatches_total", "micro-task dispatches (relaunches)"
        ).inc()
        obs.histogram(
            "dispatch_latency_seconds",
            "wall time to dispatch one micro-task to its full gang",
        ).observe(time.perf_counter() - dispatch_start)

    # -- the round loop -------------------------------------------------
    def wait_for_workers(self, count: int, timeout: float = 120.0) -> None:
        """Block until ``count`` workers registered. The timeout error
        lists exactly who DID register (id, type, agent address) so the
        missing worker is identifiable from the message alone — "only
        1/2 registered" with no names cost real debugging time."""
        deadline = time.time() + timeout
        with self._cv:
            while len(self._worker_ids) < count:
                remaining = deadline - time.time()
                if remaining <= 0:
                    registered = [
                        "%d (%s @ %s:%s)"
                        % (
                            wid,
                            self._worker_id_to_worker_type.get(wid, "?"),
                            *self._worker_addrs.get(wid, ("?", "?")),
                        )
                        for wid in self._worker_ids
                    ]
                    raise TimeoutError(
                        f"only {len(self._worker_ids)}/{count} workers "
                        f"registered with scheduler port {self._port} "
                        f"after {timeout:.1f}s; registered: "
                        f"[{', '.join(registered) or 'none'}] — the "
                        f"missing {count - len(self._worker_ids)} never "
                        "called RegisterWorker (check the worker agents' "
                        "logs / --sched_port wiring)"
                    )
                self._cv.wait(timeout=remaining)

    def expect_jobs(self, count: int) -> None:
        """Tell the round loop how many jobs the full trace will submit, so
        an empty job table mid-trace (an arrival gap) idles instead of
        ending the run."""
        with self._cv:
            self._num_expected_jobs = count

    def _start_ingest_thread(self):
        """Event-driven ingest: when ``SHOCKWAVE_INGEST_TICK_S`` is set
        (> 0), a daemon thread drains the admission front door on its
        own cadence instead of once per round boundary — mid-round
        arrivals enter the job table immediately and flow into the
        planner as incremental delta-replans (add_job raises the
        recompute flag; the job axis stays inside its power-of-two
        band, so a streamed arrival never recompiles), reconciling
        with speculation at the next boundary exactly like a REPAIR.
        Admission latency stops being quantized to the round length.
        Unset/0 (the default) keeps the boundary-drain path
        bit-identical to the legacy behavior. Returns the stop event,
        or None when disabled."""
        try:
            tick_s = float(
                os.environ.get("SHOCKWAVE_INGEST_TICK_S", "0") or 0
            )
        except ValueError:
            tick_s = 0.0
        if tick_s <= 0:
            return None
        stop = threading.Event()

        def loop():
            ticks = obs.counter(
                "ingest_ticks_total",
                "ingest-thread drain ticks that admitted jobs "
                "mid-round",
            )
            while not (
                stop.is_set() or self._shutdown_requested.is_set()
            ):
                stop.wait(tick_s)
                if stop.is_set() or self._shutdown_requested.is_set():
                    break
                # Same single-drainer discipline as the boundary path:
                # _drain_admission_queue requires _cv, so the round
                # loop and this thread can never interleave a drain.
                with self._cv:
                    if self._admission.depth() == 0:
                        continue
                    admitted = self._drain_admission_queue()
                    if admitted:
                        ticks.inc()
                        self._cv.notify_all()

        thread = threading.Thread(
            target=loop, name="shockwave-ingest", daemon=True
        )
        thread.start()
        return stop

    def run(self, max_rounds: Optional[int] = None) -> None:
        """Drive rounds until every added job completes
        (reference: _schedule_with_rounds scheduler.py:2080-2129)."""
        from shockwave_tpu_torch.runtime import faults

        fault_injector = faults.active()
        ingest_stop = self._start_ingest_thread()
        while not self._shutdown_requested.is_set():
            with self._cv:
                if fault_injector is not None:
                    self._apply_physical_fault_events(fault_injector)
                self._reap_dead_workers()
                # Batched admission: drain the streaming front door at
                # the round boundary, so a burst of arrivals costs one
                # replan, not one per job.
                self._drain_admission_queue()
                if len(self._jobs) == 0:
                    if self._stream_done():
                        break
                    # Arrival gap: wait for the next submission.
                    self._cv.wait(timeout=1.0)
                    continue
                if max_rounds is not None and self._round_id >= max_rounds:
                    break
                round_start = self.get_current_timestamp()
                self._round_end_time = round_start + self._time_per_iteration
                if self._shockwave is not None and self._round_id >= 1:
                    self._shockwave_scheduler_update()
                # Plan-ahead pipelining: reconcile the previous round's
                # speculative solve at the boundary, BEFORE this round's
                # speculation is kicked below (a hit installs the plan
                # window for the schedule passes; a repair arms the
                # warm-started re-solve they will run).
                if (
                    self._speculate
                    and self._shockwave is not None
                    and hasattr(self._shockwave, "reconcile_at_boundary")
                ):
                    self._shockwave.reconcile_at_boundary()
                assignments = (
                    self._next_assignments or self._schedule_jobs_on_workers()
                )
                self._next_assignments = OrderedDict()
                self._max_steps_agreement = {}
                # Extensions granted at the last mid-round stay in force
                # until the next mid-round recompute, so refreshes arriving
                # early in this round still see them (the Done handler
                # clears a job's extension the moment its process exits).
                extended = set(self._jobs_with_extended_lease)
                # Drop jobs that completed between planning and now.
                assignments = OrderedDict(
                    (key, ids)
                    for key, ids in assignments.items()
                    if all(s in self._jobs for s in key.singletons())
                )
                # Backfill workers the stale mid-round plan leaves idle.
                # The reference plans each round mid-way through the
                # previous one; with hour-long jobs a completion between
                # planning and the boundary is rare, but on fast chips
                # jobs are round-length and the lag strands a slot every
                # round (observed: a 2-slot cluster running the 12-job
                # trace one job per round). Replan and admit unassigned
                # jobs onto workers the surviving plan doesn't occupy —
                # never touching mid-round lease-extension promises
                # (extended jobs survive the filter above and keep their
                # workers via the planner's keep-previous pass).
                assigned_singles = {
                    s for key in assignments for s in key.singletons()
                }
                occupied = {
                    wid for ids in assignments.values() for wid in ids
                }
                idle = len(self._worker_ids) - len(occupied)
                # Only pay the second scheduling pass when some
                # unassigned job can actually fit the idle workers.
                min_unassigned_sf = min(
                    (
                        job.scale_factor
                        for j, job in self._jobs.items()
                        if j not in assigned_singles
                    ),
                    default=None,
                )
                # INVARIANT (this second _schedule_jobs_on_workers call
                # has side effects: it re-runs _update_priorities,
                # advances _worker_type_shuffler, and on the shockwave
                # path overwrites _current_round_scheduled_jobs /
                # may trigger a planner replan — the replan is the
                # point, it is what admits jobs the stale plan missed):
                # _current_round_scheduled_jobs overwritten here is
                # ALWAYS refreshed by the mid-round planning pass below
                # before _shockwave_scheduler_update reads it at the
                # next round boundary. The only gap — every job
                # completing mid-round so the mid-round pass is skipped
                # — leaves entries that the update routes through the
                # benign mark_complete path.
                if min_unassigned_sf is not None and min_unassigned_sf <= idle:
                    for key, ids in self._schedule_jobs_on_workers().items():
                        if key in assignments:
                            continue
                        if any(
                            s not in self._jobs or s in assigned_singles
                            for s in key.singletons()
                        ):
                            continue
                        if occupied & set(ids):
                            continue
                        assignments[key] = ids
                        assigned_singles.update(key.singletons())
                        occupied.update(ids)
                preempted_this_round = []
                for key, prev_ids in self._current_worker_assignments.items():
                    if not any(s in self._jobs for s in key.singletons()):
                        continue
                    if key not in assignments or set(
                        assignments[key]
                    ) != set(prev_ids):
                        self._num_preemptions += 1
                        preempted_this_round.append(key)
                        obs.counter(
                            "scheduler_preemptions_total",
                            "still-active jobs that lost their workers "
                            "at a round boundary",
                        ).inc()
                        obs.instant(
                            "preemption", cat="sched", tid="rounds",
                            args={"job_id": str(key)},
                        )
                self._current_worker_assignments = assignments
                self._round_log.append(
                    {
                        "event": "round",
                        "round": self._round_id,
                        "time": self.get_current_timestamp(),
                        "jobs": {
                            str(key): len(ids)
                            for key, ids in assignments.items()
                        },
                    }
                )
                obs.counter(
                    "scheduler_rounds_total", "scheduling rounds started"
                ).inc()
                # Physical rounds trace as B/E pairs emitted live (an X
                # span backdated at round end would append out of ts
                # order on the rounds track).
                obs.get_tracer().begin(
                    f"round {self._round_id}", cat="sched", tid="rounds",
                    args={
                        "round": self._round_id,
                        "scheduled_jobs": len(assignments),
                        "active_jobs": len(self._jobs),
                    },
                )
                obs.gauge(
                    "scheduler_queue_depth", "active (incomplete) jobs"
                ).set(len(self._jobs))
                obs.gauge(
                    "scheduler_scheduled_jobs",
                    "jobs granted workers this round",
                ).set(len(assignments))
                self._round_observability(
                    assignments, preempted=preempted_this_round
                )
                for key, worker_ids in assignments.items():
                    if key in extended:
                        continue  # still running under an extended lease
                    self._dispatch(key, worker_ids)
                # Plan-ahead pipelining: with this round dispatched,
                # solve the NEXT round speculatively on a background
                # thread while the workers execute — the solve bill is
                # hidden behind the round instead of landing under the
                # condition lock at the boundary / mid-round pass.
                # Snapshot+clone happens here, under _cv, so the clone
                # sees a consistent planner; the solve itself shares
                # nothing mutable with the live planner.
                if self._shockwave_can_speculate():
                    outcome = self._predict_physical_round_outcome(
                        assignments
                    )
                    if outcome is not None:
                        self._shockwave.speculate_next_round(
                            outcome, background=True
                        )

            # Mid-round: plan the next round so in-flight lease updates can
            # be extended (reference: _mid_round scheduler.py:1839-1965).
            time.sleep(self._time_per_iteration * SCHEDULE_RECOMPUTE_FRACTION)
            with self._cv:
                if len(self._jobs) > 0:
                    self._next_assignments = self._schedule_jobs_on_workers()
                    self._jobs_with_extended_lease = set()
                    for key, worker_ids in self._next_assignments.items():
                        prev = self._current_worker_assignments.get(key)
                        # Extend only if the micro-task is actually still
                        # running on the same workers — a process that
                        # already exited must be re-dispatched.
                        still_running = any(
                            (key, wid) in self._outstanding
                            for wid in worker_ids
                        )
                        if (
                            prev is not None
                            and set(prev) == set(worker_ids)
                            and still_running
                        ):
                            self._jobs_with_extended_lease.add(key)
                            self._num_lease_extensions += 1
                            obs.counter(
                                "scheduler_lease_extensions_total",
                                "round transitions where a job kept its "
                                "exact worker set",
                            ).inc()
                        self._num_lease_extension_opportunities += 1

            # End of round: wait for completions, then kill stragglers
            # (reference: _end_round :1993-2078, kill :3098-3170).
            remaining = self._round_end_time - self.get_current_timestamp()
            if remaining > 0:
                time.sleep(remaining)
            deadline = time.time() + self._completion_buffer
            with self._cv:
                expected = {
                    item
                    for item in self._outstanding
                    if item[0] not in self._jobs_with_extended_lease
                }
                while expected & self._outstanding:
                    wait = deadline - time.time()
                    if wait <= 0:
                        break
                    self._cv.wait(timeout=min(wait, 1.0))
                    # A worker dying mid-wait must clear its outstanding
                    # micro-tasks (fault-completions) instead of burning
                    # the whole completion buffer waiting for a Done
                    # report that will never come.
                    self._reap_dead_workers()
                stragglers = {
                    key for key, _ in (expected & self._outstanding)
                }
                # Extended-lease jobs that stopped speaking the lease
                # protocol are unresponsive: a healthy extended job
                # refreshes every round (75% consumption), so >1.5 rounds
                # of silence means the process is wedged (reference:
                # scheduler.py:3196-3202,3220-3221).
                now = self.get_current_timestamp()
                silence = 1.5 * self._time_per_iteration
                for key in list(self._jobs_with_extended_lease):
                    still_running = any(
                        (key, wid) in self._outstanding
                        for wid in self._dispatched_worker_ids.get(key, ())
                    )
                    last = self._last_lease_contact.get(
                        key, self._dispatch_times.get(key, now)
                    )
                    if still_running and now - last > silence:
                        stragglers.add(key)
                        self._jobs_with_extended_lease.discard(key)
            for key in stragglers:
                self._kill_job(key)
            round_wall = self.get_current_timestamp() - round_start
            obs.histogram(
                "scheduler_round_duration_seconds",
                "round length (simulated time in sim mode)",
            ).observe(round_wall)
            obs.get_tracer().end(
                f"round {self._round_id}", cat="sched", tid="rounds"
            )
            # Advance the round cursor under the lock: RPC handlers and
            # the admission drain stamp records with the current round,
            # and an unlocked increment here lets a Done/Submit racing
            # the boundary attribute work to a half-advanced round.
            with self._cv:
                self._round_id += 1
                self._num_completed_rounds += 1
                self._ha_log(
                    "round",
                    {
                        "round_id": self._round_id,
                        "completed": self._num_completed_rounds,
                    },
                )
                should_checkpoint = (
                    self._ha_journal is not None
                    and self._round_id % self._ha_checkpoint_rounds == 0
                )
            # A checkpoint every N rounds bounds a failover's replay to
            # it and one short WAL tail. Outside the boundary's lock
            # block: the capture takes _cv again briefly, but the encode
            # and the write must not stall the RPC handlers.
            if should_checkpoint:
                self._ha_checkpoint()

        if ingest_stop is not None:
            ingest_stop.set()
        self.shutdown()

    def _kill_job(self, key: JobId) -> None:
        """Kill an unresponsive micro-task and synthesize zero-progress
        completions so bookkeeping converges
        (reference: scheduler.py:3098-3170). The kill span joins the
        job's causal chain and its context rides the KillJob RPC so
        the worker's kill handling hangs under it."""
        obs.counter(
            "scheduler_kills_total", "straggler/unresponsive job kills"
        ).inc()
        kill_ctx = None
        with self._cv:
            # _remove_job pops root contexts under the condition lock;
            # this lookup must not interleave with it.
            for single in key.singletons():
                root = self._job_trace_ctx.get(single)
                if root is not None:
                    kill_ctx = root.child()
                    break
        with obs.span(
            "kill", cat="sched", tid="dispatch",
            args={"job_id": str(key),
                  **(kill_ctx.args() if kill_ctx else {})},
        ):
            self._kill_job_inner(
                key, kill_wire=kill_ctx.to_wire() if kill_ctx else ""
            )

    def _kill_job_inner(self, key: JobId, kill_wire: str = "") -> None:
        with self._cv:
            worker_ids = list(
                self._dispatched_worker_ids.get(key)
                or self._current_worker_assignments.get(key, ())
            )
            # Snapshot the connections under the lock too: the reaper
            # pops dead workers from the map concurrently, and the kill
            # RPCs below must run unlocked (a black-holed host would
            # stall every lease handler otherwise).
            clients = {
                worker_id: self._worker_connections.get(worker_id)
                for worker_id in worker_ids
            }
        for worker_id in worker_ids:
            for job_int in key.as_tuple():
                try:
                    client = clients.get(worker_id)
                    if client is None:
                        continue  # worker already retired
                    # Retried with backoff inside the client
                    # (runtime/retry.py); reaching here means every
                    # attempt failed.
                    client.kill_job(
                        job_int, trace_context=kill_wire,
                        sched_epoch=self._ha_epoch,
                    )
                except PermanentRpcError:
                    # Fenced: a newer leader owns this worker. The kill
                    # (and the job) are the successor's business now.
                    self._ha_fenced()
                    return
                except Exception:
                    # The synthesized zero-progress Done below still
                    # converges bookkeeping, but a kill RPC that cannot
                    # reach its worker even after retries is exactly how
                    # a dead host first shows up — it must be visible,
                    # not swallowed.
                    LOG.warning(
                        "kill RPC for job %s on worker %s failed after "
                        "retries", job_int, worker_id, exc_info=True,
                    )
                    obs.counter(
                        "scheduler_kill_rpc_failures_total",
                        "kill RPCs that raised instead of reaching "
                        "their worker",
                    ).inc()
        deadline = time.time() + KILL_WAIT_SECONDS
        with self._cv:
            while any(
                (key, wid) in self._outstanding for wid in worker_ids
            ):
                wait = deadline - time.time()
                if wait <= 0:
                    break
                self._cv.wait(timeout=wait)
            for worker_id in worker_ids:
                if (key, worker_id) in self._outstanding:
                    self._outstanding.discard((key, worker_id))
                    zeros = [0] * len(key.singletons())
                    self._done_callback(
                        key, worker_id, zeros, [0.0] * len(key.singletons())
                    )

    @staticmethod
    def _reset_reclaimed_workers(clients) -> None:
        """Best-effort Reset for injected reclamations, off the round
        loop's locks (the workers are already retired from every
        placement structure; this only hastens their processes' end)."""
        for client in clients:
            try:
                client.reset()
            except Exception:
                LOG.debug(
                    "reset of reclaimed worker failed (already gone)",
                    exc_info=True,
                )

    def _predict_physical_round_outcome(self, assignments):
        """Physical-mode round-outcome prediction for the speculative
        next-round solve. Unlike simulation (exact by construction),
        this is an ESTIMATE — each dispatched job is predicted to run
        measured-EMA-throughput x round-length steps — so the boundary
        reconcile's epoch tolerance absorbs benign drift (an epoch
        boundary racing the measured step count) and real churn takes
        the warm-started repair path. Jobs with no usable throughput
        estimate yet (first dispatch) are predicted as zero-progress;
        their first measurement diverging is exactly the repair case.
        Only the per-job (steps, throughput) estimate is physical-mode
        specific; the outcome itself is built by the shared
        :meth:`Scheduler._spec_outcome_from_steps`.
        """
        steps_pred: Dict[JobId, tuple] = {}
        for key, worker_ids in assignments.items():
            worker_type = self._worker_id_to_worker_type[worker_ids[0]]
            for single in key.singletons():
                job = self._jobs.get(single)
                if job is None:
                    continue
                tput = self._throughputs.get(single, {}).get(worker_type)
                if (
                    not isinstance(tput, (int, float))
                    or tput <= 0
                    or tput >= INFINITY
                ):
                    continue
                steps = min(
                    int(tput * self._time_per_iteration),
                    max(
                        0,
                        job.total_steps - self._total_steps_run[single],
                    ),
                )
                if steps > 0:
                    steps_pred[single] = (steps, float(tput))
        return self._spec_outcome_from_steps(steps_pred)

    def _micro_task_scale_factor(self, job_id) -> int:
        ids = self._dispatched_worker_ids.get(job_id)
        if ids is not None:
            return len(ids)
        return len(self._current_worker_assignments[job_id])

    # -- HA checkpoint and journal replay --------------------------------
    def ha_state_dict(self) -> dict:
        """The base snapshot plus the physical runtime's own state: the
        round cursor, the worker registry's addresses, the in-flight
        micro-tasks, the lease maps and the admission front door (token
        ledger, pending backlog, tenant quotas). Sets are listed sorted,
        as the base's are (ROADMAP.md, queue 3): a set's iteration order
        depends on its history, not on its members."""
        state = super().ha_state_dict()
        # What the JAX package's capture holds and the port's base does
        # not: its three job maps, its set of workers free to place (in
        # the physical plane, every registered one) and every profile.
        state["fields"].update(self._ha_job_maps())
        state["sets"]["_available_worker_ids"] = sorted(self._worker_ids)
        state["profiles"] = self._profiles
        state["physical"] = {
            "now": self.get_current_timestamp(),
            "round_id": self._round_id,
            # Scheduler-crash event ids any past incarnation took:
            # compaction erases the WAL markers, and a later successor
            # would otherwise apply a consumed crash to itself.
            "consumed_sched_faults": sorted(self._ha_consumed_sched_faults),
            "num_expected_jobs": self._num_expected_jobs,
            "dispatch_times": self._dispatch_times,
            "extended_leases": sorted(self._jobs_with_extended_lease),
            "next_assignments": self._next_assignments,
            "max_steps_agreement": self._max_steps_agreement,
            "last_lease_contact": self._last_lease_contact,
            "outstanding": sorted(self._outstanding),
            "dispatched_worker_ids": self._dispatched_worker_ids,
            "worker_addrs": self._worker_addrs,
            "retired_workers": sorted(self._retired_workers),
            "admission": self._admission.state_dict(),
        }
        return state

    def _ha_job_maps(self) -> dict:
        """The JAX package's three job maps that the port's scheduler
        does not keep (``_job_id_to_job_type``, ``_job_type_to_job_ids``,
        ``_job_priority_weights``), rebuilt from the round log's
        admissions and completions in their order, as that scheduler
        updates them, so that a successor of either package restores the
        other's checkpoint whole."""
        types: Dict[JobId, tuple] = {}
        by_type: Dict[tuple, set] = {}
        weights: Dict[JobId, float] = {}
        admitted: Dict[JobId, tuple] = {}
        for record in self._round_log:
            event = record.get("event")
            if event == "job":
                job_id = JobId(record["job_id"])
                key = (record["job_type"], record["scale_factor"])
                admitted[job_id] = (key, record["priority_weight"])
                types[job_id] = key
                by_type.setdefault(key, set()).add(job_id)
            elif event == "complete":
                job_id = JobId(record["job_id"])
                key, weights[job_id] = admitted[job_id]
                del types[job_id]
                by_type[key].discard(job_id)
                if self._job_packing and not by_type[key]:
                    del by_type[key]
        return {
            "_job_id_to_job_type": types,
            "_job_type_to_job_ids": {
                key: sorted(ids) for key, ids in by_type.items()
            },
            "_job_priority_weights": weights,
        }

    def restore_ha_state(self, state: dict) -> None:
        """Install a decoded snapshot into this new scheduler. Connections
        are not restored (workers re-attach with their previous identity),
        but the registry, the addresses and the in-flight micro-tasks are,
        so a re-attaching worker slots straight back in. The planner is
        restored on this scheduler's planner's device and replans."""
        super().restore_ha_state(state)
        if self._shockwave is not None:
            # A real failover: the fleet may have changed during the
            # outage, so the restored planner replans onto whatever
            # re-attaches, not with a plan made before it.
            self._shockwave.set_recompute_flag()
        p = state.get("physical") or {}
        # The clock continues across the failover: makespans span the
        # outage, and a reset clock would move every restored timestamp.
        now = float(p.get("now", self._current_timestamp))
        self._start_time = time.time() - now
        self._round_id = int(p.get("round_id", 0))
        self._num_expected_jobs = p.get("num_expected_jobs")
        self._dispatch_times = dict(p.get("dispatch_times") or {})
        self._next_assignments = OrderedDict(
            (key, tuple(ids))
            for key, ids in (p.get("next_assignments") or {}).items()
        )
        self._max_steps_agreement = dict(p.get("max_steps_agreement") or {})
        self._last_lease_contact = dict(p.get("last_lease_contact") or {})
        self._outstanding = {
            (key, int(wid)) for key, wid in (p.get("outstanding") or [])
        }
        self._dispatched_worker_ids = {
            key: tuple(int(w) for w in ids)
            for key, ids in (p.get("dispatched_worker_ids") or {}).items()
        }
        self._worker_addrs = {
            int(wid): (str(addr[0]), int(addr[1]))
            for wid, addr in (p.get("worker_addrs") or {}).items()
        }
        if "admission" in p:
            self._admission.restore_state(p["admission"])
        self._ha_consumed_sched_faults = set(
            int(e) for e in (p.get("consumed_sched_faults") or [])
        )
        with self._hb_lock:
            self._retired_workers = set(p.get("retired_workers") or [])
            # Every restored worker gets a fresh liveness lease: the
            # heartbeat timeout is the re-attach window, and a worker
            # that never comes back is reaped through the death path.
            now_mono = time.monotonic()
            for wid in self._worker_id_to_worker_type:
                self._last_heartbeat[wid] = now_mono
        # In-flight micro-tasks run on through the outage on the
        # re-attaching workers: they are extended leases, so the first
        # round after the failover does not dispatch them again, and
        # their silence is measured from the takeover, not from stamps
        # made under the dead leader's clock.
        self._jobs_with_extended_lease = set(
            p.get("extended_leases") or []
        )
        for key, _wid in self._outstanding:
            self._jobs_with_extended_lease.add(key)
            self._last_lease_contact[key] = now

    def restore_from_journal(self, snapshot) -> dict:
        """Resume from a :meth:`ControlPlaneJournal.replay` snapshot:
        install the checkpoint, apply the WAL tail in LSN order through
        the code paths the live events took, then write a compacting
        checkpoint so that the next failover replays from here and
        nothing journaled during the replay duplicates the tail. Returns
        ``{kind: count}`` of the applied entries. A failure raises: a
        successor never serves from a half-restored state."""
        applied: Dict[str, int] = {}
        self._ha_replaying = True
        # submit_batch journals its 'submit' after the queue took the
        # batch (outside the round loop's lock), so a drain racing the
        # append can journal the matching 'admit' at a lower LSN. Replay
        # counts admits whose submit it has not seen yet and drops that
        # many jobs when the late 'submit' comes.
        self._ha_replay_admit_debt = {}
        try:
            with self._cv:
                if snapshot.checkpoint is not None:
                    self.restore_ha_state(snapshot.checkpoint)
                for entry in snapshot.entries:
                    kind = entry["kind"]
                    self._ha_apply_entry(kind, entry["payload"])
                    applied[kind] = applied.get(kind, 0) + 1
        finally:
            self._ha_replaying = False
            self._ha_replay_admit_debt = {}
        recorder = obs.get_recorder()
        if recorder.enabled:
            recorder.record_recovery(
                {
                    "kind": "scheduler_failover",
                    "how": "journal_replayed",
                    "epoch": self._ha_epoch,
                    "round": self._round_id,
                    "checkpoint": snapshot.checkpoint is not None,
                    "tail_entries": len(snapshot.entries),
                }
            )
        obs.counter(
            "ha_failover_restores_total",
            "journal checkpoint+tail restores completed by a successor",
        ).inc()
        self._ha_checkpoint()
        # Registrations may flow now: the registry is the restored one.
        self._ha_restore_pending = False
        LOG.warning(
            "restored from journal: round %d, %d jobs live, %d workers "
            "registered, %d in-flight micro-tasks, tail %s",
            self._round_id, len(self._jobs),
            len(self._worker_id_to_worker_type), len(self._outstanding),
            applied or "empty",
        )
        return applied

    def _ha_apply_entry(self, kind: str, payload: dict) -> None:
        """Caller holds the lock (_cv) with the replay flag set. Apply
        one WAL delta through the live code paths."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        if kind == "register":
            # Mint the ids the dead leader handed out (LSN order walks
            # the counter the same way); connections stay empty until
            # the agent re-attaches.
            self._worker_id_counter = min(payload["worker_ids"])
            ids = self.register_worker(
                payload["worker_type"],
                num_gpus=int(payload["num_accelerators"]),
            )
            for wid in ids:
                self._worker_addrs[wid] = (
                    str(payload["ip_addr"]), int(payload["port"])
                )
            now_mono = time.monotonic()
            with self._hb_lock:
                for wid in ids:
                    self._last_heartbeat[wid] = now_mono
        elif kind == "reattach":
            # Only the reconciliation changed accounting; connections are
            # rebuilt when the agent re-attaches to this process.
            self._reconcile_reattach_locked(
                list(payload["worker_ids"]),
                {int(j) for j in payload.get("reported_job_ids", [])},
            )
        elif kind == "retire":
            wid = int(payload["worker_id"])
            if wid in self._worker_id_to_worker_type:
                self._retire_worker(wid, kind=str(payload["kind"]))
        elif kind == "submit":
            jobs = [ha_codec.job_from_state(j) for j in payload["jobs"]]
            token = str(payload["token"])
            # Jobs this token already admitted through lower-LSN 'admit'
            # entries (the append race) stay out of the backlog.
            debt = self._ha_replay_admit_debt.pop(token, 0)
            self._admission.restore_submission(
                token, jobs[debt:], close=bool(payload.get("close")),
            )
        elif kind == "close":
            self._admission.close()
        elif kind == "admit":
            token = payload.get("token")
            # None: an in-process add_job, with no queue entry to pop.
            # "": a tokenless front-door batch, whose pending entries are
            # stored under "" and must be consumed too, or the
            # successor's drain admits the job a second time.
            if token is not None:
                # The restored queue still holds this job as pending; the
                # drain consumed it before the crash. Nothing to discard
                # means the token's 'submit' has a higher LSN (the append
                # race): note the debt so its replay skips this job.
                if self._admission.discard_pending(str(token), 1) == 0:
                    self._ha_replay_admit_debt[str(token)] = (
                        self._ha_replay_admit_debt.get(str(token), 0) + 1
                    )
            self._job_id_counter = int(payload["job_id"])
            self.add_job(
                ha_codec.job_from_state(payload["job"]),
                timestamp=payload.get("timestamp"),
            )
        elif kind == "dispatch":
            key = JobId(*payload["job_ids"])
            worker_ids = tuple(int(w) for w in payload["worker_ids"])
            self._dispatched_worker_ids[key] = worker_ids
            self._dispatch_times[key] = self.get_current_timestamp()
            for wid in worker_ids:
                self._outstanding.add((key, wid))
            for single in key.singletons():
                if single in self._jobs:
                    self._running_jobs.add(single)
            # In flight across the failover: see restore_ha_state.
            self._jobs_with_extended_lease.add(key)
            self._last_lease_contact[key] = self.get_current_timestamp()
        elif kind == "done":
            key = JobId(*payload["job_ids"])
            wid = int(payload["worker_id"])
            if (key, wid) not in self._outstanding:
                return  # a retransmit journaled twice
            self._outstanding.discard((key, wid))
            if not any(
                (key, w) in self._outstanding
                for w in self._dispatched_worker_ids.get(key, ())
            ):
                self._jobs_with_extended_lease.discard(key)
            self._done_callback(
                key, wid,
                [int(s) for s in payload["steps"]],
                [float(t) for t in payload["times"]],
            )
        elif kind == "round":
            self._round_id = int(payload["round_id"])
            self._num_completed_rounds = int(
                payload.get("completed", self._num_completed_rounds)
            )
        elif kind == "sched_fault":
            self._ha_consumed_sched_faults.add(int(payload["event_id"]))
        else:
            LOG.warning("unknown WAL entry kind %r skipped", kind)

    def wait_for_reattach(self, timeout: float = 30.0) -> list:
        """After a journal restore, block until every restored worker
        re-attached (a failed heartbeat sends agents to the front-door
        map within a few beats). Workers that never come back are retired
        through the death path, their in-flight micro-tasks requeued as
        fault completions once. Returns the retired worker ids."""
        deadline = time.time() + timeout
        with self._cv:
            while True:
                missing = [
                    wid
                    for wid in self._worker_ids
                    if wid not in self._worker_connections
                ]
                if not missing or time.time() >= deadline:
                    break
                self._cv.wait(timeout=0.5)
            for wid in missing:
                LOG.warning(
                    "worker %d never re-attached after failover; "
                    "retiring it", wid,
                )
                self._retire_worker(wid, kind="failover_lost")
            return missing

    def shutdown(self) -> None:
        if self._shutdown_requested.is_set():
            return
        self._shutdown_requested.set()
        if self._fleet is not None:
            self._fleet.stop()
        if self._ha_deposed:
            # Fenced: the workers belong to the successor now — sending
            # them Shutdown would tear down the very fleet the new
            # leader is resuming. Stop our own server and go quietly;
            # the lease is already the successor's, so nothing to
            # release.
            LOG.warning(
                "deposed scheduler (epoch %d) shutting down without "
                "touching the fleet", self._ha_epoch,
            )
            if self._ha_election is not None:
                self._ha_election.stop(release=False)
            self._server.stop(grace=2)
            with self._cv:
                self._cv.notify_all()
            return
        # Snapshot under the lock: a straggling RegisterWorker or a
        # concurrent reap mutates the connection map while this
        # iterates (the shutdown RPCs themselves stay outside the lock
        # — a black-holed worker must not wedge the lease handlers).
        with self._cv:
            clients = list(self._worker_connections.values())
        seen = set()
        for client in clients:
            if id(client) in seen:
                continue
            seen.add(id(client))
            try:
                client.shutdown()
            except Exception:
                # Workers racing us to exit is normal at teardown; keep
                # it on the record at debug so a shutdown that hangs has
                # a trail, without alarming clean exits.
                LOG.debug(
                    "worker shutdown RPC failed (worker likely already "
                    "gone)", exc_info=True,
                )
        if self._ha_election is not None:
            # A clean exit hands the standby the lead at once instead of
            # making it wait out the lease's TTL.
            self._ha_election.stop(release=True)
        self._server.stop(grace=2)
