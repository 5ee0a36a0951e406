"""The worker agent: registers with the scheduler, serves SchedulerToWorker,
and owns the dispatcher. Reference: scheduler/worker.py; the port of the
JAX package's ``runtime/worker.py``.

    python -m shockwave_tpu_torch.runtime.worker -t v100 -n 2 \
        -a <scheduler host> -s <scheduler port> -p <port> [--device cpu]

Each of the ``-n`` slots runs one micro-task at a time on a card: slot
``i`` gets card ``cards[i % len(cards)]`` (``--cards``, by default every
card ``torch.cuda.device_count()`` reports), so more slots than cards
share them. The agent passes its ``--device`` to every payload; started
without ``--device cpu`` on a host with no card, it raises.

With ``--ha_dir`` (or ``SHOCKWAVE_HA_DIR``), the shared directory of an
HA control plane (``python -m shockwave_tpu_torch.ha.standby``), an agent
whose scheduler went silent reads the current leader from the lease's
front-door map, retargets to it and re-registers with its previous worker
ids and the micro-tasks it still carries. Without it, the agent
re-registers at the same address (a cold restart on the same port).

Fleet observability: every register/heartbeat exchange doubles as an
NTP-style clock sample (offset of the scheduler's wall clock against
this host's), the rolling best estimate is reported back on each
heartbeat (the scheduler exports it per worker and the ``clock_skew``
watchdog rule alerts on drift) and stamped into the trace export's
clock metadata so ``scripts/analysis/merge_traces.py`` can align this
process's timeline to scheduler time. Telemetry exports flush on
SIGTERM too — a reclaimed worker must not take its whole telemetry
file with it.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import socket
import threading
import time
from typing import Optional

LOG = logging.getLogger("runtime.worker")


class _EpochWitness:
    """Highest scheduler (fencing) epoch this agent has seen on any
    RPC, guarded for the RPC handler threads and the heartbeat loop
    that both touch it."""

    def __init__(self):
        from shockwave_tpu_torch.analysis import sanitize

        self._lock = sanitize.make_lock(
            "runtime.worker._EpochWitness._lock"
        )
        self._max_epoch = 0

    def witness(self, epoch) -> int:
        """Fold one observed epoch in; returns the highest witnessed."""
        with self._lock:
            epoch = int(epoch or 0)
            if epoch > self._max_epoch:
                self._max_epoch = epoch
            return self._max_epoch

    def max_epoch(self) -> int:
        with self._lock:
            return self._max_epoch


class Worker:
    def __init__(
        self,
        worker_type: str,
        num_accelerators: int,
        sched_addr: str,
        sched_port: int,
        port: int,
        run_dir: str,
        checkpoint_dir: str,
        use_numactl: bool = False,
        heartbeat_interval_s: float = 1.0,
        ha_dir: Optional[str] = None,
        device: str = "cuda",
        cards: Optional[list] = None,
    ):
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.obs import propagate
        from shockwave_tpu_torch.obs.fleet import ClockEstimator
        from shockwave_tpu_torch.runtime.dispatcher import Dispatcher
        from shockwave_tpu_torch.runtime.retry import SchedulerOutage
        from shockwave_tpu_torch.runtime.rpc import worker_server
        from shockwave_tpu_torch.runtime.rpc.worker_client import WorkerRpcClient

        cards = resolve_cards(device, cards)
        self._worker_type = worker_type
        self._num_accelerators = int(num_accelerators)
        self._port = port
        self._rpc_client = WorkerRpcClient(sched_addr, sched_port)
        self._clock_sync = ClockEstimator()
        # The agent's own causal context: heartbeats carry it so even
        # control-plane pings are attributable to this agent's chain.
        self._agent_ctx = propagate.new_root()
        # Scheduler-outage state: consecutive heartbeat failures flip the
        # agent into outage mode — Done reports buffer, and the agent
        # hunts the front-door map (the lease record under ``ha_dir`` /
        # SHOCKWAVE_HA_DIR) for a successor to re-attach to, or without
        # one re-registers at the scheduler's address. The highest
        # scheduler epoch witnessed fences stale leaders' RPCs (0 with HA
        # off; see worker_server.fence_epoch).
        self._outage = SchedulerOutage()
        self._epoch = _EpochWitness()
        self._ha_dir = ha_dir or os.environ.get("SHOCKWAVE_HA_DIR") or None

        # Clear stale checkpoints from a previous incarnation
        # (reference: worker.py:86-93).
        if os.path.isdir(checkpoint_dir):
            for entry in os.listdir(checkpoint_dir):
                if entry.startswith("job_id="):
                    shutil.rmtree(
                        os.path.join(checkpoint_dir, entry), ignore_errors=True
                    )

        self._server = worker_server.serve(
            port,
            {
                "run_job": self._run_job_callback,
                "kill_job": self._kill_job_callback,
                "reset": self._reset_callback,
                "shutdown": self._shutdown_callback,
                "fence_epoch": self._witness_epoch,
            },
        )

        ip_addr = socket.gethostbyname(socket.gethostname())
        self._ip_addr = ip_addr
        worker_ids, round_duration, error, clock_sample, epoch, _ = (
            self._rpc_client.register_worker(
                worker_type, num_accelerators, ip_addr, port
            )
        )
        if error:
            raise RuntimeError(f"Worker registration failed: {error}")
        self._worker_ids = worker_ids
        self._round_duration = round_duration
        self._clock_sync.add(clock_sample)
        self._witness_epoch(epoch)
        if obs.trace_enabled():
            obs.get_tracer().set_meta(
                {
                    "role": "worker",
                    "worker": str(min(worker_ids)),
                    "worker_ids": list(worker_ids),
                }
            )
            self._export_clock_meta()
        self._dispatcher = Dispatcher(
            round_duration,
            list(range(num_accelerators)),
            self._rpc_client,
            sched_addr,
            sched_port,
            run_dir,
            checkpoint_dir,
            use_numactl=use_numactl,
            outage=self._outage,
            device=device,
            cards=cards,
        )
        self._shutdown_event = threading.Event()
        # Liveness heartbeats: the scheduler's lease-expiry detection
        # (core/physical.py) declares a silent worker dead, requeues its
        # jobs, and shrinks capacity. Interval <= 0 disables.
        self._heartbeat_interval = float(
            os.environ.get("SHOCKWAVE_HEARTBEAT_S", heartbeat_interval_s)
        )
        # Coalesced metrics push: when a dump is due, the next beat
        # carries the registry — a binary sketch frame
        # (Heartbeat.metrics_frame) by default, rendered text
        # (Heartbeat.metrics_text) under SHOCKWAVE_METRICS_FRAMES=0 —
        # so the fleet plane's poll for this agent becomes a no-op: one
        # RPC where the wire used to carry beat + DumpMetrics. <= 0
        # disables (pull-only, the legacy shape).
        self._metrics_push_interval = float(
            os.environ.get("SHOCKWAVE_METRICS_PUSH_S", 5.0)
        )
        self._last_metrics_push = 0.0
        if self._heartbeat_interval > 0:
            threading.Thread(
                target=self._heartbeat_loop, daemon=True
            ).start()
        LOG.info(
            "Worker registered: ids=%s round_duration=%s epoch=%s",
            worker_ids,
            round_duration,
            epoch,
        )

    def _witness_epoch(self, epoch: int) -> int:
        """Record a scheduler epoch seen on any RPC; returns the highest
        witnessed so far (the worker_server fencing gate compares an
        incoming request's epoch against this)."""
        return self._epoch.witness(epoch)

    def _export_clock_meta(self) -> None:
        """Stamp the current best clock-offset estimate into the trace
        export's clock metadata (merge_traces.py's alignment input)."""
        from shockwave_tpu_torch import obs

        best = self._clock_sync.best()
        if best is None:
            return
        obs.get_tracer().set_meta(
            {
                "clock": {
                    "offset_to_scheduler_s": best[0],
                    "offset_rtt_s": best[1],
                }
            }
        )

    def _heartbeat_loop(self):
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.obs import propagate

        while not self._shutdown_event.wait(self._heartbeat_interval):
            if self._outage.in_outage():
                # Scheduler declared dead: hunt the front-door map for
                # a successor and re-attach, carrying our previous
                # identity and in-flight micro-task state. Until that
                # succeeds, heartbeats below double as liveness probes
                # of the old address (a cold restart comes back there).
                self._try_reattach()
            best = self._clock_sync.best()
            any_ok = False
            push_text, push_frame = self._render_metrics_push()
            for index, worker_id in enumerate(self._worker_ids):
                try:
                    sample, epoch = self._rpc_client.send_heartbeat(
                        worker_id,
                        est_offset_s=best[0] if best else 0.0,
                        est_rtt_s=best[1] if best else 0.0,
                        trace_context=propagate.ctx_wire(self._agent_ctx),
                        # One dump per agent per due interval, riding
                        # the first id's beat (the fleet plane keys the
                        # whole agent on min(worker_ids)).
                        metrics_text=push_text if index == 0 else "",
                        metrics_frame=push_frame if index == 0 else b"",
                    )
                except Exception:
                    # Single-shot by policy: the next tick is the retry,
                    # and the scheduler being briefly unreachable is not
                    # this worker's emergency — until the outage
                    # tracker's threshold says it is.
                    LOG.debug("heartbeat failed", exc_info=True)
                    continue
                any_ok = True
                if index == 0 and (push_text or push_frame):
                    # Delivered: a failed beat leaves the stamp alone,
                    # so the next tick re-attaches a fresh render.
                    self._last_metrics_push = time.monotonic()
                self._witness_epoch(epoch)
                self._clock_sync.add(sample)
            if any_ok:
                self._outage.record_success()
                # Contact (re)established: deliver any Done reports
                # buffered while the scheduler was unreachable. The
                # scheduler's outstanding-set gate dedups resends.
                self._dispatcher.flush_buffered_dones()
            elif self._worker_ids:
                self._outage.record_failure()
            if obs.trace_enabled():
                self._export_clock_meta()

    def _render_metrics_push(self):
        """``(text, frame)`` for the coalesced metrics push when one is
        due, else ``("", b"")``. Due = metrics enabled, pushing enabled,
        and at least SHOCKWAVE_METRICS_PUSH_S since the last delivered
        push. By default the push is a binary sketch frame (the
        scheduler merges its histograms into exact fleet quantiles);
        SHOCKWAVE_METRICS_FRAMES=0 falls back to rendered Prometheus
        text, the PR-18 shape a legacy scheduler still understands."""
        from shockwave_tpu_torch import obs

        if self._metrics_push_interval <= 0 or not obs.metrics_enabled():
            return "", b""
        if (
            time.monotonic() - self._last_metrics_push
            < self._metrics_push_interval
        ):
            return "", b""
        if os.environ.get("SHOCKWAVE_METRICS_FRAMES", "1") != "0":
            from shockwave_tpu_torch.obs.sketch import encode_snapshot_frame

            return "", encode_snapshot_frame(obs.get_registry().snapshot())
        return obs.render_prometheus(), b""

    def _try_reattach(self) -> bool:
        """Outage recovery: resolve the current leader from the HA
        front-door map (when armed) and re-register there with our
        previous worker ids + outstanding micro-task state. Without an
        HA dir the re-register goes to the original address — the
        cold-restart case, where the successor binds the same port."""
        from shockwave_tpu_torch import obs

        if self._ha_dir:
            try:
                from shockwave_tpu_torch.ha.election import LeaseStore

                lease = LeaseStore(self._ha_dir).leader()
            except OSError:
                lease = None
            if lease is None:
                return False  # no live leader yet; keep waiting
            if lease.epoch and lease.epoch < self._epoch.max_epoch():
                return False  # a stale map read mid-flip
            if not (lease.sched_addr and lease.sched_port):
                # Elected, but its map is not published yet (it is still
                # replaying the journal, and registrations would bounce).
                return False
            self._rpc_client.retarget(lease.sched_addr, lease.sched_port)
            self._dispatcher.retarget_scheduler(
                lease.sched_addr, lease.sched_port
            )

        try:
            worker_ids, round_duration, error, sample, epoch, reattached = (
                self._rpc_client.register_worker(
                    self._worker_type,
                    self._num_accelerators,
                    self._ip_addr,
                    self._port,
                    prev_worker_ids=list(self._worker_ids),
                    outstanding_job_ids=(
                        self._dispatcher.outstanding_job_ids()
                    ),
                )
            )
        except Exception:
            LOG.debug("re-attach attempt failed", exc_info=True)
            return False
        if error:
            LOG.warning("re-attach rejected: %s", error)
            return False
        self._worker_ids = worker_ids
        self._witness_epoch(epoch)
        if sample is not None:
            self._clock_sync.add(sample)
        self._outage.record_success()
        obs.counter(
            "worker_reattach_total",
            "successful re-registrations to a successor scheduler "
            "after an outage",
        ).inc(kind="reattached" if reattached else "fresh")
        LOG.warning(
            "re-attached to scheduler %s (epoch %s, ids %s, %s)",
            self._rpc_client.addr, epoch, worker_ids,
            "previous identity re-adopted" if reattached
            else "fresh registration",
        )
        if reattached:
            delivered = self._dispatcher.flush_buffered_dones()
            if delivered:
                LOG.info(
                    "flushed %d buffered Done report(s) to the "
                    "successor", delivered,
                )
        else:
            # Fresh ids: the successor retired our previous identity
            # (outage outlasted its re-attach window) and already
            # requeued those micro-tasks as fault completions — the
            # buffered reports reference dead (key, worker) pairs its
            # dedup gate would silently swallow. Drop them LOUDLY.
            self._dispatcher.discard_buffered_dones(
                "successor issued fresh worker ids "
                f"{worker_ids} (previous identity retired)"
            )
        return True

    # -- RPC callbacks --------------------------------------------------
    def _run_job_callback(self, job_descriptions, worker_id, round_id):
        self._dispatcher.dispatch_jobs(job_descriptions, worker_id, round_id)

    def _kill_job_callback(self, job_id):
        self._dispatcher.kill_job(job_id)

    def _reset_callback(self):
        self._dispatcher.reset()

    def _shutdown_callback(self):
        self._dispatcher.shutdown()
        self._shutdown_event.set()

    def join(self):
        self._shutdown_event.wait()
        self._server.stop(grace=2)


def _export_telemetry(telemetry_out: dict) -> None:
    """Flush the env-contract telemetry exports (idempotent: atomic
    temp+rename writes, so a double flush just rewrites the file)."""
    from shockwave_tpu_torch import obs

    if telemetry_out.get("metrics"):
        obs.export_metrics(telemetry_out["metrics"])
    if telemetry_out.get("trace"):
        obs.export_trace(telemetry_out["trace"])


def resolve_cards(device: str, cards=None) -> list:
    """The card indices a worker's slots map onto: ``cards`` as given,
    else every card ``torch.cuda.device_count()`` reports; [] on the
    CPU. A cuda worker on a host with no card raises."""
    if device == "cpu":
        return []
    if device != "cuda":
        raise ValueError(f"unknown device {device!r} (cuda or cpu)")
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "the worker was started for cuda on a host with no card; "
            "start it with --device cpu to run its payloads on the CPU"
        )
    if cards is None:
        return list(range(count))
    cards = [int(c) for c in cards]
    bad = [c for c in cards if not 0 <= c < count]
    if not cards or bad:
        raise ValueError(
            f"cards {cards} are not among the host's {count} card(s)"
        )
    return cards


def main(argv=None):
    from shockwave_tpu_torch import obs

    parser = argparse.ArgumentParser(
        description="shockwave_tpu_torch worker agent"
    )
    parser.add_argument("-t", "--worker_type", type=str, required=True)
    parser.add_argument("-n", "--num_accelerators", type=int, default=1)
    parser.add_argument("-a", "--sched_addr", type=str, required=True)
    parser.add_argument("-s", "--sched_port", type=int, default=50060)
    parser.add_argument("-p", "--port", type=int, default=50061)
    parser.add_argument("--run_dir", type=str, default="/tmp/shockwave_run")
    parser.add_argument(
        "--checkpoint_dir", type=str, default="/tmp/shockwave_ckpt"
    )
    parser.add_argument("--use_numactl", action="store_true")
    parser.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="the device every payload runs on; cuda (the default) "
        "raises on a host with no card",
    )
    parser.add_argument(
        "--cards", type=str, default=None,
        help="comma-separated card indices the slots map onto (default: "
        "every card torch.cuda.device_count() reports)",
    )
    parser.add_argument(
        "--ha_dir", type=str, default=None,
        help="the HA control plane's shared directory: on a scheduler "
        "outage, re-attach to the leader its lease names (default: "
        "SHOCKWAVE_HA_DIR)",
    )
    args = parser.parse_args(argv)
    # Worker agents are subprocesses, so telemetry rides the env contract
    # (SHOCKWAVE_METRICS_OUT / SHOCKWAVE_TRACE_OUT name export paths) —
    # the physical drivers set it when their --metrics-out/--trace-out
    # flags are given; dumps land at shutdown AND on SIGTERM (a
    # reclaimed/killed agent must not lose its whole telemetry file).
    telemetry_out = obs.configure_from_env()
    worker = Worker(
        args.worker_type,
        args.num_accelerators,
        args.sched_addr,
        args.sched_port,
        args.port,
        args.run_dir,
        args.checkpoint_dir,
        use_numactl=args.use_numactl,
        ha_dir=args.ha_dir,
        device=args.device,
        cards=(
            [int(c) for c in args.cards.split(",")] if args.cards else None
        ),
    )

    def _on_sigterm(signum, frame):
        # Keep the handler minimal: flush telemetry, then take the
        # normal shutdown path (kill training processes, unblock join).
        # A second SIGTERM mid-flush falls through to the default
        # handler via the flag below.
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        try:
            _export_telemetry(telemetry_out)
        finally:
            worker._shutdown_callback()

    signal.signal(signal.SIGTERM, _on_sigterm)
    worker.join()
    _export_telemetry(telemetry_out)


if __name__ == "__main__":
    main()
