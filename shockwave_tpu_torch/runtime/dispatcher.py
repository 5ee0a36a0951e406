"""Worker-side job dispatcher: accelerator queue, subprocess launch with
the iterator env contract, progress-log parsing, kill, Done reporting.
Reference: scheduler/runtime/rpc/dispatcher.py; the port of the JAX
package's ``runtime/dispatcher.py``.

Slots and cards: the worker's slot ``i`` runs its micro-task on card
``cards[i % len(cards)]`` (:func:`card_for_slot`), set as the payload's
``CUDA_VISIBLE_DEVICES``. With one card per slot that is the JAX
package's mapping (the slot index); with more slots than cards the slots
share them, as its TPU driver shares its one chip. Every command gets the
worker's ``--device`` (an earlier ``--device`` in the job's command is
replaced), so the payload runs where the worker was told to, and a CPU
worker hides every card from it. Optional numactl CPU pinning is applied
when available, mirroring the reference's NUMA handling
(dispatcher.py:75-120), but is a no-op otherwise.
"""

from __future__ import annotations

import logging
import os
import queue
import re
import shutil
import signal
import subprocess
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.obs import propagate

LOG = logging.getLogger("runtime.dispatcher")

_PROGRESS_RE = re.compile(r"steps=(\d+) duration=([0-9.]+)")
_DEVICE_ARG_RE = re.compile(r"\s--device(?:=|\s+)\S+")


def card_for_slot(slot: int, cards: List[int]) -> int:
    """The card slot ``slot`` runs on: ``cards[slot % len(cards)]``."""
    if not cards:
        raise ValueError("no cards to map slots onto")
    return int(cards[int(slot) % len(cards)])


class Dispatcher:
    def __init__(
        self,
        round_duration: float,
        accelerator_ids: List[int],
        worker_rpc_client,
        sched_addr: str,
        sched_port: int,
        run_dir: str,
        checkpoint_dir: str,
        use_numactl: bool = False,
        outage=None,
        device: str = "cuda",
        cards: Optional[List[int]] = None,
    ):
        self._round_duration = round_duration
        self._worker_rpc_client = worker_rpc_client
        self._sched_addr = sched_addr
        self._sched_port = sched_port
        self._run_dir = run_dir
        self._checkpoint_dir = checkpoint_dir
        self._use_numactl = use_numactl and shutil.which("numactl") is not None
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {device!r} (cuda or cpu)")
        if device == "cuda" and not cards:
            raise ValueError("a cuda dispatcher needs the cards its slots "
                             "map onto")
        self._device = device
        self._cards = list(cards or [])
        # Scheduler-outage tracker (runtime.retry.SchedulerOutage, HA
        # runs): while the scheduler is declared unreachable, Done
        # reports are BUFFERED instead of each burning its full
        # retry/backoff budget against a dead address; the worker
        # agent flushes the buffer to the successor after re-attach.
        # None (legacy single-scheduler runs) keeps the old behavior.
        self._outage = outage

        self._accelerator_queue: "queue.Queue[int]" = queue.Queue()
        for accel_id in accelerator_ids:
            self._accelerator_queue.put(accel_id)

        self._lock = sanitize.make_lock(
            "runtime.dispatcher.Dispatcher._lock"
        )
        # (job_id, worker_id) -> subprocess.Popen: one gang job can have
        # several ranks on one multi-accelerator host.
        self._procs: Dict[tuple, subprocess.Popen] = {}
        self._kill_requested: set = set()
        # Done reports awaiting a reachable scheduler, in completion
        # order: (worker_id, job_ids, steps, durations, logs, contexts).
        self._buffered_dones: "OrderedDict[int, tuple]" = OrderedDict()
        self._buffered_seq = 0
        # RunJob idempotency: the scheduler's client retries with
        # backoff, so a dispatch whose response was lost can arrive
        # twice — launching the same micro-task twice would double its
        # Done report AND its training processes. Bounded FIFO of seen
        # dispatch keys.
        self._seen_dispatches: "OrderedDict[tuple, None]" = OrderedDict()
        os.makedirs(self._run_dir, exist_ok=True)
        os.makedirs(self._checkpoint_dir, exist_ok=True)

    # -- command construction ------------------------------------------
    def _job_dirs(self, job_id: int, worker_id: int, round_id: int):
        ckpt = os.path.join(self._checkpoint_dir, f"job_id={job_id}")
        os.makedirs(ckpt, exist_ok=True)
        log = os.path.join(
            self._run_dir,
            f"job={job_id}_worker={worker_id}_round={round_id}.log",
        )
        return ckpt, log

    def _construct_command(self, job, ckpt_dir: str) -> str:
        """(reference: dispatcher.py:163-186)"""
        command = job["command"]
        if job.get("needs_data_dir") and "%s" in command:
            command = command % self._run_dir
        command = (
            f"{command} {job['num_steps_arg']} {job['num_steps']}"
            f" --checkpoint_dir {ckpt_dir}"
            " --enable_shockwave_iterator"
        )
        command = _DEVICE_ARG_RE.sub("", command) + f" --device {self._device}"
        if self._use_numactl:
            command = f"numactl --interleave=all {command}"
        return command

    # -- dispatch -------------------------------------------------------
    def dispatch_jobs(self, job_descriptions, worker_id: int, round_id: int):
        """Asynchronously run a (possibly packed) set of jobs on one free
        accelerator (reference: dispatcher.py:447-553)."""
        dispatch_key = (
            tuple(int(d["job_id"]) for d in job_descriptions),
            int(worker_id),
            int(round_id),
        )
        with self._lock:
            if dispatch_key in self._seen_dispatches:
                LOG.warning(
                    "duplicate RunJob %s dropped (client retransmit)",
                    dispatch_key,
                )
                obs.counter(
                    "worker_duplicate_dispatches_total",
                    "RunJob retransmits dropped by the dedup gate",
                ).inc()
                return
            self._seen_dispatches[dispatch_key] = None
            while len(self._seen_dispatches) > 4096:
                self._seen_dispatches.popitem(last=False)
        threading.Thread(
            target=self._dispatch_jobs_helper,
            args=(job_descriptions, worker_id, round_id),
            daemon=True,
        ).start()

    def _dispatch_jobs_helper(self, job_descriptions, worker_id, round_id):
        accel_id = self._accelerator_queue.get()
        job_ids, steps, durations, logs, contexts = [], [], [], [], []
        try:
            # A packed pair space-shares the accelerator: both processes
            # run CONCURRENTLY (reference: dispatcher.py:447-525, where
            # MPS provides the sharing; here the accelerator runtime's own
            # time-slicing does).
            results = [None] * len(job_descriptions)

            def launch(i, job):
                try:
                    results[i] = self._launch_job(
                        job, accel_id, worker_id, round_id
                    )
                except Exception:
                    # A spawn that fails outright (bad working directory,
                    # missing interpreter) must still produce a Done
                    # report: a silently dead launcher leaves the
                    # assignment outstanding forever and wedges the
                    # scheduler's round loop.
                    LOG.error(
                        "launch of job %s failed", job.get("job_id"),
                        exc_info=True,
                    )
                    results[i] = (0, 0.0, "", "")

            launchers = [
                threading.Thread(target=launch, args=(i, job), daemon=True)
                for i, job in enumerate(job_descriptions)
            ]
            for t in launchers:
                t.start()
            for t in launchers:
                t.join()
            for job, (n, d, log_text, ctx_wire) in zip(
                job_descriptions, results
            ):
                job_ids.append(job["job_id"])
                steps.append(n)
                durations.append(d)
                logs.append(log_text)
                contexts.append(ctx_wire)
        finally:
            self._accelerator_queue.put(accel_id)
        report = (worker_id, job_ids, steps, durations, logs, contexts)
        if self._outage is not None and self._outage.in_outage():
            # Scheduler declared unreachable: buffering immediately is
            # the point — the per-call retry budget must not be burned
            # against a dead address, and the report must survive to
            # reach the successor (see runtime/retry.SchedulerOutage).
            self._buffer_done(report)
            return
        try:
            # The client retries with jittered backoff and per-call
            # deadlines (runtime/retry.py), so a transient scheduler
            # stall or dropped packet costs a retry here, not the
            # round's training progress.
            self._worker_rpc_client.notify_scheduler(
                worker_id, job_ids, steps, durations, logs,
                trace_contexts=contexts,
            )
        except Exception:
            # Every retry exhausted: the scheduler may be gone for good
            # (shutdown) or mid-failover. With outage tracking armed
            # the report is buffered for the successor; without it the
            # scheduler's straggler-kill path will reconcile the
            # outstanding micro-task — either way the event is loud.
            LOG.error(
                "Done notification failed after retries (jobs %s)",
                job_ids, exc_info=True,
            )
            obs.counter(
                "worker_done_notify_giveups_total",
                "Done reports that exhausted every retry",
            ).inc()
            if self._outage is not None:
                self._buffer_done(report)

    def _buffer_done(self, report) -> None:
        with self._lock:
            self._buffered_dones[self._buffered_seq] = report
            self._buffered_seq += 1
            depth = len(self._buffered_dones)
        obs.counter(
            "worker_done_buffered_total",
            "Done reports buffered while the scheduler was unreachable",
        ).inc()
        obs.gauge(
            "worker_done_buffer_depth",
            "Done reports awaiting a reachable scheduler",
        ).set(float(depth))
        LOG.warning(
            "buffered Done report for jobs %s (scheduler unreachable; "
            "%d buffered)", report[1], depth,
        )

    def flush_buffered_dones(self) -> int:
        """Deliver every buffered Done report (oldest first) to the —
        possibly new — scheduler behind the shared RPC client. Stops at
        the first failure (the rest stay buffered for the next flush).
        Returns the number delivered. The scheduler side deduplicates
        on its outstanding-set gate, so a report that WAS delivered but
        whose ack was lost is safe to resend."""
        delivered = 0
        while True:
            with self._lock:
                if not self._buffered_dones:
                    break
                seq, report = next(iter(self._buffered_dones.items()))
            worker_id, job_ids, steps, durations, logs, contexts = report
            try:
                self._worker_rpc_client.notify_scheduler(
                    worker_id, job_ids, steps, durations, logs,
                    trace_contexts=contexts,
                )
            except Exception:
                LOG.warning(
                    "buffered Done flush stopped at jobs %s (scheduler "
                    "still unreachable)", job_ids, exc_info=True,
                )
                break
            with self._lock:
                self._buffered_dones.pop(seq, None)
                depth = len(self._buffered_dones)
            delivered += 1
            obs.gauge(
                "worker_done_buffer_depth",
                "Done reports awaiting a reachable scheduler",
            ).set(float(depth))
        return delivered

    def discard_buffered_dones(self, reason: str) -> int:
        """Drop every buffered Done report — the loud path for reports
        that can no longer be credited (the agent re-registered under
        FRESH worker ids, so the successor already fault-completed and
        requeued the old ids' micro-tasks; replaying the stale reports
        would only bounce off its dedup gate). Returns the count."""
        with self._lock:
            dropped = len(self._buffered_dones)
            self._buffered_dones.clear()
        if dropped:
            obs.counter(
                "worker_done_buffer_discarded_total",
                "buffered Done reports dropped as uncreditable after "
                "a fresh (non-reattach) re-registration",
            ).inc(dropped)
            obs.gauge(
                "worker_done_buffer_depth",
                "Done reports awaiting a reachable scheduler",
            ).set(0.0)
            LOG.warning(
                "discarded %d buffered Done report(s): %s — the "
                "successor requeued this work under our previous "
                "identity; the steps will be re-run",
                dropped, reason,
            )
        return dropped

    def outstanding_job_ids(self) -> List[int]:
        """Job ids this host still carries state for: live training
        processes plus buffered Done reports — the re-attach payload a
        successor reconciles its restored outstanding set against."""
        with self._lock:
            running = {jid for jid, _ in self._procs}
            buffered = {
                int(j)
                for report in self._buffered_dones.values()
                for j in report[1]
            }
        return sorted(running | buffered)

    def retarget_scheduler(self, sched_addr: str, sched_port: int) -> None:
        """Follow a failover: subsequently-launched training processes
        get the new leader's address in their iterator env (the shared
        RPC client was already retargeted by the worker agent)."""
        with self._lock:
            self._sched_addr = sched_addr
            self._sched_port = int(sched_port)

    def _launch_job(self, job, accel_id, worker_id, round_id):
        """Run one training subprocess to completion; returns
        (steps, duration, iterator_log_text, run_span_wire_context)
        (reference: dispatcher.py:309-445). The run span joins the
        job's cross-process causal chain as a child of the scheduler's
        dispatch span (job["trace_context"]); its own context rides the
        Done report so the scheduler's completion handling hangs under
        it."""
        job_id = int(job["job_id"])
        parent_ctx = propagate.from_wire(job.get("trace_context", ""))
        run_ctx = parent_ctx.child() if parent_ctx is not None else None
        ckpt_dir, log_file = self._job_dirs(job_id, worker_id, round_id)
        command = self._construct_command(job, ckpt_dir)
        env = dict(os.environ)
        env.update(
            {
                "SHOCKWAVE_JOB_ID": str(job_id),
                "SHOCKWAVE_WORKER_ID": str(worker_id),
                "SHOCKWAVE_ROUND_ID": str(round_id),
                "SHOCKWAVE_SCHED_ADDR": self._sched_addr,
                "SHOCKWAVE_SCHED_PORT": str(self._sched_port),
                "SHOCKWAVE_LOG_FILE": log_file,
                "SHOCKWAVE_ACCELERATOR_ID": str(accel_id),
                # The slot's card; a CPU worker's payloads see none.
                "CUDA_VISIBLE_DEVICES": (
                    str(card_for_slot(accel_id, self._cards))
                    if self._device == "cuda" else ""
                ),
            }
        )
        stdout_path = log_file + ".stdout"
        obs.counter(
            "worker_launches_total", "training subprocesses launched"
        ).inc()
        start = time.time()
        with obs.span(
            "run_job", cat="worker", pid="worker", tid=f"accel {accel_id}",
            args={"job_id": job_id, "round": round_id,
                  **propagate.ctx_args(run_ctx)},
        ):
            # Not an artifact: a live fd handed to Popen for the
            # subprocess to stream into — temp+rename atomicity is
            # meaningless for a sink that must exist before the child.
            # shockwave-lint: disable=non-atomic-artifact-write
            with open(stdout_path, "w") as out:
                proc = subprocess.Popen(
                    command,
                    shell=True,
                    cwd=job.get("working_directory") or None,
                    env=env,
                    stdout=out,
                    stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
                with self._lock:
                    self._procs[(job_id, worker_id)] = proc
                proc.wait()
        with self._lock:
            self._procs.pop((job_id, worker_id), None)
            killed = job_id in self._kill_requested
            if not any(jid == job_id for jid, _ in self._procs):
                self._kill_requested.discard(job_id)
        elapsed = time.time() - start
        obs.histogram(
            "worker_job_seconds",
            "training subprocess lifetime (launch to exit)",
        ).observe(elapsed)
        n, d, log_text = self._get_steps_and_execution_time(log_file)
        if n is None:
            if killed:
                # A preempted process that never reported progress still
                # consumed its wall-clock.
                n, d = 0, elapsed
            else:
                LOG.error(
                    "Job %d reported no progress (see %s)", job_id, stdout_path
                )
                obs.counter(
                    "worker_no_progress_total",
                    "subprocesses that exited without a parseable "
                    "progress line",
                ).inc()
                n, d = 0, 0.0
        if n is not None and d is not None and d > 0:
            # Relaunch overhead as the worker sees it: process lifetime
            # minus the useful training time the iterator reported.
            obs.histogram(
                "worker_relaunch_overhead_seconds",
                "subprocess lifetime minus reported training time",
            ).observe(max(elapsed - d, 0.0))
        return n, d, log_text, propagate.ctx_wire(run_ctx)

    def _get_steps_and_execution_time(self, log_file: str):
        """Parse the iterator's structured log
        (reference: dispatcher.py:188-213)."""
        if not os.path.exists(log_file):
            return None, None, ""
        with open(log_file) as f:
            text = f.read()
        matches = _PROGRESS_RE.findall(text)
        if not matches:
            return None, None, text
        steps, duration = matches[-1]
        return int(steps), float(duration), text

    # -- kill / lifecycle ----------------------------------------------
    def kill_job(self, job_id: int):
        """Kill every rank of ``job_id`` on this host
        (reference: dispatcher.py:215-262)."""
        job_id = int(job_id)
        with self._lock:
            procs = [p for (jid, _), p in self._procs.items() if jid == job_id]
            if procs:
                self._kill_requested.add(job_id)
                obs.counter(
                    "worker_kills_total", "kill requests that hit a live "
                    "training subprocess"
                ).inc()
        for proc in procs:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except ProcessLookupError:
                pass

    def reset(self):
        """(reference: dispatcher.py:537-545)"""
        with self._lock:
            job_ids = {jid for jid, _ in self._procs}
        for job_id in job_ids:
            self.kill_job(job_id)

    def shutdown(self):
        self.reset()
