"""Training-loop instrumentation: the lease-aware data iterator.

Wraps any iterable data loader. Counts steps and wall-clock, refreshes its
lease with the scheduler at 75% consumption, and ends the micro-task by
raising StopIteration when the lease expires — the training process then
checkpoints and exits, to be resumed next round. Framework-agnostic core
with an optional gang barrier (torch.distributed) so all gang members stop
on the same step. Reference: scheduler/gavel_iterator.py; the port of the
JAX package's ``runtime/iterator.py``.

Environment contract (set by the dispatcher; reference equivalent
GAVEL_* at gavel_iterator.py:48-52, dispatcher.py:332-337):
  SHOCKWAVE_JOB_ID, SHOCKWAVE_WORKER_ID, SHOCKWAVE_ROUND_ID,
  SHOCKWAVE_SCHED_ADDR, SHOCKWAVE_SCHED_PORT, SHOCKWAVE_LOG_FILE
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Callable, Optional

from shockwave_tpu_torch.runtime.lease import INFINITY, Lease

LOG = logging.getLogger("runtime.iterator")

LEASE_UPDATE_FRACTION = 0.75


def _default_barrier() -> Optional[Callable[[], None]]:
    """A gang barrier if torch.distributed is ALREADY initialized in this
    process — never imports torch itself (initializing a backend just to
    sync a lease expiry would cost the payload its start-up)."""
    import sys

    if "torch" in sys.modules:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                return dist.barrier
        except Exception:
            # Feature probe only — torch being present but broken must
            # not kill the training process, but it IS worth a trail
            # when a gang later stops on mismatched steps.
            LOG.debug("torch.distributed barrier probe failed", exc_info=True)
    return None


class ShockwaveIterator:
    def __init__(
        self,
        data_loader,
        checkpoint_dir: str,
        load_checkpoint_func: Optional[Callable] = None,
        save_checkpoint_func: Optional[Callable] = None,
        barrier_fn: Optional[Callable[[], None]] = None,
        synthetic_data: bool = False,
    ):
        self._data_loader = data_loader
        self._checkpoint_dir = checkpoint_dir
        self._load_checkpoint_func = load_checkpoint_func
        self._save_checkpoint_func = save_checkpoint_func
        self._barrier_fn = barrier_fn
        self._synthetic_data = synthetic_data

        self._job_id = int(os.environ["SHOCKWAVE_JOB_ID"])
        self._worker_id = int(os.environ["SHOCKWAVE_WORKER_ID"])
        self._round_id = int(os.environ.get("SHOCKWAVE_ROUND_ID", 0))
        self._sched_addr = os.environ["SHOCKWAVE_SCHED_ADDR"]
        self._sched_port = int(os.environ["SHOCKWAVE_SCHED_PORT"])
        self._log_file = os.environ.get("SHOCKWAVE_LOG_FILE")

        self._steps = 0
        self._duration = 0.0
        self._done = False
        self._complete_called = False
        self._lease = Lease(0, 0.0)
        self._steps_until_next_lease_update = INFINITY
        self._next_duration_refresh = 0.0
        self._prev_time: Optional[float] = None
        self._data_iterator = iter(self._data_loader)

        from shockwave_tpu_torch.runtime.rpc.iterator_client import IteratorRpcClient

        self._client = IteratorRpcClient(
            self._job_id, self._worker_id, self._sched_addr, self._sched_port
        )
        max_steps, max_duration, extra_time = self._client.init()
        self._lease.update(max_steps, max_duration + (extra_time or 0.0))
        self._update_steps_until_next_lease_update()
        self._write_log("LEASE", "INFO",
                        f"max_steps={self._lease.max_steps} "
                        f"max_duration={self._lease.max_duration}")

    # -- iteration ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        """(reference: gavel_iterator.py:93-148)"""
        now = time.time()
        if self._prev_time is not None:
            self._duration += now - self._prev_time
        self._prev_time = now

        lease_expired = (
            self._duration >= self._lease.max_duration
            or self._steps >= self._lease.max_steps
        )
        # Refresh at LEASE_UPDATE_FRACTION consumption of either bound; the
        # duration trigger matters while max_steps is still infinite.
        refresh_due = (
            self._steps >= self._steps_until_next_lease_update
            or (
                self._duration
                >= LEASE_UPDATE_FRACTION * self._lease.max_duration
                and self._duration >= self._next_duration_refresh
            )
        )
        if not lease_expired and refresh_due:
            try:
                self._update_lease()
            # Logged to the iterator's STRUCTURED log below (this
            # process's only channel the dispatcher actually collects);
            # deliberately non-fatal — see the comment.
            # shockwave-lint: disable=swallowed-exception
            except Exception:
                # Scheduler unreachable — e.g. the control plane is mid
                # HA failover (shockwave_tpu/ha/): keep training on the
                # CURRENT lease instead of crashing the process. The
                # micro-task still ends at its existing step/duration
                # bound, the worker agent re-attaches to the successor,
                # and a control-plane blip must not forfeit a round of
                # training progress. Back the refresh triggers off so
                # the retry is next lease-fraction, not next step.
                self._write_log(
                    "LEASE", "WARNING",
                    "lease update failed (scheduler unreachable); "
                    "keeping current lease",
                )
                self._steps_until_next_lease_update = max(
                    self._steps + max(int(self._lease.max_steps * 0.1), 1),
                    self._steps_until_next_lease_update,
                )
                self._next_duration_refresh = (
                    self._duration + 0.25 * max(self._lease.max_duration, 1.0)
                )
        if lease_expired:
            self._write_log("LEASE", "INFO", "Lease expired")
            if self._barrier_fn is None:
                barrier = _default_barrier()
            else:
                barrier = self._barrier_fn
            if barrier is not None:
                barrier()
            self._done = True
            self._write_progress()
            raise StopIteration

        try:
            value = next(self._data_iterator)
        except StopIteration:
            # Epoch boundary: restart the loader transparently; total step
            # budget is enforced by the lease/num_steps, not epochs.
            self._data_iterator = iter(self._data_loader)
            value = next(self._data_iterator)
        self._steps += 1
        return value

    # -- lease maintenance ----------------------------------------------
    def _update_steps_until_next_lease_update(self):
        if self._lease.max_steps >= INFINITY:
            self._steps_until_next_lease_update = INFINITY
        else:
            self._steps_until_next_lease_update = max(
                self._steps + 1,
                int(self._lease.max_steps * LEASE_UPDATE_FRACTION),
            )

    def _update_lease(self):
        """(reference: gavel_iterator.py:199-267)"""
        max_steps, max_duration, extra_time = self._client.update_lease(
            self._steps,
            self._duration,
            self._lease.max_steps,
            self._lease.max_duration,
        )
        self._lease.update(max_steps, max_duration + (extra_time or 0.0))
        self._update_steps_until_next_lease_update()
        # Rate-limit duration-triggered refreshes: next one no sooner than
        # another quarter of the (possibly extended) lease.
        self._next_duration_refresh = (
            self._duration + 0.25 * self._lease.max_duration
        )

    # -- lifecycle ------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done

    def complete(self):
        """Mark the job's full training complete (all steps consumed)."""
        if not self._complete_called:
            self._complete_called = True
            self._done = True
            # Duration accumulates between __next__ calls, so the final
            # step's time is still unaccounted here — and for a 1-step
            # micro-task that is ALL of it: reporting duration 0 makes
            # the scheduler's merge judge the attempt failed
            # (core/scheduler.py physical-mode no-progress check).
            if self._prev_time is not None:
                self._duration += time.time() - self._prev_time
                self._prev_time = None
            self._write_log("JOB", "INFO", "complete")
            self._write_progress()

    def load_checkpoint(self, *args, **kwargs):
        if self._load_checkpoint_func is None:
            return None
        return self._load_checkpoint_func(*args, **kwargs)

    def save_checkpoint(self, *args, **kwargs):
        if self._save_checkpoint_func is None:
            return None
        return self._save_checkpoint_func(*args, **kwargs)

    # -- structured log (parsed by the dispatcher) ----------------------
    def _write_log(self, event: str, status: str, message: str):
        if not self._log_file:
            return
        ts = datetime.datetime.now().isoformat()
        with open(self._log_file, "a") as f:
            f.write(f"[{ts}] [{event}] [{status}] {message}\n")

    def _write_progress(self):
        """(reference: gavel_iterator.py:186-193; parsed by
        dispatcher._get_steps_and_execution_time)"""
        self._write_log(
            "PROGRESS", "INFO",
            f"steps={self._steps} duration={self._duration:.6f}",
        )


# Compatibility alias for readers coming from the reference.
GavelIterator = ShockwaveIterator
