"""Scheduler -> worker RPC client (reference:
scheduler/runtime/rpc/scheduler_client.py). Calls ride one persistent
channel per worker address (``wiring.Channel``); a worker restart costs a
reconnect on the next call, not a failure.

All methods retry with jittered exponential backoff and per-call
deadlines (:mod:`shockwave_tpu_torch.runtime.retry`); a worker that stays
unreachable past the deadline surfaces as an exception the scheduler's
dead-worker handling converts into requeue + capacity shrink rather
than a wedged round. Teardown RPCs (Reset/Shutdown) deliberately use a
single attempt: their target is usually already gone.
"""

from __future__ import annotations

from typing import Optional

from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.runtime.protobuf import common_pb2, scheduler_to_worker_pb2 as s2w_pb2
from shockwave_tpu_torch.runtime.retry import (
    PermanentRpcError,
    RetryPolicy,
    call_with_retry,
)
from shockwave_tpu_torch.runtime.rpc.wiring import (
    RpcError,
    StatusCode,
    insecure_channel,
    make_stubs,
)


class SchedulerRpcClient:
    def __init__(
        self,
        server_ip_addr: str,
        port: int,
        retry: Optional[RetryPolicy] = None,
    ):
        self._addr = f"{server_ip_addr}:{port}"
        self._retry = retry or RetryPolicy.from_env()
        self._teardown_retry = self._retry.single_shot()
        # Metrics scrapes are periodic: the next poll is the retry, and
        # a backoff pile-up behind a dead worker helps nobody.
        self._scrape_retry = self._teardown_retry
        self._stubs = make_stubs(
            insecure_channel(self._addr), "SchedulerToWorker"
        )

    def _call(self, method: str, send, policy: Optional[RetryPolicy] = None):
        def attempt(timeout):
            faults.check_rpc(method)
            try:
                result = send(self._stubs, timeout)
            except RpcError as e:
                if e.code() is StatusCode.FAILED_PRECONDITION:
                    # The worker's fenced-epoch gate: this sender's
                    # epoch is superseded and every retry would be
                    # rejected identically — surface the deposition
                    # immediately instead of burning the budget.
                    raise PermanentRpcError(
                        f"RPC {method} fenced by worker: {e.details()}"
                    ) from e
                raise
            faults.note_rpc_success(method)
            return result

        return call_with_retry(
            attempt, policy or self._retry, method=method
        )

    def run_job(
        self,
        job_descriptions,
        worker_id: int,
        round_id: int,
        sched_epoch: int = 0,
    ) -> None:
        descriptions = [
            s2w_pb2.JobDescription(
                job_id=d["job_id"],
                job_type=d["job_type"],
                command=d["command"],
                working_directory=d.get("working_directory", ""),
                needs_data_dir=d.get("needs_data_dir", False),
                num_steps_arg=d.get("num_steps_arg", "-n"),
                num_steps=d["num_steps"],
                has_duration=d.get("has_duration", False),
                duration=int(d.get("duration", 0)),
                trace_context=d.get("trace_context", ""),
            )
            for d in job_descriptions
        ]
        request = s2w_pb2.RunJobRequest(
            job_descriptions=descriptions,
            worker_id=worker_id,
            round_id=round_id,
            sched_epoch=sched_epoch,
        )
        self._call(
            "RunJob",
            lambda stubs, timeout: stubs.RunJob(request, timeout=timeout),
        )

    def kill_job(
        self, job_id: int, trace_context: str = "", sched_epoch: int = 0
    ) -> None:
        request = s2w_pb2.KillJobRequest(
            job_id=job_id, trace_context=trace_context,
            sched_epoch=sched_epoch,
        )
        self._call(
            "KillJob",
            lambda stubs, timeout: stubs.KillJob(request, timeout=timeout),
        )

    def dump_worker_metrics(self, trace_context: str = "") -> str:
        """Scrape the worker agent's metrics registry (Prometheus
        exposition text) — the fleet telemetry plane's pull
        (obs/fleet.py merges these under a worker label)."""
        from shockwave_tpu_torch.runtime.protobuf import telemetry_pb2

        request = telemetry_pb2.MetricsRequest(trace_context=trace_context)
        response = self._call(
            "DumpMetrics",
            lambda stubs, timeout: stubs.DumpMetrics(
                request, timeout=timeout
            ),
            policy=self._scrape_retry,
        )
        return response.text

    def reset(self) -> None:
        self._call(
            "Reset",
            lambda stubs, timeout: stubs.Reset(
                common_pb2.Empty(), timeout=timeout
            ),
            policy=self._teardown_retry,
        )

    def shutdown(self) -> None:
        self._call(
            "Shutdown",
            lambda stubs, timeout: stubs.Shutdown(
                common_pb2.Empty(), timeout=timeout
            ),
            policy=self._teardown_retry,
        )
