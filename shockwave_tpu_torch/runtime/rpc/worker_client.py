"""Worker -> scheduler RPC client (reference:
scheduler/runtime/rpc/worker_client.py).

Every method runs under the shared retry/backoff discipline
(:mod:`shockwave_tpu_torch.runtime.retry`): jittered exponential retries with
a per-attempt RPC deadline and an overall per-call deadline, so a
scheduler restart or a dropped packet costs a retry, not a lost Done
report. Fault injection (:mod:`shockwave_tpu_torch.runtime.faults`) hooks
each attempt when armed; both layers are no-ops by default.
"""

from __future__ import annotations

from typing import Optional

from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.runtime.protobuf import worker_to_scheduler_pb2 as w2s_pb2
from shockwave_tpu_torch.runtime.retry import RetryPolicy, call_with_retry
from shockwave_tpu_torch.runtime.rpc.wiring import insecure_channel, make_stubs


def _clock_sample(t0, t1, t2, t3):
    """Classic NTP sample from one request/response exchange: the
    worker sent at t0 (its clock), the scheduler received at t1 and
    replied at t2 (its clock), the worker got the reply at t3. Returns
    (offset_s, rtt_s) where offset = scheduler_clock - worker_clock,
    or ``None`` when the peer echoed no timestamps (legacy schema)."""
    if not t1 or not t2:
        return None
    offset = ((t1 - t0) + (t2 - t3)) / 2.0
    rtt = max((t3 - t0) - (t2 - t1), 1e-9)
    return offset, rtt


class WorkerRpcClient:
    def __init__(
        self,
        sched_ip_addr: str,
        sched_port: int,
        retry: Optional[RetryPolicy] = None,
    ):
        self._addr = f"{sched_ip_addr}:{sched_port}"
        self._retry = retry or RetryPolicy.from_env()
        # Heartbeats are periodic: the next tick is the retry, and a
        # backoff pile-up behind a dead scheduler helps nobody.
        self._heartbeat_retry = self._retry.single_shot()
        self._stubs = make_stubs(
            insecure_channel(self._addr), "WorkerToScheduler"
        )

    @property
    def addr(self) -> str:
        return self._addr

    def retarget(self, sched_ip_addr: str, sched_port: int) -> None:
        """Point every subsequent call at a different scheduler — the
        worker agent's failover move after the front-door map names a
        new leader. In-flight calls finish against the old address and
        fail into their retry discipline."""
        self._addr = f"{sched_ip_addr}:{sched_port}"
        self._stubs = make_stubs(
            insecure_channel(self._addr), "WorkerToScheduler"
        )

    def _call(self, method: str, send, policy: Optional[RetryPolicy] = None):
        """One retried unary call; ``send(stubs, timeout)`` does the
        wire work on the client's persistent channel."""

        def attempt(timeout):
            faults.check_rpc(method)
            result = send(self._stubs, timeout)
            faults.note_rpc_success(method)
            return result

        return call_with_retry(
            attempt, policy or self._retry, method=method
        )

    def register_worker(
        self,
        worker_type: str,
        num_accelerators: int,
        ip_addr: str,
        port: int,
        prev_worker_ids=None,
        outstanding_job_ids=None,
    ):
        """Returns (worker_ids, round_duration, error_message,
        clock_sample, sched_epoch, reattached) — ``clock_sample`` is
        the registration leg's NTP-style (offset_s, rtt_s) estimate of
        ``scheduler_clock - worker_clock``, or ``None`` against a
        legacy scheduler that echoes no timestamps. ``prev_worker_ids``
        / ``outstanding_job_ids`` are the HA re-attach payload (the ids
        this agent held under the previous leader and the micro-task
        job ids it still carries); ``sched_epoch`` is the answering
        leader's fencing epoch (0 = HA off) and ``reattached`` whether
        the previous identity was re-adopted."""
        import time

        t0 = time.time()
        request = w2s_pb2.RegisterWorkerRequest(
            worker_type=worker_type,
            num_accelerators=num_accelerators,
            ip_addr=ip_addr,
            port=port,
            client_send_s=t0,
            prev_worker_ids=prev_worker_ids,
            outstanding_job_ids=outstanding_job_ids,
        )
        response = self._call(
            "RegisterWorker",
            lambda stubs, timeout: stubs.RegisterWorker(
                request, timeout=timeout
            ),
        )
        t3 = time.time()
        if not response.success:
            return None, None, response.error_message, None, 0, False
        sample = _clock_sample(t0, response.sched_recv_s,
                               response.sched_send_s, t3)
        return (
            list(response.worker_ids),
            response.round_duration,
            None,
            sample,
            int(response.sched_epoch),
            bool(response.reattached),
        )

    def send_heartbeat(
        self,
        worker_id: int,
        est_offset_s: float = 0.0,
        est_rtt_s: float = 0.0,
        trace_context: str = "",
        metrics_text: str = "",
        metrics_frame: bytes = b"",
    ):
        """One liveness ping; doubles as a clock-offset exchange.
        Reports the worker's current best (offset, rtt) estimate to the
        scheduler and returns ``(clock_sample, sched_epoch)``: this
        ping's fresh (offset_s, rtt_s) sample (``None`` against a
        legacy scheduler) and the acking scheduler's fencing epoch
        (0 = HA off / legacy). ``metrics_text`` piggy-backs a rendered
        metrics dump on the beat (one RPC instead of beat + poll);
        ``metrics_frame`` is its binary successor — a compressed sketch
        snapshot the scheduler merges into fleet quantiles. A legacy
        scheduler skips either unknown field harmlessly."""
        import time

        t0 = time.time()
        response = self._call(
            "SendHeartbeat",
            lambda stubs, timeout: stubs.SendHeartbeat(
                w2s_pb2.Heartbeat(
                    worker_id=worker_id,
                    client_send_s=t0,
                    est_offset_s=est_offset_s,
                    est_rtt_s=est_rtt_s,
                    trace_context=trace_context,
                    metrics_text=metrics_text,
                    metrics_frame=metrics_frame,
                ),
                timeout=timeout,
            ),
            policy=self._heartbeat_retry,
        )
        sample = _clock_sample(
            t0, response.sched_recv_s, response.sched_send_s, time.time()
        )
        return sample, int(getattr(response, "sched_epoch", 0))

    def dump_metrics(self, trace_context: str = "") -> str:
        """Scrape the scheduler's metrics registry (Prometheus
        exposition text; the /metrics-style dump RPC)."""
        from shockwave_tpu_torch.runtime.protobuf import telemetry_pb2

        request = telemetry_pb2.MetricsRequest(trace_context=trace_context)
        response = self._call(
            "DumpMetrics",
            lambda stubs, timeout: stubs.DumpMetrics(
                request, timeout=timeout
            ),
        )
        return response.text

    def notify_scheduler(
        self, worker_id, job_ids, num_steps, execution_times, iterator_logs,
        trace_contexts=None,
    ) -> None:
        """Report completed micro-tasks (reference: worker_client.py:62-86).
        ``trace_contexts`` (parallel to ``job_ids``) carries each
        micro-task's run-span context back to the scheduler so its
        completion handling joins the job's causal chain."""
        request = w2s_pb2.DoneRequest(
            worker_id=worker_id,
            job_id=[int(j) for j in job_ids],
            num_steps=[int(s) for s in num_steps],
            execution_time=[float(t) for t in execution_times],
            iterator_log=[str(x) for x in iterator_logs],
            trace_context=[str(x) for x in (trace_contexts or [])],
        )
        self._call(
            "Done",
            lambda stubs, timeout: stubs.Done(request, timeout=timeout),
        )
