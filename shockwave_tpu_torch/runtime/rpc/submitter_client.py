"""Submitter -> scheduler RPC client: the streaming-admission front
door's network side.

Each :meth:`SubmitterClient.submit` call is one ``SubmitJobs`` RPC
under the shared retry/backoff discipline
(:mod:`shockwave_tpu_torch.runtime.retry`). Idempotency is the client's
responsibility to EXPLOIT and the server's to provide: every batch
carries a token (caller-supplied or generated once per batch), every
transport retry re-sends the SAME token, and the scheduler's admission
queue deduplicates — so a lost response can never double-admit a
batch.

Fault injection hooks both sides of the wire: ``rpc_error``/
``rpc_delay`` events fire BEFORE the send (request lost), ``rpc_drop``
AFTER it (response lost — the server processed the batch; the retry
exercises the token ledger). See runtime/faults.py.

:meth:`submit_stream` is the convenience loop a driver uses: batches a
whole trace, honors ``RETRY_AFTER`` backpressure by sleeping and
resubmitting the same token, and sends the end-of-stream close.

Columnar wire negotiation (:mod:`..protobuf.fastwire`): every request
advertises ``CAP_COLUMNAR`` while the knob ``SHOCKWAVE_WIRE_COLUMNAR``
is on (the default); the first batch of a fresh channel still rides
the legacy repeated-JobSpec encoding (it doubles as the caps probe),
and once the server echoes the bit, later batches switch to the
columnar frame — one per-batch numpy encode instead of 13 field
encoders per job. Against a legacy server the echo never comes and
every byte stays identical to the legacy wire. Retries re-encode per
attempt, so a failover to a legacy peer mid-retry falls back to the
legacy encoding with the SAME token and trace roots.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import deque
from typing import Callable, List, Optional, Sequence

LOG = logging.getLogger("runtime.submitter_client")

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.obs import propagate
from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.runtime.admission import job_to_spec_dict
from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2
from shockwave_tpu_torch.runtime.protobuf import fastwire
from shockwave_tpu_torch.runtime.retry import RetryPolicy, call_with_retry
from shockwave_tpu_torch.runtime.rpc.wiring import (
    RpcError,
    insecure_channel,
    make_stubs,
)


class SubmissionRejected(RuntimeError):
    """The scheduler refused a batch for a non-retryable reason
    (malformed spec or an internal error it reported back)."""

    def __init__(self, status: str, error: str):
        super().__init__(f"submission rejected ({status}): {error}")
        self.status = status
        self.error = error


def _tenant_batches(jobs: Sequence, batch_size: int):
    """Contiguous batches that never mix tenants, each at most
    ``batch_size`` jobs. Quota rejection is batch-granular (the token
    ledger is), so a mixed batch would let one over-quota tenant shed
    compliant tenants' jobs along with its own."""
    batch: list = []
    tenant: Optional[str] = None
    for job in jobs:
        t = str(
            (job.get("tenant") if isinstance(job, dict) else getattr(job, "tenant", ""))
            or ""
        )
        if batch and (t != tenant or len(batch) >= batch_size):
            yield batch
            batch = []
        tenant = t
        batch.append(job)
    if batch:
        yield batch


class SubmitterClient:
    def __init__(
        self,
        sched_ip_addr: str,
        sched_port: int,
        retry: Optional[RetryPolicy] = None,
        client_id: Optional[str] = None,
    ):
        self._addr = f"{sched_ip_addr}:{sched_port}"
        self._retry = retry or RetryPolicy.from_env()
        # Token namespace: unique per client so two submitters can
        # never collide in the scheduler's ledger.
        self.client_id = client_id or uuid.uuid4().hex[:12]
        self._seq = 0
        # ONE persistent channel per client, created lazily and reused
        # across every submit (channel setup used to be paid per RPC
        # attempt — at line rate that's a TCP+HTTP/2 handshake per
        # batch). Reset on transport errors and retarget; channels
        # are thread-safe, the lock only guards create/teardown.
        self._channel_lock = threading.Lock()
        self._channel = None
        self._stubs = None
        # Columnar wire negotiation (fastwire): while enabled, every
        # request advertises CAP_COLUMNAR; once the peer echoes it,
        # batches on THIS channel switch to the columnar frame. Cleared
        # with the channel — a failover target must re-prove support
        # before any frame is sent blind (a legacy server would parse
        # the unknown field as an empty batch and burn the token).
        # SHOCKWAVE_WIRE_COLUMNAR=0 pins pure legacy bytes end to end.
        self._columnar_enabled = os.environ.get(
            "SHOCKWAVE_WIRE_COLUMNAR", "1"
        ).lower() not in ("0", "false", "no", "off")
        self._peer_caps = 0

    def next_token(self) -> str:
        with self._channel_lock:
            seq = self._seq
            self._seq += 1
        return f"{self.client_id}-{seq:06d}"

    def _get_stubs(self):
        with self._channel_lock:
            if self._stubs is None:
                self._channel = insecure_channel(self._addr)
                self._stubs = make_stubs(
                    self._channel, "AdmissionToScheduler"
                )
            return self._stubs

    def _reset_channel(self) -> None:
        """Tear down the persistent channel (transport error or a
        failover retarget); the next submit rebuilds it and
        re-negotiates wire capabilities from scratch."""
        with self._channel_lock:
            channel, self._channel, self._stubs = self._channel, None, None
            self._peer_caps = 0
        if channel is not None:
            try:
                channel.close()
            except Exception as e:
                # Best-effort teardown: the channel is already detached
                # from the client, so a close() failure cannot wedge a
                # later submit — but it should not vanish either.
                LOG.warning("channel close failed: %s", e)

    def close(self) -> None:
        """Release the persistent channel. The client stays usable —
        a later submit reopens it."""
        self._reset_channel()

    def retarget(self, sched_ip_addr: str, sched_port: int) -> None:
        """Follow a scheduler failover: point subsequent submits at the
        new leader (resolve it from the HA front-door map with
        :func:`shockwave_tpu_torch.ha.frontdoor.resolve_submit_target`). The
        token namespace is unchanged — a batch retried across the flip
        re-sends the same token and the successor's restored ledger
        deduplicates it."""
        with self._channel_lock:
            self._addr = f"{sched_ip_addr}:{sched_port}"
        self._reset_channel()

    def submit(
        self,
        jobs: Sequence,
        token: Optional[str] = None,
        close: bool = False,
    ):
        """One SubmitJobs RPC (with transport retries under the shared
        policy, every attempt carrying the same token). ``jobs`` are
        :class:`~shockwave_tpu_torch.core.job.Job` objects or spec dicts.
        Returns the response (status/retry_after_s/admitted/
        queue_depth); raises :class:`SubmissionRejected` on INVALID/
        ERROR statuses."""
        token = token if token is not None else self.next_token()
        spec_dicts, batch_ctx = self._prepare_specs(token, jobs)

        def attempt(timeout):
            # Pre-send faults: the request never reaches the wire.
            faults.check_rpc(
                "SubmitJobs", kinds=("rpc_error", "rpc_delay")
            )
            # Encoded per attempt against the CURRENT channel's
            # negotiated capabilities: a retry that crossed a channel
            # reset (failover to a possibly-legacy server) re-sends the
            # same token and trace roots in the legacy encoding until
            # the new peer re-proves columnar support.
            request = self._encode_request(
                token, spec_dicts, close, batch_ctx
            )
            try:
                response = self._get_stubs().SubmitJobs(
                    request, timeout=timeout
                )
            except RpcError:
                # The persistent channel may be the casualty (server
                # restart, failover): rebuild it before the retry
                # policy re-offers the same token.
                self._reset_channel()
                raise
            self._note_peer_caps(response)
            # Post-send faults: the scheduler processed the batch but
            # the response is lost — the retry re-sends the SAME token
            # and must be deduplicated server-side.
            faults.check_rpc("SubmitJobs", kinds=("rpc_drop",))
            faults.note_rpc_success("SubmitJobs")
            return response

        with obs.span(
            "submit_jobs", cat="rpc", pid="submitter", tid="rpc",
            args={"token": token, "jobs": len(spec_dicts),
                  **propagate.ctx_args(batch_ctx)},
        ):
            response = call_with_retry(
                attempt, self._retry, method="SubmitJobs"
            )
        return self._check_response(response, len(jobs))

    def _prepare_specs(self, token: str, jobs: Sequence):
        """Spec dicts + the batch trace context for one batch (built
        ONCE per batch — transport retries and pipelined re-offers
        re-send the same specs, trace roots, and token; only the wire
        ENCODING is chosen per attempt against the current channel's
        negotiated capabilities)."""
        spec_dicts = [
            dict(j) if isinstance(j, dict) else job_to_spec_dict(j)
            for j in jobs
        ]
        # Causal roots: each traced job's whole cross-process life hangs
        # under the context minted HERE (submit is the chain's first
        # event). Created once per call, BEFORE the retry loop — a
        # transport retry re-sends the same context with the same token.
        # Gated ONCE per batch: with tracing off, new_root() would
        # no-op per job, but at line rate even a no-op call per job is
        # measurable on the submit path.
        for spec in spec_dicts if obs.trace_enabled() else ():
            if spec.get("trace_context"):
                continue
            ctx = propagate.new_root()
            if ctx is None or not ctx.sampled:
                continue
            spec["trace_context"] = ctx.to_wire()
            obs.instant(
                "job_submit", cat="job", pid="submitter", tid="jobs",
                args={"job_type": spec.get("job_type", ""),
                      "token": token, **ctx.args()},
            )
        # The batch RPC's own context: forced-sampled iff any member
        # job sampled, so it never consumes the deterministic sampling
        # counter (which would alias the per-job pattern — e.g. at
        # fraction 0.5 with one-job batches, alternating draws would
        # sample 100% of jobs and 0% of batches).
        batch_ctx = None
        if any(spec.get("trace_context") for spec in spec_dicts):
            batch_ctx = propagate.new_root(force_sample=True)
        return spec_dicts, batch_ctx

    def _note_peer_caps(self, response) -> None:
        """Record the peer's capability echo for the current channel
        (monotonic per channel: the echo can only turn columnar ON;
        only a channel reset clears it)."""
        caps = int(getattr(response, "wire_caps", 0))
        if caps & fastwire.CAP_COLUMNAR:
            with self._channel_lock:
                self._peer_caps |= fastwire.CAP_COLUMNAR

    def _encode_request(self, token, spec_dicts, close, batch_ctx):
        """One SubmitJobsRequest for a prepared batch, encoded for the
        CURRENT channel: the columnar frame once the peer has echoed
        CAP_COLUMNAR, the byte-identical legacy encoding otherwise
        (including every request while negotiation is still open — the
        first batch on a fresh channel doubles as the caps probe)."""
        if not self._columnar_enabled:
            return adm_pb2.SubmitJobsRequest(
                token=token,
                jobs=[adm_pb2.JobSpec(**spec) for spec in spec_dicts],
                close=close,
                trace_context=propagate.ctx_wire(batch_ctx),
            )
        with self._channel_lock:
            columnar = bool(self._peer_caps & fastwire.CAP_COLUMNAR)
        if columnar and spec_dicts:
            return adm_pb2.SubmitJobsRequest(
                token=token,
                close=close,
                trace_context=propagate.ctx_wire(batch_ctx),
                jobs_columnar=fastwire.encode_columnar_block(spec_dicts),
                wire_caps=fastwire.CAP_COLUMNAR,
            )
        return adm_pb2.SubmitJobsRequest(
            token=token,
            jobs=[adm_pb2.JobSpec(**spec) for spec in spec_dicts],
            close=close,
            trace_context=propagate.ctx_wire(batch_ctx),
            wire_caps=fastwire.CAP_COLUMNAR,
        )

    @staticmethod
    def _check_response(response, num_jobs: int):
        if response.status in ("INVALID", "ERROR"):
            raise SubmissionRejected(response.status, response.error)
        if response.status == "QUOTA":
            # Per-tenant admission quota: retrying the same batch as-is
            # would spin (the quota frees only as the tenant's backlog
            # drains) — surface it to the caller's shedding policy.
            raise SubmissionRejected(
                "QUOTA",
                response.error
                or f"tenant over admission quota; batch of {num_jobs} "
                "not queued",
            )
        if response.status == "CLOSED" and num_jobs:
            # The stream is closed and this batch was NOT admitted;
            # returning it as a normal response would silently drop the
            # jobs (a second submitter racing a close, or a late batch
            # after close_stream). An empty close-only request getting
            # CLOSED is just an idempotent re-close and stays benign.
            raise SubmissionRejected(
                "CLOSED",
                f"stream already closed; batch of {num_jobs} not "
                "admitted",
            )
        return response

    def close_stream(self, token: Optional[str] = None):
        """Send the end-of-stream close (an empty batch with close=True);
        idempotent — safe to retry and safe to repeat."""
        return self.submit(
            [], token=token or f"{self.client_id}-close", close=True
        )

    def submit_stream(
        self,
        jobs: Sequence,
        batch_size: int = 8,
        close: bool = True,
        max_backpressure_s: float = 300.0,
        sleep=time.sleep,
    ) -> List[str]:
        """Submit a whole trace in batches, honoring backpressure:
        a ``RETRY_AFTER`` response sleeps the advertised delay and
        resubmits the SAME token. Returns the tokens used (one per
        batch). ``max_backpressure_s`` bounds the total time spent
        backing off on one batch so a wedged scheduler surfaces as an
        error instead of an infinite loop."""
        tokens: List[str] = []
        batch_size = max(1, int(batch_size))
        try:
            for batch in _tenant_batches(jobs, batch_size):
                token = self.next_token()
                tokens.append(token)
                waited = 0.0
                while True:
                    try:
                        response = self.submit(batch, token=token)
                    except SubmissionRejected as e:
                        if e.status != "QUOTA":
                            raise
                        # Shed THIS tenant's batch and keep going:
                        # quota is that tenant's problem, not the
                        # stream's — aborting here would drop every
                        # later batch and leave the stream unclosed.
                        LOG.warning("batch %s shed: %s", token, e)
                        obs.counter(
                            "admission_client_quota_shed_total",
                            "batches shed by the submitter on a QUOTA "
                            "rejection",
                        ).inc()
                        break
                    if response.status != "RETRY_AFTER":
                        break
                    delay = max(float(response.retry_after_s), 0.05)
                    waited += delay
                    if waited > max_backpressure_s:
                        raise TimeoutError(
                            f"batch {token} backpressured for "
                            f"{waited:.1f}s (> {max_backpressure_s}s); "
                            "the scheduler is not draining its "
                            "admission queue"
                        )
                    obs.counter(
                        "admission_client_backpressure_total",
                        "RETRY_AFTER responses honored by the submitter",
                    ).inc()
                    sleep(delay)
        finally:
            # Even a failing submitter ends the stream — the round
            # loop must finish what was admitted, not idle forever on
            # a stream nobody will close.
            if close:
                try:
                    self.close_stream()
                except Exception:
                    LOG.warning(
                        "end-of-stream close failed", exc_info=True
                    )
        return tokens

    def submit_pipelined(
        self,
        jobs: Sequence,
        batch_size: int = 8,
        window: int = 8,
        close: bool = True,
        max_backpressure_s: float = 300.0,
        sleep=time.sleep,
    ) -> List[str]:
        """:meth:`submit_stream` at line rate: keep up to ``window``
        SubmitJobs RPCs in flight on the persistent channel instead of
        one serial request/response per batch, so client throughput is
        bounded by server-side admission, not by per-batch round trips.
        Responses resolve in submission order. Any batch the fast path
        cannot finish — a transport error, an injected fault, or a
        RETRY_AFTER bounce — falls back to the serial :meth:`submit`
        path with the SAME token, so retries stay exactly-once through
        the ledger and backpressure is honored with the usual sleep
        loop. Returns the tokens used (one per batch)."""
        tokens: List[str] = []
        batch_size = max(1, int(batch_size))
        window = max(1, int(window))
        # (token, batch, future) in flight, submission order.
        inflight: deque = deque()

        def resolve(entry) -> None:
            token, batch, future = entry
            response = None
            if future is not None:
                try:
                    response = future.result()
                    self._note_peer_caps(response)
                    # Post-receive faults: response lost after the
                    # server processed the batch — the serial fallback
                    # re-offers the same token and dedups.
                    faults.check_rpc("SubmitJobs", kinds=("rpc_drop",))
                    faults.note_rpc_success("SubmitJobs")
                except (RpcError, faults.InjectedRpcError):
                    self._reset_channel()
                    response = None
            if response is not None and response.status not in (
                "RETRY_AFTER",
            ):
                self._check_response(response, len(batch))
                return
            # Slow path: serial submit with the SAME token (transport
            # retries inside; backpressure honored here).
            waited = 0.0
            while True:
                response = self.submit(batch, token=token)
                if response.status != "RETRY_AFTER":
                    return
                delay = max(float(response.retry_after_s), 0.05)
                waited += delay
                if waited > max_backpressure_s:
                    raise TimeoutError(
                        f"batch {token} backpressured for "
                        f"{waited:.1f}s (> {max_backpressure_s}s); "
                        "the scheduler is not draining its "
                        "admission queue"
                    )
                obs.counter(
                    "admission_client_backpressure_total",
                    "RETRY_AFTER responses honored by the submitter",
                ).inc()
                sleep(delay)

        try:
            for batch in _tenant_batches(jobs, batch_size):
                token = self.next_token()
                tokens.append(token)
                spec_dicts, batch_ctx = self._prepare_specs(token, batch)
                try:
                    # Pre-send faults: the request never reached the
                    # wire — no future to wait on, straight to the
                    # serial fallback (same token).
                    faults.check_rpc(
                        "SubmitJobs", kinds=("rpc_error", "rpc_delay")
                    )
                    request = self._encode_request(
                        token, spec_dicts, False, batch_ctx
                    )
                    future = self._get_stubs().SubmitJobs.future(
                        request, timeout=self._retry.call_timeout_s
                    )
                except (RpcError, faults.InjectedRpcError):
                    self._reset_channel()
                    future = None
                inflight.append((token, batch, future))
                obs.counter(
                    "admission_client_pipelined_total",
                    "SubmitJobs batches issued through the pipelined "
                    "in-flight window",
                ).inc()
                while len(inflight) >= window:
                    try:
                        resolve(inflight.popleft())
                    except SubmissionRejected as e:
                        if e.status != "QUOTA":
                            raise
                        LOG.warning("batch shed: %s", e)
                        obs.counter(
                            "admission_client_quota_shed_total",
                            "batches shed by the submitter on a QUOTA "
                            "rejection",
                        ).inc()
            while inflight:
                try:
                    resolve(inflight.popleft())
                except SubmissionRejected as e:
                    if e.status != "QUOTA":
                        raise
                    LOG.warning("batch shed: %s", e)
                    obs.counter(
                        "admission_client_quota_shed_total",
                        "batches shed by the submitter on a QUOTA "
                        "rejection",
                    ).inc()
        finally:
            if close:
                try:
                    self.close_stream()
                except Exception:
                    LOG.warning(
                        "end-of-stream close failed", exc_info=True
                    )
        return tokens

    def submit_trace(
        self,
        jobs: Sequence,
        arrivals: Sequence[float],
        time_scale: float = 1.0,
        max_batch: int = 64,
        close: bool = True,
        on_batch: Optional[Callable[[list], None]] = None,
        sleep=time.sleep,
        clock=time.time,
    ) -> int:
        """Replay a whole trace's arrival schedule in (scaled) wall
        clock through the front door: sleep until each arrival is due,
        coalesce every due arrival into one batch (capped at
        ``max_batch`` so a compressed schedule cannot build a batch the
        queue bound would bounce forever), and submit with
        backpressure honored. The close signal is sent in a finally —
        even a failing submitter ends the stream, so the scheduler's
        round loop finishes what it admitted instead of idling forever
        on a stream nobody will close. Returns the number of jobs
        submitted; ``on_batch`` sees each batch after it is accepted."""
        if len(jobs) != len(arrivals):
            raise ValueError(
                f"{len(jobs)} jobs for {len(arrivals)} arrival times"
            )
        max_batch = max(1, int(max_batch))
        start = clock()
        i = 0
        submitted = 0
        try:
            while i < len(jobs):
                delay = arrivals[i] * time_scale - (clock() - start)
                if delay > 0:
                    sleep(delay)
                batch = [jobs[i]]
                i += 1
                now_virtual = (clock() - start) / max(time_scale, 1e-9)
                while (
                    i < len(jobs)
                    and arrivals[i] <= now_virtual
                    and len(batch) < max_batch
                ):
                    batch.append(jobs[i])
                    i += 1
                self.submit_stream(
                    batch, batch_size=len(batch), close=False,
                    sleep=sleep,
                )
                submitted += len(batch)
                if on_batch is not None:
                    on_batch(batch)
        finally:
            if close:
                try:
                    self.close_stream()
                except Exception:
                    # Best effort only: the primary error (if any) is
                    # already propagating; a close that cannot reach a
                    # dead scheduler must not mask it.
                    LOG.warning(
                        "end-of-stream close failed", exc_info=True
                    )
        return submitted
