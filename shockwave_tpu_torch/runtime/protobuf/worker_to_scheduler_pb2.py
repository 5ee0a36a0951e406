"""Hand-rolled protobuf for worker_to_scheduler.proto (no protoc in
this build; the frozen protoc originals live in ``legacy/`` as the
wire-compat test fixtures).

Implements the worker -> scheduler messages with exactly the two entry
points the hand-rolled gRPC wiring uses — ``SerializeToString`` and
``FromString`` — emitting/consuming canonical proto3 wire format
(defaults omitted, repeated scalars packed, doubles little-endian) so
the protoc-generated counterpart interoperates byte-for-byte. Unknown
fields are skipped per proto3 rules.

Schema extensions over the legacy wire (all optional; absent fields
parse to defaults, and a default field serializes to zero bytes, so
old and new peers interoperate in both directions):

  * ``RegisterWorkerRequest.client_send_s`` (5, double) and
    ``RegisterWorkerResponse.sched_recv_s``/``sched_send_s`` (5/6,
    double) — the registration leg of the NTP-style clock-offset
    exchange (worker wall clock out, scheduler wall clock back).
  * ``Heartbeat.client_send_s`` (3, double) — each heartbeat restarts
    the exchange; ``est_offset_s``/``est_rtt_s`` (4/5, double) report
    the worker's current best estimate back to the scheduler
    (``est_rtt_s > 0`` marks the pair valid — a real round trip is
    never zero); ``trace_context`` (6, string) carries the agent's
    causal context (:mod:`shockwave_tpu_torch.obs.propagate`).
  * ``HeartbeatAck`` — NEW response message for SendHeartbeat
    (``sched_recv_s``/``sched_send_s``); an old scheduler still
    returns ``Empty``, which parses here as an ack with no timestamps
    (no sample taken), and an old worker parses the ack as ``Empty``
    with unknown fields skipped.
  * ``DoneRequest.trace_context`` (6, repeated string) — one causal
    context per reported job, parallel to ``job_id``.
  * HA re-attach + fenced epochs (shockwave_tpu/ha/):
    ``RegisterWorkerRequest.prev_worker_ids`` (6, repeated int64) and
    ``outstanding_job_ids`` (7, repeated int64) let a worker that
    survived a scheduler death re-register with its previous identity
    and its in-flight micro-task state, so a restored successor
    re-adopts it instead of minting fresh capacity;
    ``RegisterWorkerResponse.sched_epoch`` (7, int64) and
    ``reattached`` (8, bool) plus ``HeartbeatAck.sched_epoch`` (3,
    int64) carry the leader's fencing epoch (0 = HA off, serializes to
    zero bytes — legacy byte identity).
"""

from __future__ import annotations

from typing import List, Optional

from shockwave_tpu_torch.runtime.protobuf.wire import (
    put_double,
    put_msg,
    put_packed_doubles,
    put_packed_varints,
    put_str,
    put_varint,
    scan_fields,
    unpack_packed_doubles,
    unpack_packed_varints,
)


class RegisterWorkerRequest:
    """message RegisterWorkerRequest { worker_type, num_accelerators,
    ip_addr, port, client_send_s, prev_worker_ids, outstanding_job_ids }"""

    def __init__(
        self,
        worker_type: str = "",
        num_accelerators: int = 0,
        ip_addr: str = "",
        port: int = 0,
        client_send_s: float = 0.0,
        prev_worker_ids: Optional[List[int]] = None,
        outstanding_job_ids: Optional[List[int]] = None,
    ):
        self.worker_type = worker_type
        self.num_accelerators = int(num_accelerators)
        self.ip_addr = ip_addr
        self.port = int(port)
        self.client_send_s = float(client_send_s)
        # HA re-attach: the ids this agent held under the previous
        # leader, and the micro-task job ids it still carries (running
        # processes + buffered Done reports) — empty on a fresh
        # registration (zero bytes on the wire).
        self.prev_worker_ids = [int(w) for w in (prev_worker_ids or [])]
        self.outstanding_job_ids = [
            int(j) for j in (outstanding_job_ids or [])
        ]

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        out = bytearray()
        put_str(out, 1, self.worker_type)
        put_varint(out, 2, self.num_accelerators)
        put_str(out, 3, self.ip_addr)
        put_varint(out, 4, self.port)
        put_double(out, 5, self.client_send_s)
        put_packed_varints(out, 6, self.prev_worker_ids)
        put_packed_varints(out, 7, self.outstanding_job_ids)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "RegisterWorkerRequest":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                msg.worker_type = value.decode("utf-8")
            elif field == 2 and wire_type == 0:
                msg.num_accelerators = int(value)
            elif field == 3 and wire_type == 2:
                msg.ip_addr = value.decode("utf-8")
            elif field == 4 and wire_type == 0:
                msg.port = int(value)
            elif field == 5 and wire_type == 1:
                msg.client_send_s = value
            elif field == 6 and wire_type == 2:
                msg.prev_worker_ids.extend(unpack_packed_varints(value))
            elif field == 6 and wire_type == 0:
                msg.prev_worker_ids.append(int(value))
            elif field == 7 and wire_type == 2:
                msg.outstanding_job_ids.extend(unpack_packed_varints(value))
            elif field == 7 and wire_type == 0:
                msg.outstanding_job_ids.append(int(value))
        return msg


class RegisterWorkerResponse:
    """message RegisterWorkerResponse { success, worker_ids,
    round_duration, error_message, sched_recv_s, sched_send_s,
    sched_epoch, reattached }"""

    def __init__(
        self,
        success: bool = False,
        worker_ids: Optional[List[int]] = None,
        round_duration: int = 0,
        error_message: str = "",
        sched_recv_s: float = 0.0,
        sched_send_s: float = 0.0,
        sched_epoch: int = 0,
        reattached: bool = False,
    ):
        self.success = bool(success)
        self.worker_ids = [int(w) for w in (worker_ids or [])]
        self.round_duration = int(round_duration)
        self.error_message = error_message
        self.sched_recv_s = float(sched_recv_s)
        self.sched_send_s = float(sched_send_s)
        # Fencing epoch of the answering leader (0 = HA off) and
        # whether this registration re-adopted the agent's previous
        # worker ids instead of minting fresh capacity.
        self.sched_epoch = int(sched_epoch)
        self.reattached = bool(reattached)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, int(self.success))
        put_packed_varints(out, 2, self.worker_ids)
        put_varint(out, 3, self.round_duration)
        put_str(out, 4, self.error_message)
        put_double(out, 5, self.sched_recv_s)
        put_double(out, 6, self.sched_send_s)
        put_varint(out, 7, self.sched_epoch)
        put_varint(out, 8, int(self.reattached))
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "RegisterWorkerResponse":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.success = bool(value)
            elif field == 2 and wire_type == 2:
                msg.worker_ids.extend(unpack_packed_varints(value))
            elif field == 2 and wire_type == 0:
                msg.worker_ids.append(int(value))  # unpacked sender
            elif field == 3 and wire_type == 0:
                msg.round_duration = int(value)
            elif field == 4 and wire_type == 2:
                msg.error_message = value.decode("utf-8")
            elif field == 5 and wire_type == 1:
                msg.sched_recv_s = value
            elif field == 6 and wire_type == 1:
                msg.sched_send_s = value
            elif field == 7 and wire_type == 0:
                msg.sched_epoch = int(value)
            elif field == 8 and wire_type == 0:
                msg.reattached = bool(value)
        return msg


class JobState:
    """message JobState (common.proto) { job_id, status } — carried in
    heartbeats; ``status`` is the JobStatus enum's integer value."""

    def __init__(self, job_id: int = 0, status: int = 0):
        self.job_id = int(job_id)
        self.status = int(status)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, self.job_id)
        put_varint(out, 2, self.status)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "JobState":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.job_id = int(value)
            elif field == 2 and wire_type == 0:
                msg.status = int(value)
        return msg


class Heartbeat:
    """message Heartbeat { worker_id, job_state, client_send_s,
    est_offset_s, est_rtt_s, trace_context, metrics_text,
    metrics_frame }

    ``metrics_text`` (field 7) piggy-backs the agent's rendered
    Prometheus registry on a due heartbeat, coalescing the separate
    DumpMetrics poll into the RPC that already crosses the wire every
    interval. Empty (the default, and what legacy workers send) means
    "no dump attached" — the scheduler's pull path still covers that
    peer, so both generations interoperate.

    ``metrics_frame`` (field 8, bytes) is the PR-19 successor: a
    compressed binary snapshot of the agent's registry (magic ``SKF1``;
    :func:`shockwave_tpu_torch.obs.sketch.encode_snapshot_frame`) whose
    histogram sketches the scheduler MERGES into exact fleet-wide
    quantiles instead of concatenating exposition text. A scheduler
    that predates the field skips it (unknown-field rule), falling back
    to its DumpMetrics pull; a worker that predates it simply never
    sets it."""

    def __init__(
        self,
        worker_id: int = 0,
        job_state: Optional[List[JobState]] = None,
        client_send_s: float = 0.0,
        est_offset_s: float = 0.0,
        est_rtt_s: float = 0.0,
        trace_context: str = "",
        metrics_text: str = "",
        metrics_frame: bytes = b"",
    ):
        self.worker_id = int(worker_id)
        self.job_state = list(job_state) if job_state else []
        self.client_send_s = float(client_send_s)
        self.est_offset_s = float(est_offset_s)
        self.est_rtt_s = float(est_rtt_s)
        self.trace_context = trace_context
        self.metrics_text = metrics_text
        self.metrics_frame = bytes(metrics_frame)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, self.worker_id)
        for state in self.job_state:
            put_msg(out, 2, state.SerializeToString())
        put_double(out, 3, self.client_send_s)
        put_double(out, 4, self.est_offset_s)
        put_double(out, 5, self.est_rtt_s)
        put_str(out, 6, self.trace_context)
        put_str(out, 7, self.metrics_text)
        if self.metrics_frame:
            put_msg(out, 8, self.metrics_frame)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Heartbeat":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.worker_id = int(value)
            elif field == 2 and wire_type == 2:
                msg.job_state.append(JobState.FromString(value))
            elif field == 3 and wire_type == 1:
                msg.client_send_s = value
            elif field == 4 and wire_type == 1:
                msg.est_offset_s = value
            elif field == 5 and wire_type == 1:
                msg.est_rtt_s = value
            elif field == 6 and wire_type == 2:
                msg.trace_context = value.decode("utf-8")
            elif field == 7 and wire_type == 2:
                msg.metrics_text = value.decode("utf-8")
            elif field == 8 and wire_type == 2:
                msg.metrics_frame = bytes(value)
        return msg


class HeartbeatAck:
    """message HeartbeatAck { sched_recv_s, sched_send_s, sched_epoch }
    — the scheduler's side of the NTP exchange, plus its fencing epoch
    (0 = HA off). Wire-compatible with Empty in both directions (all
    fields optional)."""

    def __init__(
        self,
        sched_recv_s: float = 0.0,
        sched_send_s: float = 0.0,
        sched_epoch: int = 0,
    ):
        self.sched_recv_s = float(sched_recv_s)
        self.sched_send_s = float(sched_send_s)
        self.sched_epoch = int(sched_epoch)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_double(out, 1, self.sched_recv_s)
        put_double(out, 2, self.sched_send_s)
        put_varint(out, 3, self.sched_epoch)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "HeartbeatAck":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 1:
                msg.sched_recv_s = value
            elif field == 2 and wire_type == 1:
                msg.sched_send_s = value
            elif field == 3 and wire_type == 0:
                msg.sched_epoch = int(value)
        return msg


class DoneRequest:
    """message DoneRequest { worker_id, job_id, num_steps,
    execution_time, iterator_log, trace_context }"""

    def __init__(
        self,
        worker_id: int = 0,
        job_id: Optional[List[int]] = None,
        num_steps: Optional[List[int]] = None,
        execution_time: Optional[List[float]] = None,
        iterator_log: Optional[List[str]] = None,
        trace_context: Optional[List[str]] = None,
    ):
        self.worker_id = int(worker_id)
        self.job_id = [int(j) for j in (job_id or [])]
        self.num_steps = [int(s) for s in (num_steps or [])]
        self.execution_time = [float(t) for t in (execution_time or [])]
        self.iterator_log = [str(x) for x in (iterator_log or [])]
        self.trace_context = [str(x) for x in (trace_context or [])]

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, self.worker_id)
        put_packed_varints(out, 2, self.job_id)
        put_packed_varints(out, 3, self.num_steps)
        put_packed_doubles(out, 4, self.execution_time)
        for log in self.iterator_log:
            # Repeated strings serialize every element, empty included
            # (unlike singular strings, where empty means absent) —
            # dropping one would shift the per-job parallel arrays.
            put_msg(out, 5, log.encode("utf-8"))
        if any(self.trace_context):
            # Every entry serializes (even empty ones) to keep the
            # per-job parallel-array alignment; an all-empty list is
            # omitted entirely for legacy byte identity.
            for ctx in self.trace_context:
                put_msg(out, 6, ctx.encode("utf-8"))
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "DoneRequest":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.worker_id = int(value)
            elif field == 2 and wire_type == 2:
                msg.job_id.extend(unpack_packed_varints(value))
            elif field == 2 and wire_type == 0:
                msg.job_id.append(int(value))
            elif field == 3 and wire_type == 2:
                msg.num_steps.extend(unpack_packed_varints(value))
            elif field == 3 and wire_type == 0:
                msg.num_steps.append(int(value))
            elif field == 4 and wire_type == 2:
                msg.execution_time.extend(unpack_packed_doubles(value))
            elif field == 4 and wire_type == 1:
                msg.execution_time.append(value)
            elif field == 5 and wire_type == 2:
                msg.iterator_log.append(value.decode("utf-8"))
            elif field == 6 and wire_type == 2:
                msg.trace_context.append(value.decode("utf-8"))
        return msg
