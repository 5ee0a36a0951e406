"""Hand-rolled protobuf for admission.proto (no protoc in this build).

Implements the three messages of the streaming-admission front door —
``JobSpec``, ``SubmitJobsRequest``, ``SubmitJobsResponse`` — with
exactly the two entry points the hand-rolled gRPC wiring
(:mod:`shockwave_tpu_torch.runtime.rpc.wiring`) uses, ``SerializeToString``
and ``FromString``, emitting/consuming canonical proto3 wire format
(see :mod:`.wire`) so a protoc-generated counterpart interoperates
byte-for-byte. Unknown fields are skipped per proto3 rules, keeping
the parser forward-compatible with a widened schema. Field numbers are
documented in admission.proto.

Causal tracing extensions (:mod:`shockwave_tpu_torch.obs.propagate`):
``JobSpec.trace_context`` (13, string) carries the submitter's per-job
ROOT context — the span every scheduler/worker span of that job's life
hangs under — and ``SubmitJobsRequest.trace_context`` (4, string) the
batch RPC's own context. Both optional and default-empty, so untraced
submissions stay byte-identical to the legacy wire.

Columnar wire extensions (:mod:`.fastwire`):
``SubmitJobsRequest.jobs_columnar`` (5, bytes) carries a whole batch
as one ColumnarJobBlock frame instead of repeated ``jobs`` messages,
and ``wire_caps`` (6 on both request and response, varint bitmask —
bit 1 = columnar) is the capability negotiation: a submitter
advertises on its first (legacy-encoded) request of a channel, a
capable server echoes, and only then does the client switch to the
frame. All three default to unset, so legacy traffic stays
byte-identical.
"""

from __future__ import annotations

from typing import List

from shockwave_tpu_torch.runtime.protobuf.wire import (
    encode_varint as _encode_varint,  # noqa: F401 (test fixtures build
    tag as _tag,  # noqa: F401         raw unknown-field bytes with these)
    put_double,
    put_msg,
    put_str,
    put_varint,
    scan_fields,
)


class JobSpec:
    """message JobSpec — one job of a submission batch."""

    def __init__(
        self,
        job_type: str = "",
        command: str = "",
        working_directory: str = "",
        num_steps_arg: str = "",
        total_steps: int = 0,
        scale_factor: int = 0,
        mode: str = "",
        priority_weight: float = 0.0,
        slo: float = 0.0,
        duration: float = 0.0,
        needs_data_dir: bool = False,
        tenant: str = "",
        trace_context: str = "",
    ):
        self.job_type = job_type
        self.command = command
        self.working_directory = working_directory
        self.num_steps_arg = num_steps_arg
        self.total_steps = int(total_steps)
        self.scale_factor = int(scale_factor)
        self.mode = mode
        self.priority_weight = float(priority_weight)
        self.slo = float(slo)
        self.duration = float(duration)
        self.needs_data_dir = bool(needs_data_dir)
        self.tenant = tenant
        self.trace_context = trace_context

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        out = bytearray()
        put_str(out, 1, self.job_type)
        put_str(out, 2, self.command)
        put_str(out, 3, self.working_directory)
        put_str(out, 4, self.num_steps_arg)
        put_varint(out, 5, self.total_steps)
        put_varint(out, 6, self.scale_factor)
        put_str(out, 7, self.mode)
        put_double(out, 8, self.priority_weight)
        put_double(out, 9, self.slo)
        put_double(out, 10, self.duration)
        put_varint(out, 11, int(self.needs_data_dir))
        put_str(out, 12, self.tenant)
        put_str(out, 13, self.trace_context)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "JobSpec":  # noqa: N802
        spec = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                spec.job_type = value.decode("utf-8")
            elif field == 2 and wire_type == 2:
                spec.command = value.decode("utf-8")
            elif field == 3 and wire_type == 2:
                spec.working_directory = value.decode("utf-8")
            elif field == 4 and wire_type == 2:
                spec.num_steps_arg = value.decode("utf-8")
            elif field == 5 and wire_type == 0:
                spec.total_steps = int(value)
            elif field == 6 and wire_type == 0:
                spec.scale_factor = int(value)
            elif field == 7 and wire_type == 2:
                spec.mode = value.decode("utf-8")
            elif field == 8 and wire_type == 1:
                spec.priority_weight = value
            elif field == 9 and wire_type == 1:
                spec.slo = value
            elif field == 10 and wire_type == 1:
                spec.duration = value
            elif field == 11 and wire_type == 0:
                spec.needs_data_dir = bool(value)
            elif field == 12 and wire_type == 2:
                spec.tenant = value.decode("utf-8")
            elif field == 13 and wire_type == 2:
                spec.trace_context = value.decode("utf-8")
        return spec


class SubmitJobsRequest:
    """message SubmitJobsRequest { token, repeated JobSpec jobs, close,
    trace_context }"""

    def __init__(
        self,
        token: str = "",
        jobs: List[JobSpec] = None,
        close: bool = False,
        trace_context: str = "",
        jobs_columnar: bytes = b"",
        wire_caps: int = 0,
    ):
        self.token = token
        self.jobs = list(jobs) if jobs else []
        self.close = bool(close)
        self.trace_context = trace_context
        self.jobs_columnar = bytes(jobs_columnar)
        self.wire_caps = int(wire_caps)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_str(out, 1, self.token)
        for spec in self.jobs:
            put_msg(out, 2, spec.SerializeToString())
        put_varint(out, 3, int(self.close))
        put_str(out, 4, self.trace_context)
        if self.jobs_columnar:
            put_msg(out, 5, self.jobs_columnar)
        put_varint(out, 6, self.wire_caps)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "SubmitJobsRequest":  # noqa: N802
        request = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                request.token = value.decode("utf-8")
            elif field == 2 and wire_type == 2:
                request.jobs.append(JobSpec.FromString(value))
            elif field == 3 and wire_type == 0:
                request.close = bool(value)
            elif field == 4 and wire_type == 2:
                request.trace_context = value.decode("utf-8")
            elif field == 5 and wire_type == 2:
                request.jobs_columnar = bytes(value)
            elif field == 6 and wire_type == 0:
                request.wire_caps = int(value)
        return request


class SubmitJobsResponse:
    """message SubmitJobsResponse { status, retry_after_s, admitted,
    error, queue_depth }"""

    def __init__(
        self,
        status: str = "",
        retry_after_s: float = 0.0,
        admitted: int = 0,
        error: str = "",
        queue_depth: int = 0,
        wire_caps: int = 0,
    ):
        self.status = status
        self.retry_after_s = float(retry_after_s)
        self.admitted = int(admitted)
        self.error = error
        self.queue_depth = int(queue_depth)
        self.wire_caps = int(wire_caps)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_str(out, 1, self.status)
        put_double(out, 2, self.retry_after_s)
        put_varint(out, 3, self.admitted)
        put_str(out, 4, self.error)
        put_varint(out, 5, self.queue_depth)
        put_varint(out, 6, self.wire_caps)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "SubmitJobsResponse":  # noqa: N802
        response = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                response.status = value.decode("utf-8")
            elif field == 2 and wire_type == 1:
                response.retry_after_s = value
            elif field == 3 and wire_type == 0:
                response.admitted = int(value)
            elif field == 4 and wire_type == 2:
                response.error = value.decode("utf-8")
            elif field == 5 and wire_type == 0:
                response.queue_depth = int(value)
            elif field == 6 and wire_type == 0:
                response.wire_caps = int(value)
        return response
