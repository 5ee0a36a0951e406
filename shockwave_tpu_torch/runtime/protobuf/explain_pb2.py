"""Hand-rolled protobuf for explain.proto (no protoc in this build).

The ``ExplainJob`` RPC's messages: a request naming one job (plus the
optional causal trace context every RPC in this runtime carries) and a
response carrying the job's full decision narrative as one JSON string
field — the same one-string-payload shape as ``MetricsDump``, chosen so
the narrative schema can evolve without a wire change while remaining
canonical proto3 (a protoc-generated counterpart interoperates
byte-for-byte; see the byte-identity tests in
``tests/test_wire_compat.py``). Unknown fields are skipped per proto3
rules, keeping both parsers forward-compatible with a widened schema.
Field numbers are documented in explain.proto.
"""

from __future__ import annotations

from shockwave_tpu_torch.runtime.protobuf.wire import (
    put_str,
    put_varint,
    scan_fields,
)


class ExplainJobRequest:
    """message ExplainJobRequest { string job_id = 1;
    string trace_context = 2; }"""

    def __init__(self, job_id: str = "", trace_context: str = ""):
        self.job_id = job_id
        self.trace_context = trace_context

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        out = bytearray()
        put_str(out, 1, self.job_id)
        put_str(out, 2, self.trace_context)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "ExplainJobRequest":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                msg.job_id = value.decode("utf-8")
            elif field == 2 and wire_type == 2:
                msg.trace_context = value.decode("utf-8")
        return msg


class ExplainJobResponse:
    """message ExplainJobResponse { bool found = 1;
    string narrative_json = 2; string error = 3; }"""

    def __init__(
        self,
        found: bool = False,
        narrative_json: str = "",
        error: str = "",
    ):
        self.found = found
        self.narrative_json = narrative_json
        self.error = error

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, int(self.found))
        put_str(out, 2, self.narrative_json)
        put_str(out, 3, self.error)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "ExplainJobResponse":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.found = bool(value)
            elif field == 2 and wire_type == 2:
                msg.narrative_json = value.decode("utf-8")
            elif field == 3 and wire_type == 2:
                msg.error = value.decode("utf-8")
        return msg
