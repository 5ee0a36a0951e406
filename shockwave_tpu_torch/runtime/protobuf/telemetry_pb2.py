"""Hand-rolled protobuf for telemetry.proto (no protoc in this build).

``MetricsDump`` carries one proto3 ``string text = 1`` field;
``MetricsRequest`` is the scrape request — one optional
``string trace_context = 1`` (:mod:`shockwave_tpu_torch.obs.propagate`) so a
fleet scrape shows up in the causal trace. Both implement exactly the
two entry points the hand-rolled gRPC wiring
(:mod:`shockwave_tpu_torch.runtime.rpc.wiring`) uses — ``SerializeToString``
and ``FromString`` — emitting/consuming canonical proto3 wire format
(see :mod:`.wire`), so a protoc-generated counterpart interoperates
byte-for-byte. An empty ``MetricsRequest`` serializes to zero bytes,
i.e. it is wire-identical to ``Empty`` — old scrapers keep working
unchanged. Unknown fields are skipped per proto3 rules, keeping the
parsers forward-compatible with a widened schema.
"""

from __future__ import annotations

from shockwave_tpu_torch.runtime.protobuf.wire import put_str, scan_fields


class MetricsDump:
    """message MetricsDump { string text = 1; }"""

    def __init__(self, text: str = ""):
        self.text = text

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        out = bytearray()
        put_str(out, 1, self.text)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "MetricsDump":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                msg.text = value.decode("utf-8")
        return msg


class MetricsRequest:
    """message MetricsRequest { string trace_context = 1; } — wire-
    identical to Empty when the context is absent."""

    def __init__(self, trace_context: str = ""):
        self.trace_context = trace_context

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_str(out, 1, self.trace_context)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "MetricsRequest":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                msg.trace_context = value.decode("utf-8")
        return msg
