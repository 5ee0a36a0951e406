"""Hand-rolled counterpart of the protoc module for ``common.proto``:
``Empty`` and ``JobState``, canonical proto3 bytes (see :mod:`.wire`)."""

from __future__ import annotations

from shockwave_tpu_torch.runtime.protobuf.wire import put_varint, scan_fields


class Empty:
    """message Empty {} — zero bytes; unknown fields are skipped."""

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        return b""

    @classmethod
    def FromString(cls, data: bytes) -> "Empty":  # noqa: N802
        for _ in scan_fields(data):
            pass
        return cls()


class JobState:
    """message JobState { uint32 job_id = 1; JobStatus status = 2; }"""

    def __init__(self, job_id: int = 0, status: int = 0):
        self.job_id = int(job_id)
        self.status = int(status)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, self.job_id & 0xFFFFFFFF)
        put_varint(out, 2, self.status)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "JobState":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.job_id = int(value) & 0xFFFFFFFF
            elif field == 2 and wire_type == 0:
                msg.status = int(value)
        return msg
