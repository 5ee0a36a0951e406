"""Hand-rolled counterpart of the protoc module for
``iterator_to_scheduler.proto``: the lease protocol's three messages,
canonical proto3 bytes (see :mod:`.wire`)."""

from __future__ import annotations

from shockwave_tpu_torch.runtime.protobuf.wire import (
    put_double,
    put_varint,
    scan_fields,
)


class _Message:
    """Flat message of varint (uint64) and double fields; ``FIELDS`` is
    ((name, number, kind), ...) in number order, kind "u64" or "f64"."""

    FIELDS: tuple = ()

    def __init__(self, **kwargs):
        for name, _, kind in self.FIELDS:
            value = kwargs.pop(name, 0)
            setattr(self, name, int(value) if kind == "u64" else float(value))
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} has no fields {sorted(kwargs)}"
            )

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        out = bytearray()
        for name, number, kind in self.FIELDS:
            if kind == "u64":
                put_varint(out, number, getattr(self, name))
            else:
                put_double(out, number, getattr(self, name))
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802
        msg = cls()
        kinds = {number: (name, kind) for name, number, kind in cls.FIELDS}
        for field, wire_type, value in scan_fields(data):
            entry = kinds.get(field)
            if entry is None:
                continue
            name, kind = entry
            if kind == "u64" and wire_type == 0:
                setattr(msg, name, int(value))
            elif kind == "f64" and wire_type == 1:
                setattr(msg, name, float(value))
        return msg

    def __repr__(self):
        fields = ", ".join(
            f"{n}={getattr(self, n)!r}" for n, _, _ in self.FIELDS
        )
        return f"{type(self).__name__}({fields})"


class InitJobRequest(_Message):
    """message InitJobRequest { uint64 job_id = 1; }"""

    FIELDS = (("job_id", 1, "u64"),)


class UpdateLeaseRequest(_Message):
    """message UpdateLeaseRequest { job_id, worker_id, steps, duration,
    max_steps, max_duration }"""

    FIELDS = (
        ("job_id", 1, "u64"),
        ("worker_id", 2, "u64"),
        ("steps", 3, "u64"),
        ("duration", 4, "f64"),
        ("max_steps", 5, "u64"),
        ("max_duration", 6, "f64"),
    )


class UpdateLeaseResponse(_Message):
    """message UpdateLeaseResponse { max_steps, max_duration,
    extra_time }"""

    FIELDS = (
        ("max_steps", 1, "u64"),
        ("max_duration", 2, "f64"),
        ("extra_time", 3, "f64"),
    )
