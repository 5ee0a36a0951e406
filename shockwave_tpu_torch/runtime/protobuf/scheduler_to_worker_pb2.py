"""Hand-rolled protobuf for scheduler_to_worker.proto (no protoc in
this build; the frozen protoc originals live in ``legacy/`` as the
wire-compat test fixtures).

Canonical proto3 wire format with unknown fields skipped, exactly like
the sibling hand-rolled modules (see :mod:`.wire`). Schema extensions
over the legacy wire:

  * ``JobDescription.trace_context`` (10, string) — the dispatching
    scheduler span's causal context; the worker opens its launch/run
    spans as children so the job's cross-process chain stays connected
    (:mod:`shockwave_tpu_torch.obs.propagate`).
  * ``KillJobRequest.trace_context`` (2, string) — same, for kills.
  * ``RunJobRequest.sched_epoch`` (4, int64) and
    ``KillJobRequest.sched_epoch`` (3, int64) — the sending leader's
    fencing epoch (shockwave_tpu/ha/): workers reject dispatch/kill
    RPCs below the highest epoch they have witnessed, so a deposed
    leader cannot double-dispatch. 0 = HA off.

All are optional: absent on the wire they parse to ``""``/0 (fresh
root / unfenced at the receiver), and empty/zero they serialize to
zero bytes (legacy byte identity).
"""

from __future__ import annotations

from typing import List, Optional

from shockwave_tpu_torch.runtime.protobuf.wire import (
    put_msg,
    put_str,
    put_varint,
    scan_fields,
)


class JobDescription:
    """message JobDescription — one micro-task of a RunJob dispatch."""

    def __init__(
        self,
        job_id: int = 0,
        job_type: str = "",
        command: str = "",
        working_directory: str = "",
        needs_data_dir: bool = False,
        num_steps_arg: str = "",
        num_steps: int = 0,
        has_duration: bool = False,
        duration: int = 0,
        trace_context: str = "",
    ):
        self.job_id = int(job_id)
        self.job_type = job_type
        self.command = command
        self.working_directory = working_directory
        self.needs_data_dir = bool(needs_data_dir)
        self.num_steps_arg = num_steps_arg
        self.num_steps = int(num_steps)
        self.has_duration = bool(has_duration)
        self.duration = int(duration)
        self.trace_context = trace_context

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        out = bytearray()
        put_varint(out, 1, self.job_id)
        put_str(out, 2, self.job_type)
        put_str(out, 3, self.command)
        put_str(out, 4, self.working_directory)
        put_varint(out, 5, int(self.needs_data_dir))
        put_str(out, 6, self.num_steps_arg)
        put_varint(out, 7, self.num_steps)
        put_varint(out, 8, int(self.has_duration))
        put_varint(out, 9, self.duration)
        put_str(out, 10, self.trace_context)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "JobDescription":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.job_id = int(value)
            elif field == 2 and wire_type == 2:
                msg.job_type = value.decode("utf-8")
            elif field == 3 and wire_type == 2:
                msg.command = value.decode("utf-8")
            elif field == 4 and wire_type == 2:
                msg.working_directory = value.decode("utf-8")
            elif field == 5 and wire_type == 0:
                msg.needs_data_dir = bool(value)
            elif field == 6 and wire_type == 2:
                msg.num_steps_arg = value.decode("utf-8")
            elif field == 7 and wire_type == 0:
                msg.num_steps = int(value)
            elif field == 8 and wire_type == 0:
                msg.has_duration = bool(value)
            elif field == 9 and wire_type == 0:
                msg.duration = int(value)
            elif field == 10 and wire_type == 2:
                msg.trace_context = value.decode("utf-8")
        return msg


class RunJobRequest:
    """message RunJobRequest { job_descriptions, worker_id, round_id,
    sched_epoch }"""

    def __init__(
        self,
        job_descriptions: Optional[List[JobDescription]] = None,
        worker_id: int = 0,
        round_id: int = 0,
        sched_epoch: int = 0,
    ):
        self.job_descriptions = (
            list(job_descriptions) if job_descriptions else []
        )
        self.worker_id = int(worker_id)
        self.round_id = int(round_id)
        self.sched_epoch = int(sched_epoch)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        for description in self.job_descriptions:
            put_msg(out, 1, description.SerializeToString())
        put_varint(out, 2, self.worker_id)
        put_varint(out, 3, self.round_id)
        put_varint(out, 4, self.sched_epoch)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "RunJobRequest":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 2:
                msg.job_descriptions.append(JobDescription.FromString(value))
            elif field == 2 and wire_type == 0:
                msg.worker_id = int(value)
            elif field == 3 and wire_type == 0:
                msg.round_id = int(value)
            elif field == 4 and wire_type == 0:
                msg.sched_epoch = int(value)
        return msg


class KillJobRequest:
    """message KillJobRequest { job_id, trace_context, sched_epoch }"""

    def __init__(
        self, job_id: int = 0, trace_context: str = "", sched_epoch: int = 0
    ):
        self.job_id = int(job_id)
        self.trace_context = trace_context
        self.sched_epoch = int(sched_epoch)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        put_varint(out, 1, self.job_id)
        put_str(out, 2, self.trace_context)
        put_varint(out, 3, self.sched_epoch)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "KillJobRequest":  # noqa: N802
        msg = cls()
        for field, wire_type, value in scan_fields(data):
            if field == 1 and wire_type == 0:
                msg.job_id = int(value)
            elif field == 2 and wire_type == 2:
                msg.trace_context = value.decode("utf-8")
            elif field == 3 and wire_type == 0:
                msg.sched_epoch = int(value)
        return msg
