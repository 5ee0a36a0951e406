"""The job record.

Carries what the scheduler needs to know about one training job: which model
family / batch size it is (encoded in ``job_type`` as ``"Model (batch size
N)"``), the launch command, how many steps remain, how many accelerators it
gangs over (``scale_factor``), and its dynamic-adaptation mode
(static / accordion / gns).

Capability parity with reference: scheduler/job.py:1-146.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Job:
    job_type: str
    command: str = ""
    working_directory: str = ""
    num_steps_arg: str = "-n"
    total_steps: int = 0
    duration: Optional[float] = None
    mode: str = "static"  # static | accordion | gns
    scale_factor: int = 1
    priority_weight: float = 1.0
    SLO: Optional[float] = None
    needs_data_dir: bool = False
    job_id: Optional[int] = None
    # The submitting tenant, carried on the SubmitJobs wire and judged
    # against per-tenant admission quotas (empty: no quota). Not part of
    # the trace format.
    tenant: str = ""
    # The job's causal root context, carried on the SubmitJobs wire
    # (obs/propagate.py encoding); empty: untraced. Not part of the trace
    # format.
    trace_context: str = ""

    def __post_init__(self):
        if self.SLO is not None and self.SLO < 0:
            self.SLO = None

    # ``job_type`` is the single source of truth for (model, batch size),
    # matching the reference's string encoding (scheduler/job.py:119-129).
    @property
    def model(self) -> str:
        from shockwave_tpu_torch.data.workload_info import parse_job_type

        return parse_job_type(self.job_type)[0]

    @property
    def batch_size(self) -> int:
        from shockwave_tpu_torch.data.workload_info import parse_job_type

        return parse_job_type(self.job_type)[1]

    def job_type_key(self):
        return (self.job_type, self.scale_factor)

    def to_trace_line(self) -> str:
        """The trace format's first 11 tab-separated fields (the trace
        writer appends the arrival time)."""
        slo = -1.0 if self.SLO is None else self.SLO
        return "\t".join(
            [
                self.job_type,
                self.command,
                self.working_directory,
                self.num_steps_arg,
                "%d" % int(self.needs_data_dir),
                "%d" % self.total_steps,
                "%d" % self.scale_factor,
                self.mode,
                "%g" % self.priority_weight,
                "%f" % slo,
                "%g" % float(self.duration if self.duration else 0),
            ]
        )

    def update_batch_size(self, new_bs: int) -> None:
        """Rewrite job_type and command for a new batch size.

        The batch-size argument is the last token of the command for most
        workloads; translation/imagenet commands carry one trailing
        positional/flag argument after it (reference: job.py:131-146).
        """
        if "translation" not in self.command and "imagenet" not in self.command:
            self.command = self.command[: self.command.rfind(" ")] + f" {new_bs}"
        else:
            last = self.command.rfind(" ")
            second_last = self.command[:last].rfind(" ")
            self.command = (
                self.command[:second_last] + f" {new_bs}" + self.command[last:]
            )
        self.job_type = self.job_type[: self.job_type.rfind(" ")] + f" {new_bs})"
