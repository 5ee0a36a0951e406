"""Trace file I/O.

Trace format: one job per line, 12 tab-separated fields
(reference: scheduler/utils.py:554-609):

  job_type  command  working_directory  num_steps_arg  needs_data_dir
  total_steps  scale_factor  mode  priority_weight  SLO  duration
  arrival_time

Arrival times must be nondecreasing.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from shockwave_tpu_torch.core.job import Job


def parse_trace(trace_file: str) -> Tuple[List[Job], List[float]]:
    jobs: List[Job] = []
    arrival_times: List[float] = []
    with open(trace_file, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            (
                job_type,
                command,
                working_directory,
                num_steps_arg,
                needs_data_dir,
                total_steps,
                scale_factor,
                mode,
                priority_weight,
                slo,
                duration,
                arrival_time,
            ) = line.split("\t")
            if int(scale_factor) < 1:
                raise ValueError(f"scale_factor must be >= 1: {line!r}")
            jobs.append(
                Job(
                    job_type=job_type,
                    command=command,
                    working_directory=working_directory,
                    num_steps_arg=num_steps_arg,
                    needs_data_dir=bool(int(needs_data_dir)),
                    total_steps=int(total_steps),
                    duration=float(duration),
                    scale_factor=int(scale_factor),
                    mode=mode,
                    priority_weight=float(priority_weight),
                    SLO=float(slo),
                )
            )
            arrival_times.append(float(arrival_time))
    for earlier, later in zip(arrival_times, arrival_times[1:]):
        if later < earlier:
            raise ValueError("arrival times in trace are not sorted")
    return jobs, arrival_times



def write_trace(
    trace_file: str, jobs: Iterable[Job], arrival_times: Iterable[float]
) -> None:
    from shockwave_tpu_torch.utils.fileio import atomic_write_text

    atomic_write_text(
        trace_file,
        "".join(
            "%s\t%g\n" % (job.to_trace_line(), float(arrival))
            for job, arrival in zip(jobs, arrival_times)
        ),
    )
