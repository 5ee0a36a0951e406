"""Deterministic synthetic traces.

The port's copy of the one generator of the JAX package's
``shockwave_tpu/data/generate.py`` that its runs need:
``smoke_trace_jobs`` (:183), the pipelining smoke's trace. The seeded
trace generators are not ported yet (ROADMAP.md, queue 1 item 6).
"""

from __future__ import annotations

from typing import List, Tuple

from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.data.workload_info import steps_per_epoch


def smoke_trace_jobs(
    num_jobs: int,
    epochs: int = 2,
    arrival_gap_s: float = 0.0,
) -> Tuple[List[Job], List[float]]:
    """The alternating ResNet-18/50 smoke trace: scale factors 1, 1, 2, 1
    in turn, ``epochs`` epochs each, one arrival every ``arrival_gap_s``
    seconds."""
    jobs: List[Job] = []
    arrivals: List[float] = []
    for i in range(num_jobs):
        model = ["ResNet-18", "ResNet-50"][i % 2]
        bs = 32 if model == "ResNet-18" else 64
        jobs.append(
            Job(
                job_type=f"{model} (batch size {bs})",
                command="python3 main.py",
                total_steps=steps_per_epoch(model, bs) * epochs,
                scale_factor=[1, 1, 2, 1][i % 4],
                mode="static",
            )
        )
        arrivals.append(i * arrival_gap_s)
    return jobs, arrivals
