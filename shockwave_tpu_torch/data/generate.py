"""Synthetic trace generation.

The port's copy of the JAX package's ``shockwave_tpu/data/generate.py``
(the generation semantics of the reference's
scheduler/scripts/utils/generate_trace.py and scheduler/utils.py):

  * independent seeded RNG streams for template choice, interarrival time,
    duration, scale factor and dynamic-adaptation mode (seed, seed+1, ...),
    so changing one knob does not reshuffle the others;
  * exponential interarrival times with mean ``lam`` seconds;
  * durations as whole hours from a list (Gavel style) or log-uniform
    seconds (Shockwave's dynamic traces);
  * scale factors from Gavel's 70/10/20 over {1, 2, 4} or Shockwave's
    60/30/9/1 over {1, 2, 4, 8};
  * total steps = duration x the oracle's isolated throughput on the
    reference worker type;
  * the dynamic-adaptation mode drawn per job (static / accordion / gns);
  * optional multi-priority (20% weight 5.0) and SLO (1.2 / 2.0 / 10.0
    thirds) assignment.

``smoke_trace_jobs`` is the pipelining smoke's deterministic trace.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.data.job_table import JOB_TABLE, JobTemplate
from shockwave_tpu_torch.data.trace import write_trace
from shockwave_tpu_torch.data.workload_info import steps_per_epoch

# (scale_factor -> probability); remaining mass goes to scale factor 1.
GAVEL_SCALE_FACTOR_DIST: Dict[int, float] = {1: 0.7, 2: 0.1, 4: 0.2}
SHOCKWAVE_SCALE_FACTOR_DIST: Dict[int, float] = {1: 0.6, 2: 0.3, 4: 0.09, 8: 0.01}

# (mode -> probability): the Shockwave "multigpu_dynamic" traces are half
# accordion / half gns, no static jobs.
DYNAMIC_MODE_DIST: Dict[str, float] = {"static": 0.0, "accordion": 0.5, "gns": 0.5}
STATIC_MODE_DIST: Dict[str, float] = {"static": 1.0, "accordion": 0.0, "gns": 0.0}


def exponential_interarrival(rng: random.Random, lam: float) -> float:
    """Mean-``lam``-seconds exponential draw (inverse CDF, like the
    reference so identical seeds give comparable arrival processes)."""
    return -math.log(1.0 - rng.random()) * lam


def _categorical(rng: random.Random, dist: Dict) -> object:
    r = rng.uniform(0, 1)
    acc = 0.0
    supported = None
    for value, p in dist.items():
        if p > 0:
            supported = value
        acc += p
        if p > 0 and r <= acc:
            return value
    return supported  # numerical slack: last value with nonzero mass


def _oracle_steps_per_sec(
    throughputs: dict, worker_type: str, job_type: str, scale_factor: int
) -> Optional[float]:
    entry = throughputs[worker_type].get((job_type, scale_factor))
    if entry is None:
        return None
    return float(entry["null"])


def generate_job(
    throughputs: dict,
    rng: random.Random,
    duration_rng: random.Random,
    scale_factor_rng: random.Random,
    mode_rng: random.Random,
    reference_worker_type: str = "v100",
    scale_factor_dist: Dict[int, float] = GAVEL_SCALE_FACTOR_DIST,
    mode_dist: Dict[str, float] = STATIC_MODE_DIST,
    duration_hours: Sequence[float] = (),
    min_duration_s: float = 1200.0,
    max_duration_s: float = 14400.0,
    priority_rng: Optional[random.Random] = None,
    slo_rng: Optional[random.Random] = None,
    job_table: Sequence[JobTemplate] = JOB_TABLE,
) -> Job:
    """Draw one job. Template first, then a scale factor only if the
    template trains distributed (reference utils.py:104-112 with
    always_generate_scale_factor=False)."""
    template = rng.choice(list(job_table))
    if template.distributed:
        scale_factor = int(_categorical(scale_factor_rng, scale_factor_dist))
    else:
        scale_factor = 1

    if duration_hours:
        duration = 3600.0 * duration_rng.choice(list(duration_hours))
    else:
        # Log-uniform seconds: matches the wide spread of the Shockwave
        # dynamic traces (minutes to several hours).
        duration = math.exp(
            duration_rng.uniform(
                math.log(min_duration_s), math.log(max_duration_s)
            )
        )

    mode = str(_categorical(mode_rng, mode_dist))

    job_type = template.model
    steps_per_sec = _oracle_steps_per_sec(
        throughputs, reference_worker_type, job_type, scale_factor
    )
    if steps_per_sec is None:
        raise KeyError(
            f"oracle has no throughput for {job_type!r} x{scale_factor}"
        )
    total_steps = max(1, int(duration * steps_per_sec))

    priority_weight = 1.0
    if priority_rng is not None and priority_rng.uniform(0, 1) <= 0.2:
        priority_weight = 5.0

    slo = None
    if slo_rng is not None:
        r = slo_rng.uniform(0, 1)
        slo = 1.2 if r < 1 / 3 else (2.0 if r < 2 / 3 else 10.0)

    return Job(
        job_type=job_type,
        command=template.command,
        working_directory=template.working_directory,
        num_steps_arg=template.num_steps_arg,
        needs_data_dir=template.needs_data_dir,
        total_steps=total_steps,
        duration=duration,
        scale_factor=scale_factor,
        mode=mode,
        priority_weight=priority_weight,
        SLO=slo,
    )


def generate_trace_jobs(
    num_jobs: int,
    throughputs: dict,
    seed: int = 0,
    lam: float = 0.0,
    **job_kwargs,
) -> Tuple[List[Job], List[float]]:
    """Generate ``num_jobs`` jobs with Poisson arrivals (all at t=0 when
    ``lam`` == 0). RNG stream fan-out mirrors the reference
    (generate_trace.py:35-46): seed+0 templates, +1 interarrivals,
    +2 durations, +3 scale factors, +4 modes."""
    rng = random.Random(seed)
    interarrival_rng = random.Random(seed + 1)
    duration_rng = random.Random(seed + 2)
    scale_factor_rng = random.Random(seed + 3)
    mode_rng = random.Random(seed + 4)

    jobs: List[Job] = []
    arrivals: List[float] = []
    t = 0.0
    for i in range(num_jobs):
        jobs.append(
            generate_job(
                throughputs,
                rng,
                duration_rng,
                scale_factor_rng,
                mode_rng,
                **job_kwargs,
            )
        )
        if i > 0 and lam > 0:
            t += exponential_interarrival(interarrival_rng, lam)
        arrivals.append(round(t))
    return jobs, arrivals


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


def generate_trace_file(
    path: str,
    num_jobs: int,
    throughputs: dict,
    seed: int = 0,
    lam: float = 0.0,
    **job_kwargs,
) -> Tuple[List[Job], List[float]]:
    jobs, arrivals = generate_trace_jobs(
        num_jobs, throughputs, seed=seed, lam=lam, **job_kwargs
    )
    write_trace(path, jobs, arrivals)
    return jobs, arrivals


def style_job_kwargs(style: str, multi_gpu: bool = True) -> dict:
    """Generation kwargs for the two canonical workload styles, shared
    by every simulation and sweep CLI: "shockwave" = dynamic-adaptation jobs
    (accordion/gns, 60/30/9/1 scale factors, log-uniform durations);
    "gavel" = static jobs with whole-hour durations."""
    if style == "shockwave":
        return dict(
            scale_factor_dist=SHOCKWAVE_SCALE_FACTOR_DIST,
            mode_dist=DYNAMIC_MODE_DIST,
        )
    if style == "gavel":
        return dict(
            scale_factor_dist=(
                GAVEL_SCALE_FACTOR_DIST if multi_gpu else {1: 1.0}
            ),
            mode_dist=STATIC_MODE_DIST,
            duration_hours=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
        )
    raise ValueError(f"unknown workload style {style!r}")
