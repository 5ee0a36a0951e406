"""Shared helpers for driving a real localhost cluster of the port.

The port of the JAX package's ``runtime/testing.py``, used by the
wall-clock tests (tests/test_torch_runtime.py) and the smoke run on the
card, so the synthetic-workload Job contract, the dispatcher
progress-line parsing, and the scheduler+worker bring-up exist exactly
once. The synthetic payload is :mod:`shockwave_tpu_torch.runtime.synthetic`.
"""

from __future__ import annotations

import os
import re
import socket
import sys
from typing import Dict

from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.runtime.dispatcher import _PROGRESS_RE as PROGRESS_RE

SYNTHETIC_WORKLOAD = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "synthetic.py"
)


def free_port() -> int:
    """Ask the kernel for a free TCP port (bind to port 0, release)."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def make_synthetic_job(
    total_steps: int,
    steps_per_sec: float = 200,
    scale_factor: int = 1,
    extra_args: str = "",
) -> Job:
    """A Job whose payload is the synthetic training workload."""
    return Job(
        job_type="ResNet-18 (batch size 32)",
        command=(
            f"{sys.executable} {SYNTHETIC_WORKLOAD}"
            f" --steps_per_sec {steps_per_sec} --batch_size 32{extra_args}"
        ),
        num_steps_arg="-n",
        total_steps=total_steps,
        scale_factor=scale_factor,
        mode="static",
    )


def start_local_cluster(
    policy_name: str,
    num_accelerators: int,
    run_dir: str,
    checkpoint_dir: str,
    round_duration: float = 3.0,
    wait_timeout_s: float = None,
    device: str = "cpu",
    **sched_kwargs,
):
    """One PhysicalScheduler + one registered localhost worker; returns
    the scheduler (the worker object lives in daemon threads).

    ``wait_timeout_s`` bounds the registration wait (default: the
    ``SHOCKWAVE_WORKER_WAIT_S`` env var, else 30 s — loaded CI hosts can
    raise it without touching call sites); on expiry the scheduler's
    TimeoutError lists exactly which workers did register so the
    missing one is identifiable from the message alone. ``device`` is
    the worker's (the payloads' device; the synthetic payload ignores
    it) and the planner's."""
    from shockwave_tpu_torch.core.physical import PhysicalScheduler
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.runtime.worker import Worker

    sched_port, worker_port = free_port(), free_port()
    sched = PhysicalScheduler(
        get_policy(policy_name, device=device),
        port=sched_port,
        throughputs=sched_kwargs.pop("throughputs", generate_oracle()),
        time_per_iteration=round_duration,
        completion_buffer_seconds=sched_kwargs.pop(
            "completion_buffer_seconds", 6.0
        ),
        minimum_time_between_allocation_resets=sched_kwargs.pop(
            "minimum_time_between_allocation_resets", 0.0
        ),
        **sched_kwargs,
    )
    Worker(
        "v100",
        num_accelerators,
        "127.0.0.1",
        sched_port,
        worker_port,
        run_dir=run_dir,
        checkpoint_dir=checkpoint_dir,
        device=device,
    )
    if wait_timeout_s is None:
        wait_timeout_s = float(os.environ.get("SHOCKWAVE_WORKER_WAIT_S", 30))
    sched.wait_for_workers(num_accelerators, timeout=wait_timeout_s)
    return sched


def parse_round_rates(run_dir: str) -> Dict[int, Dict[int, float]]:
    """{round_id: {job_id: steps_per_sec}} from the dispatcher's per-round
    iterator logs. Progress lines are cumulative per log; the LAST line's
    (steps, duration) pair is that round's totals — steps and durations
    from different logs are never mixed."""
    per_round: Dict[int, Dict[int, float]] = {}
    for name in os.listdir(run_dir):
        m = re.match(r"job=(\d+)_worker=\d+_round=(\d+)\.log$", name)
        if not m:
            continue
        with open(os.path.join(run_dir, name)) as f:
            matches = PROGRESS_RE.findall(f.read())
        if matches:
            steps, dur = matches[-1]
            if float(dur) > 0:
                per_round.setdefault(int(m.group(2)), {})[
                    int(m.group(1))
                ] = int(steps) / float(dur)
    return per_round


def distinct_rounds_launched(run_dir, job_integer: int) -> set:
    """Round ids for which the dispatcher launched this job at least once
    (any log or stdout file). The durable witness for retries — unlike
    the synthetic workload's attempts.txt, whose truncate-and-rewrite
    counter loses increments when gang ranks race it."""
    rounds = set()
    for name in os.listdir(str(run_dir)):
        m = re.match(rf"job={job_integer}_worker=\d+_round=(\d+)\.", name)
        if m:
            rounds.add(int(m.group(1)))
    return rounds
