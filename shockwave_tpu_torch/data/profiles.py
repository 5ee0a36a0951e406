"""Per-job epoch-profile synthesis.

The Shockwave planner consumes a per-job *epoch profile*: the batch size and
wall-clock duration of every epoch, plus totals (schema from reference:
scheduler/job_metadata.py:14-23). The reference ships these as per-trace
pickles which are stripped from its public snapshot, so this module
regenerates them from first principles:

  * the epoch count comes from the trace's total step count and initial
    batch size (epochs = ceil(steps / ceil(dataset / bs)));
  * the batch-size schedule comes from the job's dynamic-adaptation mode
    (static / accordion / gns, see :mod:`shockwave_tpu_torch.data.bs_patterns`);
  * each epoch's duration is steps-in-epoch / oracle throughput at that
    epoch's batch size on the reference worker type.

``mem_every_epoch`` / ``util_every_epoch`` are carried for schema parity but
never read by the planner (reference: job_metadata.py:34-40 stores them and
no consumer exists).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.data import bs_patterns
from shockwave_tpu_torch.data.workload_info import num_epochs as epochs_for_steps
from shockwave_tpu_torch.data.workload_info import steps_per_epoch

Profile = Dict[str, object]


def _isolated_throughput(
    throughputs: dict, worker_type: str, model: str, bs: int, scale_factor: int
):
    key = ("%s (batch size %d)" % (model, bs), scale_factor)
    entry = throughputs[worker_type].get(key)
    if entry is not None:
        return entry["null"]
    return None


def synthesize_profile(
    job: Job,
    throughputs: dict,
    worker_type: str = "v100",
) -> Profile:
    """Build one job's epoch profile from the throughput oracle."""
    model = job.model
    initial_bs = job.batch_size
    total_epochs = epochs_for_steps(model, initial_bs, job.total_steps)
    bs_every_epoch = bs_patterns.pattern_for_mode(
        job.mode, job.job_type, initial_bs, total_epochs, job.scale_factor
    )

    base_tput = _isolated_throughput(
        throughputs, worker_type, model, initial_bs, job.scale_factor
    )
    if base_tput is None:
        raise KeyError(
            f"No oracle throughput for {job.job_type!r} x{job.scale_factor} "
            f"on {worker_type}"
        )

    duration_every_epoch: List[float] = []
    for bs in bs_every_epoch:
        tput = _isolated_throughput(throughputs, worker_type, model, bs, job.scale_factor)
        if tput is None or tput <= 0:
            # Unprofiled batch size: assume constant samples/s, i.e. the
            # steps/s throughput shrinks proportionally with batch growth.
            tput = base_tput * (initial_bs / bs)
        duration_every_epoch.append(steps_per_epoch(model, bs) / tput)

    return {
        "num_epochs": total_epochs,
        "num_samples_per_epoch": steps_per_epoch(model, initial_bs) * initial_bs,
        "scale_factor": job.scale_factor,
        "duration": float(sum(duration_every_epoch)),
        "bs_every_epoch": bs_every_epoch,
        "mem_every_epoch": [0.0] * total_epochs,
        "util_every_epoch": [0.0] * total_epochs,
        "duration_every_epoch": duration_every_epoch,
    }


def synthesize_profiles(
    jobs: Sequence[Job], throughputs: dict, worker_type: str = "v100"
) -> Dict[int, Profile]:
    """Profiles for all jobs of a trace, keyed by integer job index."""
    return {
        i: synthesize_profile(job, throughputs, worker_type)
        for i, job in enumerate(jobs)
    }


def _oracle_fingerprint(throughputs: dict, worker_type: str) -> str:
    import hashlib

    entries = sorted(
        (str(k), float(v["null"])) for k, v in throughputs[worker_type].items()
    )
    return hashlib.sha256(repr(entries).encode()).hexdigest()[:16]


def load_or_synthesize_profiles(
    trace_file: str,
    jobs: Sequence[Job],
    throughputs: dict,
    worker_type: str = "v100",
    cache: bool = True,
) -> Dict[int, Profile]:
    """Load ``<trace>.profile.pickle`` if present, else synthesize (and
    cache) profiles for the trace's jobs. The cache is keyed on the job
    count, worker type, and an oracle fingerprint so a pickle built against
    a different oracle is never silently reused. ``cache=False`` bypasses
    the pickle entirely — no read and no write — so hermetic callers
    (golden tests, the replication harness) always exercise the current
    synthesis code rather than machine state."""
    base, _ = os.path.splitext(trace_file)
    pickle_path = base + ".profile.pickle"
    fingerprint = _oracle_fingerprint(throughputs, worker_type)
    if cache and os.path.exists(pickle_path):
        with open(pickle_path, "rb") as f:
            cached = pickle.load(f)
        if (
            isinstance(cached, dict)
            and cached.get("worker_type") == worker_type
            and cached.get("oracle_fingerprint") == fingerprint
            and len(cached.get("profiles", ())) == len(jobs)
        ):
            return cached["profiles"]
    profiles = synthesize_profiles(jobs, throughputs, worker_type)
    if cache:
        try:
            with open(pickle_path, "wb") as f:
                pickle.dump(
                    {
                        "worker_type": worker_type,
                        "oracle_fingerprint": fingerprint,
                        "profiles": profiles,
                    },
                    f,
                )
        except OSError:
            pass
    return profiles
