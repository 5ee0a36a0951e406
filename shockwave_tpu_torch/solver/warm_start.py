"""Incremental delta-replanning: the previous plan's solution aligned
across arrivals, departures and reclaims.

The part of the JAX package's ``shockwave_tpu/solver/warm_start.py`` that
the planner's PDHG backend consumes (``align_rows`` and
``delta_patch_counts``, :332-399), in numpy as there. That module's
other half, the serialized-XLA-executable cache (``warm``,
``warm_pdhg``, ``load``, ``cache_key``), exists to skip JAX's compile in
a fresh process and has no counterpart here: the port's kernels are
built once per source by ``shockwave_tpu_torch/ops/_build.py`` into a
library cache keyed by the sources' hash, and loaded from it by every
later process.
"""

from __future__ import annotations

import numpy as np


def align_rows(prev_ids, prev_values, new_ids, fill: float = 0.0):
    """Row insert/delete alignment of a per-job vector across a job-set
    delta: rows for departed jobs are dropped, rows for surviving jobs
    carry their previous value, and rows for new arrivals get ``fill``.
    The workhorse under :func:`delta_patch_counts`, exposed separately
    because any per-job solver state (duals, momenta) aligns the same
    way."""
    if len(prev_ids) == len(new_ids) and all(
        a is b or a == b for a, b in zip(prev_ids, new_ids)
    ):
        # No churn (the common steady-state tick between arrivals):
        # identity alignment, skip the index build + per-row lookups.
        return np.asarray(prev_values, dtype=np.float64).copy()
    index = {j: i for i, j in enumerate(prev_ids)}
    out = np.full(len(new_ids), float(fill), dtype=np.float64)
    for i, job in enumerate(new_ids):
        k = index.get(job)
        if k is not None:
            out[i] = float(prev_values[k])
    return out


def delta_patch_counts(
    prev_ids,
    prev_counts,
    new_ids,
    nworkers,
    num_gpus: float,
    future_rounds: int,
):
    """Warm-start s-vector for an incremental replan.

    ``prev_counts`` is the previous plan's rounds-held-per-job vector
    (ordered by ``prev_ids``); the result is aligned to ``new_ids``:
    departures/reclaims drop their rows, survivors keep their counts
    (the near-feasible saddle-point guess — arrivals and departures
    move few coordinates), and arrivals are seeded at an even split of
    whatever gang-round budget the surviving plan leaves free, clipped
    to the window — a feasible, zero-cliff starting point instead of
    the zero-progress log cliff an all-zeros row sits on. Returns None
    when nothing useful survives (no overlap and no budget signal).

    The job axis stays one compile per fleet-size band: the PDHG kernel
    pads jobs to :func:`shockwave_tpu_torch.solver.eg_level.num_slots_for`
    power-of-two slots, so this patcher (not the compiler) is the only
    per-arrival work.
    """
    if not len(new_ids):
        return None
    marker = -1.0
    s0 = align_rows(prev_ids, prev_counts, new_ids, fill=marker)
    new_mask = s0 == marker
    s0[new_mask] = 0.0
    if new_mask.any():
        nworkers = np.maximum(np.asarray(nworkers, dtype=np.float64), 1.0)
        used = float(np.sum(nworkers * s0))
        budget = float(num_gpus) * float(future_rounds)
        free = max(budget - used, 0.0)
        gang = float(np.sum(nworkers[new_mask]))
        seed = min(free / max(gang, 1.0), float(future_rounds))
        s0[new_mask] = seed
    return s0 if s0.any() else None
