"""Allocation-policy base machinery.

The port of the JAX package's ``shockwave_tpu/policies/base.py``. A
policy maps a throughput matrix (jobs x worker types) plus per-job scale
factors to a fractional time-share allocation ``{job_id: {worker_type:
fraction}}`` subject to the cluster's capacity:

  x >= 0
  sum_j scale_factor_j * x[j, w] <= num_workers[w]   (capacity per type)
  sum_w x[j, w] <= 1                                 (a job's total share)

The packed policies (``PolicyWithPacking``) allocate over combinations:
single jobs and pairs of jobs space-sharing a worker. The Shockwave
policy inherits only ``name``, which the scheduler dispatches on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from shockwave_tpu_torch.core.ids import JobId

Allocation = Dict[JobId, Dict[str, float]]


class Policy:
    """A named policy; flattens dict-of-dicts throughputs to arrays and
    back."""

    name: str = "Policy"

    def __init__(self):
        self._num_workers: Optional[List[int]] = None

    def flatten(self, throughputs: dict, cluster_spec: Dict[str, int]):
        job_ids = sorted(throughputs.keys())
        if not job_ids:
            return None, None
        worker_types = sorted(throughputs[job_ids[0]].keys())
        if not worker_types:
            return None, None
        self._num_workers = [cluster_spec[wt] for wt in worker_types]
        matrix = np.array(
            [[throughputs[j][wt] for wt in worker_types] for j in job_ids],
            dtype=np.float64,
        )
        return matrix, (job_ids, worker_types)

    def unflatten(self, matrix: np.ndarray, index) -> Allocation:
        job_ids, worker_types = index
        return {
            job_id: {wt: float(matrix[i][k]) for k, wt in enumerate(worker_types)}
            for i, job_id in enumerate(job_ids)
        }

    def scale_factors_array(
        self, scale_factors: dict, job_ids: Sequence[JobId], m: int, n: int
    ) -> np.ndarray:
        col = np.array([scale_factors[j] for j in job_ids], dtype=np.float64)
        return np.tile(col[:, None], (1, n))


class PolicyWithPacking(Policy):
    """Base for policies over packed (space-shared) job pairs.

    The packed throughput dict keys are JobIds that may be pairs; a pair's
    value per worker type is a 2-list of co-located throughputs. ``flatten``
    produces one throughput matrix per single job over all (combination,
    worker type) cells the job takes part in.
    """

    def scale_factors_array(self, scale_factors, job_ids, m, n) -> np.ndarray:
        out = np.zeros((m, n))
        for i, job_id in enumerate(job_ids):
            sfs = {scale_factors[s] for s in job_id.singletons()}
            # A pair of two scale factors is invalid: its effective
            # scale factor is 0.
            out[i, :] = sfs.pop() if len(sfs) == 1 else 0
        return out

    def flatten(self, d: dict, cluster_spec, priority_weights=None):
        job_ids = sorted(d.keys())
        if not job_ids:
            return None, None
        worker_types = sorted(d[job_ids[0]].keys())
        if not worker_types:
            return None, None
        self._num_workers = [cluster_spec[wt] for wt in worker_types]

        relevant_combinations: Dict[JobId, list] = {}
        single_job_ids = []
        for i, job_id in enumerate(job_ids):
            for single in job_id.singletons():
                relevant_combinations.setdefault(single, []).append(i)
            if not job_id.is_pair:
                single_job_ids.append(job_id)

        S, C, W = len(single_job_ids), len(job_ids), len(worker_types)
        all_m = np.zeros((S, C, W), dtype=np.float64)
        for i, single in enumerate(single_job_ids):
            for c in relevant_combinations[single]:
                job_id = job_ids[c]
                for k, wt in enumerate(worker_types):
                    if not job_id.is_pair:
                        if job_id == single:
                            all_m[i, c, k] = d[job_id][wt]
                    else:
                        idx = job_id.as_tuple().index(single[0])
                        all_m[i, c, k] = d[job_id][wt][idx]
            if priority_weights is not None:
                all_m[i] /= priority_weights[single]
        return all_m, (job_ids, single_job_ids, worker_types, relevant_combinations)

    def unflatten(self, m: np.ndarray, index) -> Allocation:
        job_ids, _, worker_types, _ = index
        return {
            job_id: {wt: float(m[i][k]) for k, wt in enumerate(worker_types)}
            for i, job_id in enumerate(job_ids)
        }


def packed_constraint_matrices(
    scale_factors_array: np.ndarray,
    num_workers: Sequence[int],
    single_job_ids: Sequence,
    relevant_combinations: dict,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (A_ub, b_ub) over vec(x) with x of shape (combinations, types):
    capacity per type, then each single job's total share <= 1."""
    C, W = scale_factors_array.shape
    rows, rhs = [], []
    for w in range(W):
        row = np.zeros(C * W)
        for c in range(C):
            row[c * W + w] = scale_factors_array[c, w]
        rows.append(row)
        rhs.append(num_workers[w])
    for single in single_job_ids:
        row = np.zeros(C * W)
        for c in relevant_combinations[single]:
            row[c * W : (c + 1) * W] = 1.0
        rows.append(row)
        rhs.append(1.0)
    return np.array(rows), np.array(rhs)


def constraint_matrices(
    scale_factors_array: np.ndarray, num_workers: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (A_ub, b_ub) for the base constraints over vec(x), without
    x >= 0, which callers give as variable bounds. Rows: capacity per
    worker type, then each job's total share."""
    m, n = scale_factors_array.shape
    rows = []
    rhs = []
    for w in range(n):
        row = np.zeros(m * n)
        for j in range(m):
            row[j * n + w] = scale_factors_array[j, w]
        rows.append(row)
        rhs.append(num_workers[w])
    for j in range(m):
        row = np.zeros(m * n)
        row[j * n : (j + 1) * n] = 1.0
        rows.append(row)
        rhs.append(1.0)
    return np.array(rows), np.array(rhs)


def canonical_throughputs(throughputs: dict) -> dict:
    """Type-agnostic throughput view: every worker type gets the job's
    canonical rate, its v100 number, or the sole type's on a single-type
    cluster. A multi-type cluster without a v100 pool is ambiguous and
    raises."""
    flat = {}
    for job_id, tput in throughputs.items():
        if "v100" in tput:
            canonical = tput["v100"]
        elif len(tput) == 1:
            canonical = next(iter(tput.values()))
        else:
            raise ValueError(
                "type-agnostic policy needs a 'v100' pool or a single "
                f"worker type, got {sorted(tput)} for job {job_id}"
            )
        flat[job_id] = {wt: canonical for wt in tput}
    return flat
