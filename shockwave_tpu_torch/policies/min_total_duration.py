"""Makespan minimization: binary search over a horizon T for the smallest
T at which a feasibility LP ("every job finishes its remaining steps
within T") admits an allocation. The port of the JAX package's
``shockwave_tpu/policies/min_total_duration.py``.
"""

from __future__ import annotations

import numpy as np

from shockwave_tpu_torch.policies.base import (
    Policy,
    PolicyWithPacking,
    canonical_throughputs,
    constraint_matrices,
    packed_constraint_matrices,
)
from shockwave_tpu_torch.policies.lp_backend import feasibility_lp_general

MIN_T = 100.0
MAX_T = 1000000.0


def _binary_search_T(coeff_rows, num_steps, A_base, b_base, zero_mask=None):
    """The allocation of the smallest T (within 5%) with a feasible x;
    the bracket grows 10x while infeasible."""
    steps = np.asarray(num_steps, dtype=np.float64)

    def solve(T):
        return feasibility_lp_general(
            coeff_rows, steps / T, A_base, b_base, zero_mask=zero_mask
        )

    min_T, max_T = MIN_T, MAX_T
    last_max_T = MAX_T
    best = None
    while best is None:
        while 1.05 * min_T < max_T:
            T = (min_T + max_T) / 2.0
            x = solve(T)
            if x is not None:
                best = x
                max_T = T
            else:
                min_T = T
        if best is not None:
            break
        min_T, max_T = last_max_T, last_max_T * 10.0
        last_max_T *= 10.0
        if last_max_T > 1e12:
            return None
    return best


class MinTotalDurationPolicyWithPerf(Policy):
    name = "MinTotalDuration_Perf"

    def get_allocation(
        self, throughputs, scale_factors, num_steps_remaining, cluster_spec
    ):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        job_ids, _ = index
        sf = self.scale_factors_array(scale_factors, job_ids, m, n)
        coeff_rows = np.zeros((m, m * n))
        for i in range(m):
            coeff_rows[i, i * n : (i + 1) * n] = matrix[i]
        A_base, b_base = constraint_matrices(sf, self._num_workers)
        x = _binary_search_T(
            coeff_rows, [num_steps_remaining[j] for j in job_ids], A_base, b_base
        )
        if x is None:
            return None
        return self.unflatten(x.reshape(m, n).clip(0.0, 1.0), index)


class MinTotalDurationPolicy(Policy):
    """Throughput-agnostic wrapper: every type behaves like a v100."""

    name = "MinTotalDuration"

    def __init__(self):
        super().__init__()
        self._perf_policy = MinTotalDurationPolicyWithPerf()

    def get_allocation(
        self, throughputs, scale_factors, num_steps_remaining, cluster_spec
    ):
        return self._perf_policy.get_allocation(
            canonical_throughputs(throughputs), scale_factors,
            num_steps_remaining, cluster_spec,
        )


class MinTotalDurationPolicyWithPacking(PolicyWithPacking):
    name = "MinTotalDuration_Packing"

    def get_allocation(
        self, throughputs, scale_factors, num_steps_remaining, cluster_spec
    ):
        all_m, index = self.flatten(throughputs, cluster_spec)
        if all_m is None or len(all_m) == 0:
            return None
        job_ids, single_job_ids, worker_types, relevant = index
        C, W = len(job_ids), len(worker_types)
        S = len(single_job_ids)
        sf = self.scale_factors_array(scale_factors, job_ids, C, W)
        coeff_rows = all_m.reshape(S, C * W)
        A_base, b_base = packed_constraint_matrices(
            sf, self._num_workers, single_job_ids, relevant
        )
        zero_mask = (sf.reshape(-1) == 0).astype(bool)
        x = _binary_search_T(
            coeff_rows,
            [num_steps_remaining[s] for s in single_job_ids],
            A_base,
            b_base,
            zero_mask=zero_mask,
        )
        if x is None:
            return None
        return self.unflatten(x.reshape(C, W).clip(0.0, 1.0), index)
