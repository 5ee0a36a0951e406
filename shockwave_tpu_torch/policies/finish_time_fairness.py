"""Finish-time fairness (Themis): minimize the worst rho across jobs,
rho = expected completion time under the allocation / expected completion
time under an isolated (equal-split) share of the cluster. Stateful
across rounds: each job's realized isolated time accumulates from its
observed step progress.

The port of the JAX package's
``shockwave_tpu/policies/finish_time_fairness.py``. The optimum of
min max_i (t_i + S_i / a_i(x)) / E_i is found by bisection on rho: for a
fixed rho the set {a_i(x) >= S_i / (rho * E_i - t_i)} is a feasibility
LP (HiGHS), and rho* is the smallest feasible rho.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np

from shockwave_tpu_torch.policies.base import (
    Policy,
    PolicyWithPacking,
    canonical_throughputs,
    constraint_matrices,
    packed_constraint_matrices,
)
from shockwave_tpu_torch.policies.isolated import IsolatedPolicy
from shockwave_tpu_torch.policies.lp_backend import feasibility_lp_general


def _bisect_rho(coeff_rows, times_since_start, num_steps, isolated_times,
                A_base, b_base, zero_mask=None, tol=1e-3, max_iter=60):
    """Smallest rho with a feasible allocation; returns (rho, x)."""
    t = np.asarray(times_since_start, dtype=np.float64)
    S = np.asarray(num_steps, dtype=np.float64)
    E = np.asarray(isolated_times, dtype=np.float64)

    def rates_for(rho):
        # a_i >= S_i / (rho * E_i - t_i); infeasible if rho * E_i <= t_i
        # for a job that still has steps left.
        denom = rho * E - t
        if np.any((denom <= 0) & (S > 0)):
            return None
        with np.errstate(divide="ignore"):
            return np.where(S > 0, S / np.maximum(denom, 1e-12), 0.0)

    def solve(rho):
        rates = rates_for(rho)
        if rates is None:
            return None
        return feasibility_lp_general(
            coeff_rows, rates, A_base, b_base, zero_mask=zero_mask
        )

    lo, hi = 0.0, 1.0
    x_hi = solve(hi)
    for _ in range(60):
        if x_hi is not None:
            break
        lo, hi = hi, hi * 2.0
        x_hi = solve(hi)
    if x_hi is None:
        return None, None
    for _ in range(max_iter):
        if hi - lo <= tol * max(1.0, hi):
            break
        mid = 0.5 * (lo + hi)
        x_mid = solve(mid)
        if x_mid is not None:
            hi, x_hi = mid, x_mid
        else:
            lo = mid
    return hi, x_hi


class FinishTimeFairnessPolicyWithPerf(Policy):
    name = "FinishTimeFairness_Perf"

    def __init__(self):
        super().__init__()
        self._isolated_policy = IsolatedPolicy()
        self._cumulative_isolated_time: Dict = {}
        self._isolated_throughputs_prev_iteration: Dict = {}
        self._num_steps_remaining_prev_iteration: Dict = {}

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        times_since_start,
        num_steps_remaining,
        cluster_spec,
    ):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            self._isolated_throughputs_prev_iteration = {}
            self._num_steps_remaining_prev_iteration = {}
            return None
        m, n = matrix.shape
        job_ids, _ = index
        sf = self.scale_factors_array(scale_factors, job_ids, m, n)
        isolated_throughputs = self._isolated_policy.get_throughputs(
            matrix, index, scale_factors, self._num_workers
        ).reshape(-1)

        # Accumulate each job's realized isolated time from the progress
        # observed since the last call.
        expected_isolated = np.zeros(m)
        for i, job_id in enumerate(job_ids):
            self._cumulative_isolated_time.setdefault(job_id, 0)
            if job_id in self._num_steps_remaining_prev_iteration:
                self._cumulative_isolated_time[job_id] += (
                    self._num_steps_remaining_prev_iteration[job_id]
                    - num_steps_remaining[job_id]
                ) / self._isolated_throughputs_prev_iteration[job_id]
            expected_isolated[i] = self._cumulative_isolated_time[job_id] + (
                num_steps_remaining[job_id] / isolated_throughputs[i]
            )

        coeff_rows = np.zeros((m, m * n))
        for i in range(m):
            coeff_rows[i, i * n : (i + 1) * n] = matrix[i]
        A_base, b_base = constraint_matrices(sf, self._num_workers)
        _, x = _bisect_rho(
            coeff_rows,
            [times_since_start[j] for j in job_ids],
            [num_steps_remaining[j] for j in job_ids],
            expected_isolated,
            A_base,
            b_base,
        )

        self._num_steps_remaining_prev_iteration = copy.copy(num_steps_remaining)
        self._isolated_throughputs_prev_iteration = {
            job_ids[i]: isolated_throughputs[i] for i in range(m)
        }

        if x is None:
            # No feasible rho: fall back to the isolated allocation.
            return self._isolated_policy.get_allocation(
                throughputs, scale_factors, cluster_spec
            )
        return self.unflatten(x.reshape(m, n).clip(0.0, 1.0), index)


class FinishTimeFairnessPolicy(Policy):
    """Throughput-agnostic wrapper: every worker type behaves like a v100."""

    name = "FinishTimeFairness"

    def __init__(self):
        super().__init__()
        self._perf_policy = FinishTimeFairnessPolicyWithPerf()

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        times_since_start,
        num_steps_remaining,
        cluster_spec,
    ):
        return self._perf_policy.get_allocation(
            canonical_throughputs(throughputs),
            scale_factors,
            priority_weights,
            times_since_start,
            num_steps_remaining,
            cluster_spec,
        )


class FinishTimeFairnessPolicyWithPacking(PolicyWithPacking):
    name = "FinishTimeFairness_Packing"

    def __init__(self):
        super().__init__()
        self._isolated_policy = IsolatedPolicy()
        self._cumulative_isolated_time: Dict = {}
        self._isolated_throughputs_prev_iteration: Dict = {}
        self._num_steps_remaining_prev_iteration: Dict = {}

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        times_since_start,
        num_steps_remaining,
        cluster_spec,
    ):
        all_m, index = self.flatten(
            throughputs, cluster_spec, priority_weights=priority_weights
        )
        if all_m is None or len(all_m) == 0:
            self._isolated_throughputs_prev_iteration = {}
            self._num_steps_remaining_prev_iteration = {}
            return None
        job_ids, single_job_ids, worker_types, relevant = index
        C, W = len(job_ids), len(worker_types)
        S = len(single_job_ids)
        sf = self.scale_factors_array(scale_factors, job_ids, C, W)

        singles_matrix = np.array(
            [[throughputs[s][wt] for wt in worker_types] for s in single_job_ids]
        )
        isolated_throughputs = self._isolated_policy.get_throughputs(
            singles_matrix,
            (single_job_ids, worker_types),
            scale_factors,
            self._num_workers,
        ).reshape(-1)

        expected_isolated = np.zeros(S)
        for i, job_id in enumerate(single_job_ids):
            self._cumulative_isolated_time.setdefault(job_id, 0)
            if job_id in self._num_steps_remaining_prev_iteration:
                self._cumulative_isolated_time[job_id] += (
                    self._num_steps_remaining_prev_iteration[job_id]
                    - num_steps_remaining[job_id]
                ) / self._isolated_throughputs_prev_iteration[job_id]
            expected_isolated[i] = self._cumulative_isolated_time[job_id] + (
                num_steps_remaining[job_id] / isolated_throughputs[i]
            )

        coeff_rows = all_m.reshape(S, C * W)
        A_base, b_base = packed_constraint_matrices(
            sf, self._num_workers, single_job_ids, relevant
        )
        zero_mask = (sf.reshape(-1) == 0).astype(bool)
        _, x = _bisect_rho(
            coeff_rows,
            [times_since_start[s] for s in single_job_ids],
            [num_steps_remaining[s] for s in single_job_ids],
            expected_isolated,
            A_base,
            b_base,
            zero_mask=zero_mask,
        )

        self._num_steps_remaining_prev_iteration = copy.copy(num_steps_remaining)
        self._isolated_throughputs_prev_iteration = {
            single_job_ids[i]: isolated_throughputs[i] for i in range(S)
        }
        if x is None:
            return None
        return self.unflatten(x.reshape(C, W).clip(0.0, 1.0), index)
