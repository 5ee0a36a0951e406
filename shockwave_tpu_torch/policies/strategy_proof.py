"""Strategy-proof max-min fairness: maximize the geometric mean of the
normalized effective throughputs (proportional fairness), then discount
each job's allocation by its leave-one-out externality, so that
misreporting throughputs cannot help. The port of
``MaxMinFairnessStrategyProofPolicyWithPerf`` of the JAX package's
``shockwave_tpu/policies/strategy_proof.py``.

The geo-mean program max prod_i (c_i . x_i)^(1/m) == max sum_i log(c_i .
x_i) is solved with SLSQP over the base polytope (small, smooth,
concave). ``get_allocation`` returns the allocation and the discount
factors. Where a leave-one-out sub-problem has no allocation (no jobs
left, or SLSQP fails), it raises ``RuntimeError`` naming the job left
out, where the JAX package fails on the missing result.
"""

from __future__ import annotations

import copy

import numpy as np
from scipy.optimize import LinearConstraint, minimize

from shockwave_tpu_torch.policies.base import Policy, constraint_matrices
from shockwave_tpu_torch.policies.isolated import ProportionalPolicy


def _max_log_sum(coeffs: np.ndarray, A_base, b_base) -> np.ndarray | None:
    """maximize sum_i log(coeffs[i] . x[i]) over the base polytope."""
    m, n = coeffs.shape
    n_var = m * n

    def rates(x):
        return np.maximum((coeffs * x.reshape(m, n)).sum(axis=1), 1e-12)

    def neg_obj(x):
        return -float(np.sum(np.log(rates(x))))

    def grad(x):
        r = rates(x)
        g = -(coeffs / r[:, None])
        return g.reshape(-1)

    # Feasible interior start: an equal split scaled to strict feasibility.
    x0 = np.full(n_var, 1.0 / (m * n))
    scale = np.max(A_base @ x0 / np.maximum(b_base, 1e-12))
    if scale > 0:
        x0 = x0 / (scale * 1.01)
    res = minimize(
        neg_obj,
        x0,
        jac=grad,
        method="SLSQP",
        bounds=[(0, None)] * n_var,
        constraints=[LinearConstraint(A_base, -np.inf, b_base)],
        options={"maxiter": 200, "ftol": 1e-10},
    )
    if not res.success and res.status != 4:  # 4: inequality incompatible noise
        return None
    return res.x.reshape(m, n)


class MaxMinFairnessStrategyProofPolicyWithPerf(Policy):
    name = "MaxMinFairness_Perf"

    def __init__(self):
        super().__init__()
        self._proportional_policy = ProportionalPolicy()

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        cluster_spec,
        recurse_deeper=True,
    ):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        job_ids, _ = index

        if recurse_deeper:
            # Leave-one-out solves for the externality discounts.
            all_throughputs_minus_job = []
            for job_id in job_ids:
                minus = copy.copy(throughputs)
                del minus[job_id]
                minus_job = self.get_allocation(
                    minus,
                    scale_factors,
                    priority_weights,
                    cluster_spec,
                    recurse_deeper=False,
                )
                if minus_job is None:
                    # The JAX package fails here too (an AttributeError
                    # on the missing sub-problem's result).
                    raise RuntimeError(
                        "strategy-proof max-min: the leave-one-out "
                        f"sub-problem without job {job_id} ({len(minus)} "
                        "jobs) has no allocation"
                    )
                all_throughputs_minus_job.append(minus_job)

        sf = self.scale_factors_array(scale_factors, job_ids, m, n)
        inv_priority = np.array(
            [1.0 / priority_weights[j] for j in job_ids]
        ).reshape((m, 1))
        proportional = self._proportional_policy.get_throughputs(
            matrix, index, self._num_workers
        ).reshape((m, 1))
        coeffs = matrix * inv_priority / proportional * sf

        A_base, b_base = constraint_matrices(sf, self._num_workers)
        x = _max_log_sum(coeffs, A_base, b_base)
        if x is None:
            return None

        effective = (matrix * x).sum(axis=1)
        throughputs_dict = {job_ids[i]: effective[i] for i in range(m)}
        if not recurse_deeper:
            return throughputs_dict

        # discount_i = prod over the others of (their throughput with i
        # present / their throughput with i absent) <= 1.
        discount_factors = np.zeros(m)
        for i, job_id in enumerate(job_ids):
            d = 1.0
            for other, minus_val in all_throughputs_minus_job[i].items():
                d *= throughputs_dict[other] / max(minus_val, 1e-12)
            discount_factors[i] = d
        discounted = (x.T * discount_factors).T
        return (
            self.unflatten(discounted.clip(0.0, 1.0), index),
            discount_factors,
        )
