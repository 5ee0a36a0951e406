"""Max-min fairness (least attained service), Gavel's headline policy.

Maximizes the minimum, over jobs, of priority-normalized effective
throughput. The throughput-agnostic variant runs the same program with
every throughput 1 (pure time shares). The port of the JAX package's
``shockwave_tpu/policies/max_min_fairness.py``.
"""

from __future__ import annotations

import numpy as np

from shockwave_tpu_torch.policies.base import Policy
from shockwave_tpu_torch.policies.isolated import ProportionalPolicy
from shockwave_tpu_torch.policies.lp_backend import max_min_lp


class MaxMinFairnessPolicyWithPerf(Policy):
    name = "MaxMinFairness_Perf"

    def __init__(self):
        super().__init__()
        self._proportional = ProportionalPolicy()

    def get_allocation(
        self, throughputs, scale_factors, priority_weights, cluster_spec
    ):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        job_ids, _ = index
        sf = self.scale_factors_array(scale_factors, job_ids, m, n)

        # Normalize by priority and by the job's proportional-share
        # throughput, so that "fair" means equal progress relative to an
        # equal split, and multiply by the scale factor so that gang jobs
        # are not charged per GPU.
        inv_priority = np.array(
            [1.0 / priority_weights[j] for j in job_ids]
        ).reshape((m, 1))
        proportional = self._proportional.get_throughputs(
            matrix, index, self._num_workers
        )
        coeffs = matrix * inv_priority / proportional * sf
        x = max_min_lp(coeffs, sf, self._num_workers)
        return self.unflatten(x.clip(0.0, 1.0), index)


class MaxMinFairnessPolicy(Policy):
    name = "MaxMinFairness"

    def __init__(self):
        super().__init__()
        self._perf_policy = MaxMinFairnessPolicyWithPerf()

    def get_allocation(
        self, throughputs, scale_factors, priority_weights, cluster_spec
    ):
        flat = {
            job_id: {wt: 1.0 for wt in throughputs[job_id]}
            for job_id in throughputs
        }
        return self._perf_policy.get_allocation(
            flat, scale_factors, priority_weights, cluster_spec
        )
