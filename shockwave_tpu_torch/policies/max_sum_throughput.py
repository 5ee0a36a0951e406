"""Throughput-sum maximization over the base polytope.

The port of ``ThroughputSumWithPerf`` of the JAX package's
``shockwave_tpu/policies/max_sum_throughput.py``: there it runs the
cost-normalized SLO program with unit costs and no SLOs, which is this
one LP. The cost-normalized and SLO variants wait for the scheduler's
cost and SLO state (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from shockwave_tpu_torch.policies.base import Policy, constraint_matrices
from shockwave_tpu_torch.policies.lp_backend import max_sum_lp_general


class ThroughputSumWithPerf(Policy):
    name = "ThroughputSumWithPerf"

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        sf = self.scale_factors_array(scale_factors, index[0], m, n)
        A_base, b_base = constraint_matrices(sf, self._num_workers)
        x = max_sum_lp_general(matrix.reshape(-1), A_base, b_base)
        if x is None:
            return None
        return self.unflatten(x.reshape(m, n).clip(0.0, 1.0), index)
