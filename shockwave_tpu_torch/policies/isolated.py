"""Isolated allocation: the cluster split evenly across jobs, each job's
share scaled down by its gang size; used directly and as the normalizer
of finish-time fairness. The proportional split is max-min fairness's
normalizer. The port of the JAX package's
``shockwave_tpu/policies/isolated.py``."""

from __future__ import annotations

import numpy as np

from shockwave_tpu_torch.policies.base import Policy


class IsolatedPolicy(Policy):
    name = "Isolated"

    def _allocation_matrix(self, m, n, scale_factors_array, num_workers):
        x = np.tile(np.asarray(num_workers, dtype=np.float64) / m, (m, 1))
        x = x / scale_factors_array
        row_sums = np.maximum(x.sum(axis=1), 1.0)
        return x / row_sums[:, None]

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        sf = self.scale_factors_array(scale_factors, index[0], m, n)
        return self.unflatten(
            self._allocation_matrix(m, n, sf, self._num_workers), index
        )

    def get_throughputs(self, throughputs, index, scale_factors, num_workers):
        """Each job's effective throughput under the isolated allocation;
        ``num_workers`` is the per-type count list aligned with the
        flattened matrix's columns."""
        if throughputs is None:
            return None
        m, n = throughputs.shape
        sf = self.scale_factors_array(scale_factors, index[0], m, n)
        x = self._allocation_matrix(m, n, sf, num_workers)
        return (throughputs * x).sum(axis=1).reshape((m, 1))


class ProportionalPolicy(Policy):
    """Each job gets the same fraction of every worker type, normalized by
    the largest row sum."""

    name = "Proportional"

    def _allocation_matrix(self, m, num_workers):
        x = np.tile(np.asarray(num_workers, dtype=np.float64) / m, (m, 1))
        return x / x.sum(axis=1).max()

    def get_allocation(self, throughputs, cluster_spec):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, _ = matrix.shape
        return self.unflatten(self._allocation_matrix(m, self._num_workers), index)

    def get_throughputs(self, throughputs, index, num_workers):
        if throughputs is None:
            return None
        m, _ = throughputs.shape
        x = self._allocation_matrix(m, num_workers)
        return (throughputs * x).sum(axis=1).reshape((m, 1))
