"""AlloX: a jobs-to-(worker, position) assignment that minimizes the total
completion time by the Hungarian method. Each worker runs its queue in
position order; a job at position p of a worker adds p times its
processing time to the sum of completion times. Scale factor 1 only.
The port of the JAX package's ``shockwave_tpu/policies/allox.py``
(``scipy.optimize.linear_sum_assignment`` on the host).
"""

from __future__ import annotations

import copy

import numpy as np
from scipy.optimize import linear_sum_assignment

from shockwave_tpu_torch.policies.base import Policy


class AlloXPolicy(Policy):
    name = "AlloX_Perf"

    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha
        self._prev_allocation = {}

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        times_since_start,
        num_steps_remaining,
        cluster_spec,
    ):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        job_ids, worker_types = index
        for job_id in scale_factors:
            if scale_factors[job_id] != 1:
                raise ValueError("AlloX supports only scale factor 1")

        # Workers already held by fully-allocated jobs are not reassigned.
        unallocated, already_allocated = [], []
        for job_id in throughputs:
            prev = self._prev_allocation.get(job_id)
            if prev is not None and sum(prev.values()) == 1.0:
                already_allocated.append(job_id)
            else:
                unallocated.append(job_id)

        worker_id_to_type = {}
        n = 0
        for wt in worker_types:
            num = cluster_spec[wt]
            for job_id in already_allocated:
                if self._prev_allocation[job_id][wt] == 1.0:
                    num -= 1
            for _ in range(num):
                worker_id_to_type[n] = wt
                n += 1

        # Oldest jobs first; optionally truncated to alpha * m.
        unallocated.sort(key=lambda j: -times_since_start[j])
        m = len(unallocated)
        unallocated = unallocated[: max(int(self._alpha * m), n)]
        m = len(unallocated)
        if m == 0 or n == 0:
            allocation = {
                job_id: {wt: 0.0 for wt in cluster_spec} for job_id in job_ids
            }
            for job_id in already_allocated:
                allocation[job_id] = copy.copy(self._prev_allocation[job_id])
            self._prev_allocation = copy.copy(allocation)
            return allocation

        # Cost of (job i, worker j, position p): the queueing delay so far
        # plus p * processing time, flattened as [q 2q 3q ...] by the
        # classic sum-of-completion-times reduction.
        q_base = np.zeros((m, n))
        for i, job_id in enumerate(unallocated):
            for j in range(n):
                tput = throughputs[job_id][worker_id_to_type[j]]
                q_base[i, j] = num_steps_remaining[job_id] / max(tput, 1e-10)
        delays = np.array([times_since_start[j] for j in unallocated])
        q = np.concatenate(
            [k * q_base + delays[:, None] for k in range(1, m + 1)], axis=1
        )

        row_idx, col_idx = linear_sum_assignment(q)

        per_worker_assignment = {j: [] for j in range(n)}
        for r, c in zip(row_idx, col_idx):
            per_worker_assignment[c % n].append((unallocated[r], c // n))
        for j in range(n):
            entries = per_worker_assignment[j]
            # Position k in the cost reduction is the k-th from the end of
            # the worker's queue.
            per_worker_assignment[j] = sorted(
                [(job_id, len(entries) - 1 - pos) for job_id, pos in entries],
                key=lambda e: e[1],
            )

        allocation = {
            job_id: {wt: 0.0 for wt in cluster_spec} for job_id in job_ids
        }
        for job_id in already_allocated:
            allocation[job_id] = copy.copy(self._prev_allocation[job_id])
        for j in range(n):
            if per_worker_assignment[j]:
                head_job = per_worker_assignment[j][0][0]
                allocation[head_job][worker_id_to_type[j]] = 1.0
        self._prev_allocation = copy.copy(allocation)
        return allocation
