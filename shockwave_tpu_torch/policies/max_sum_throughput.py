"""Throughput-sum maximization, optionally normalized by cost and with
SLO rate constraints; a program whose SLOs are out of reach is solved
again without them. The port of the JAX package's
``shockwave_tpu/policies/max_sum_throughput.py``. The scheduler passes no
``instance_costs``, so the cost-normalized programs run with unit costs.
"""

from __future__ import annotations

import numpy as np

from shockwave_tpu_torch.policies.base import (
    Policy,
    PolicyWithPacking,
    constraint_matrices,
    packed_constraint_matrices,
)
from shockwave_tpu_torch.policies.lp_backend import max_sum_lp_general


def _max_reachable_rate(tputs: np.ndarray, caps: np.ndarray) -> float:
    """A single job's best achievable effective rate when it may split
    its one unit of time share across worker types, each capped at
    ``caps[w]`` (= min(1, num_workers/scale_factor), or 0 for cells the
    LP forces to zero): fill types in descending-throughput order."""
    order = np.argsort(-tputs)
    share_left = 1.0
    rate = 0.0
    for w in order:
        take = min(caps[w], share_left)
        if take <= 0:
            continue
        rate += float(tputs[w]) * take
        share_left -= take
        if share_left <= 0:
            break
    return rate


class ThroughputNormalizedByCostSumWithPerfSLOs(Policy):
    name = "ThroughputNormalizedByCostSum_PerfSLOs"

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        cluster_spec,
        instance_costs=None,
        SLOs=None,
        num_steps_remaining=None,
    ):
        SLOs = SLOs or {}
        num_steps_remaining = num_steps_remaining or {}
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        job_ids, worker_types = index
        sf = self.scale_factors_array(scale_factors, job_ids, m, n)

        costs = np.ones(n)
        if instance_costs is not None:
            costs = np.array([instance_costs[wt] for wt in worker_types])
        objective = (matrix / costs[None, :]).reshape(-1)

        A_base, b_base = constraint_matrices(sf, self._num_workers)
        rows, rhs = [], []
        for job_id in SLOs:
            i = job_ids.index(job_id)
            required = num_steps_remaining[job_id] / SLOs[job_id]
            # A job whose deadline is already out of reach even with the
            # largest share the capacity constraints allow it alone
            # (time split across types, each x <= num_workers /
            # scale_factor and <= 1) would make the whole LP
            # infeasible; pruning it keeps the deadlines still in reach
            # enforceable. (Gavel re-solves with every SLO dropped on
            # any infeasibility: one doomed job disables SLO steering
            # for all.)
            cap = np.minimum(
                1.0,
                np.asarray(self._num_workers, dtype=float)
                / np.maximum(sf[i], 1e-9),
            )
            if required > _max_reachable_rate(matrix[i], cap) + 1e-12:
                continue
            row = np.zeros(m * n)
            row[i * n : (i + 1) * n] = -matrix[i]
            rows.append(row)
            rhs.append(-required)
        if rows:
            A = np.vstack([A_base, np.array(rows)])
            b = np.concatenate([b_base, np.array(rhs)])
            x = max_sum_lp_general(objective, A, b)
            if x is None:
                # The deadlines together are still out of reach: drop
                # the SLOs.
                x = max_sum_lp_general(objective, A_base, b_base)
        else:
            x = max_sum_lp_general(objective, A_base, b_base)
        if x is None:
            return None
        return self.unflatten(x.reshape(m, n).clip(0.0, 1.0), index)


class ThroughputSumWithPerf(Policy):
    name = "ThroughputSumWithPerf"

    def __init__(self):
        super().__init__()
        self._policy = ThroughputNormalizedByCostSumWithPerfSLOs()

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        return self._policy.get_allocation(throughputs, scale_factors, cluster_spec)


class ThroughputNormalizedByCostSumWithPerf(Policy):
    name = "ThroughputNormalizedByCostSum_Perf"

    def __init__(self):
        super().__init__()
        self._policy = ThroughputNormalizedByCostSumWithPerfSLOs()

    def get_allocation(
        self, throughputs, scale_factors, cluster_spec, instance_costs=None
    ):
        return self._policy.get_allocation(
            throughputs, scale_factors, cluster_spec, instance_costs=instance_costs
        )


class ThroughputNormalizedByCostSumWithPackingSLOs(PolicyWithPacking):
    name = "ThroughputNormalizedByCostSum_PackingSLOs"

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        cluster_spec,
        instance_costs=None,
        SLOs=None,
        num_steps_remaining=None,
    ):
        SLOs = SLOs or {}
        num_steps_remaining = num_steps_remaining or {}
        all_m, index = self.flatten(throughputs, cluster_spec)
        if all_m is None or len(all_m) == 0:
            return None
        job_ids, single_job_ids, worker_types, relevant = index
        C, W = len(job_ids), len(worker_types)
        S = len(single_job_ids)
        sf = self.scale_factors_array(scale_factors, job_ids, C, W)

        costs = np.ones(W)
        if instance_costs is not None:
            costs = np.array([instance_costs[wt] for wt in worker_types])
        # Each single's effective throughput summed over the singles
        # gives the objective of a cell.
        objective = (all_m / costs[None, None, :]).sum(axis=0).reshape(-1)

        A_base, b_base = packed_constraint_matrices(
            sf, self._num_workers, single_job_ids, relevant
        )
        zero_mask = (sf.reshape(-1) == 0).astype(bool)
        rows, rhs = [], []
        coeff = all_m.reshape(S, C * W)
        cap = np.minimum(
            1.0,
            np.asarray(self._num_workers, dtype=float)[None, :]
            / np.maximum(sf, 1e-9),
        ).reshape(-1)
        # Cells the LP pins to zero (mixed-scale pairs) can't contribute.
        cap[zero_mask] = 0.0
        for job_id in SLOs:
            i = single_job_ids.index(job_id)
            required = num_steps_remaining[job_id] / SLOs[job_id]
            # Same doomed-deadline pruning as the unpacked variant.
            if required > _max_reachable_rate(coeff[i], cap) + 1e-12:
                continue
            rows.append(-coeff[i])
            rhs.append(-required)
        if rows:
            A = np.vstack([A_base, np.array(rows)])
            b = np.concatenate([b_base, np.array(rhs)])
            x = max_sum_lp_general(objective, A, b, zero_mask=zero_mask)
            if x is None:
                x = max_sum_lp_general(
                    objective, A_base, b_base, zero_mask=zero_mask
                )
        else:
            x = max_sum_lp_general(objective, A_base, b_base, zero_mask=zero_mask)
        if x is None:
            return None
        return self.unflatten(x.reshape(C, W).clip(0.0, 1.0), index)
