"""Max-min fairness over packed job pairs (the pairwise LP formulation):
maximize the minimum, over single jobs, of the priority-normalized
effective throughput summed across every combination the job takes part
in. The port of the JAX package's
``shockwave_tpu/policies/max_min_fairness_packed.py``.
"""

from __future__ import annotations

import numpy as np

from shockwave_tpu_torch.policies.base import (
    PolicyWithPacking,
    packed_constraint_matrices,
)
from shockwave_tpu_torch.policies.isolated import ProportionalPolicy
from shockwave_tpu_torch.policies.lp_backend import max_min_lp_general


class MaxMinFairnessPolicyWithPacking(PolicyWithPacking):
    name = "MaxMinFairness_Packing"

    def __init__(self):
        super().__init__()
        self._proportional_policy = ProportionalPolicy()

    def get_allocation(
        self, throughputs, scale_factors, priority_weights, cluster_spec
    ):
        all_m, index = self.flatten(
            throughputs, cluster_spec, priority_weights=priority_weights
        )
        if all_m is None or len(all_m) == 0:
            return None
        job_ids, single_job_ids, worker_types, relevant = index
        C, W = len(job_ids), len(worker_types)
        S = len(single_job_ids)
        sf = self.scale_factors_array(scale_factors, job_ids, C, W)

        singles_matrix = np.array(
            [[throughputs[s][wt] for wt in worker_types] for s in single_job_ids]
        )
        proportional = self._proportional_policy.get_throughputs(
            singles_matrix, (single_job_ids, worker_types), self._num_workers
        ).reshape(-1)

        # Objective row of single s: its scale-factor-weighted,
        # proportional-normalized throughput across every cell of every
        # combination it appears in.
        coeff_rows = (all_m * sf[None, :, :]).reshape(S, C * W) / proportional[
            :, None
        ]
        A_base, b_base = packed_constraint_matrices(
            sf, self._num_workers, single_job_ids, relevant
        )
        zero_mask = (sf.reshape(-1) == 0).astype(bool)
        x = max_min_lp_general(coeff_rows, A_base, b_base, zero_mask=zero_mask)
        if x is None:
            return None
        return self.unflatten(x.reshape(C, W).clip(0.0, 1.0), index)
