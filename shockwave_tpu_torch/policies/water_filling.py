"""Max-min fairness by iterative water-filling.

Lexicographic max-min: raise the common normalized-effective-throughput
level of every unsaturated job, find the bottleneck jobs that cannot rise
further, freeze them at their level, and go on with the rest. Entity
priority reweighting is supported ("fairness" splits an entity's weight
across its active jobs; "fifo" activates an entity's jobs one at a
time). The port of the JAX package's
``shockwave_tpu/policies/water_filling.py``: the level raise is an LP on
HiGHS, and bottleneck detection a per-job feasibility LP (job i is
saturated iff no feasible allocation pushes it ``SLACK`` above its
current level while every job keeps its lower bound). The packed variant
runs the same algorithm over the combinations of ``PolicyWithPacking``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.optimize import linprog

from shockwave_tpu_torch.policies.base import (
    Policy,
    PolicyWithPacking,
    constraint_matrices,
    packed_constraint_matrices,
)
from shockwave_tpu_torch.policies.isolated import ProportionalPolicy

SLACK = 1.0001
EPSILON = 1e-5


class WaterFillingAlgorithm:
    """Shared core: operates on generic objective rows (one per job) over
    vec(x), so the perf and packing variants differ only in how rows and
    base constraints are built."""

    def __init__(self, priority_reweighting_policies=None):
        self._priority_reweighting_policies = priority_reweighting_policies

    def _compute_priority_weights(
        self, entity_weights, priority_weights, entity_to_job_mapping, finalized,
        job_ids,
    ):
        """The per-job weights of this iteration; ``priority_weights``
        as given without priority reweighting."""
        if self._priority_reweighting_policies is None:
            return priority_weights
        if entity_to_job_mapping is None:
            raise ValueError(
                "entity_to_job_mapping required with priority reweighting"
            )
        out: Dict = {}
        for entity_id, entity_jobs in entity_to_job_mapping.items():
            policy = self._priority_reweighting_policies[entity_id]
            entity_weight = entity_weights[entity_id]
            if policy == "fairness":
                total = sum(
                    float(priority_weights[j])
                    for j in entity_jobs
                    if j not in finalized
                )
                for j in entity_jobs:
                    if j in finalized or total == 0.0:
                        out[j] = 0.0
                    else:
                        out[j] = entity_weight * float(priority_weights[j]) / total
            elif policy == "fifo":
                entity_jobs.sort()
                given = False
                for j in entity_jobs:
                    if j not in finalized and not given:
                        out[j] = entity_weight
                        given = True
                    else:
                        out[j] = 0.0
            else:
                raise ValueError(f"Unknown priority reweighting policy {policy!r}")
        return out

    def _raise_level(
        self, coeff_rows, weights, lower_bounds, unsaturated, A_base, b_base,
        zero_mask=None,
    ):
        """LP: maximize t s.t. weights_i * (net_i - lower_i) >= t for
        unsaturated i; net_j >= lower_j for all j."""
        n_var = coeff_rows.shape[1]
        n_rows = A_base.shape[0] + len(lower_bounds) + int(np.sum(unsaturated))
        A = np.zeros((n_rows, n_var + 1))
        b = np.zeros(n_rows)
        A[: A_base.shape[0], :n_var] = A_base
        b[: A_base.shape[0]] = b_base
        r = A_base.shape[0]
        for i in range(len(lower_bounds)):
            A[r, :n_var] = -coeff_rows[i]
            b[r] = -lower_bounds[i]
            r += 1
        for i in np.where(unsaturated)[0]:
            A[r, :n_var] = -weights[i] * coeff_rows[i]
            A[r, -1] = 1.0
            b[r] = -weights[i] * lower_bounds[i]
            r += 1
        c = np.zeros(n_var + 1)
        c[-1] = -1.0
        bounds = [
            (0, 0) if zero_mask is not None and zero_mask[i] else (0, None)
            for i in range(n_var)
        ]
        bounds.append((None, None))
        res = linprog(c, A_ub=A, b_ub=b, bounds=bounds, method="highs")
        if not res.success:
            return None, None, None
        # Duals of the per-job level rows: only jobs whose row binds with
        # a nonzero multiplier can be bottlenecks this round — the rest
        # provably have headroom, so the saturation probe can skip them.
        level_duals = np.zeros(len(lower_bounds))
        level_duals[np.where(unsaturated)[0]] = res.ineqlin.marginals[
            A_base.shape[0] + len(lower_bounds):
        ]
        return res.x[:n_var], res.x[-1], level_duals

    def _is_saturated(
        self, i, A_sat, b_base, coeff_rows, lower_bounds, zero_mask=None
    ):
        """Feasibility LP: can job i exceed its level by SLACK while every
        job keeps its lower bound? ``A_sat`` is the prebuilt
        [A_base; -coeff_rows] matrix: only the right-hand side changes
        per probe."""
        n_var = coeff_rows.shape[1]
        target = lower_bounds.copy()
        target[i] = lower_bounds[i] * SLACK + EPSILON
        b = np.concatenate([b_base, -target])
        bounds = [
            (0, 0) if zero_mask is not None and zero_mask[j] else (0, None)
            for j in range(n_var)
        ]
        res = linprog(
            np.zeros(n_var), A_ub=A_sat, b_ub=b, bounds=bounds,
            method="highs",
        )
        return not res.success

    def _run(
        self,
        job_ids,
        coeff_rows,
        scale_factors_vec,
        priority_weights,
        entity_weights,
        entity_to_job_mapping,
        A_base,
        b_base,
        zero_mask=None,
    ):
        m = len(job_ids)
        lower_bounds = np.zeros(m)
        finalized: Dict = {}
        x = None
        prev_level = None
        A_sat = np.vstack([A_base, -coeff_rows])
        for _ in range(m + 1):
            weights_dict = self._compute_priority_weights(
                entity_weights, priority_weights, entity_to_job_mapping,
                finalized, job_ids,
            )
            weights = np.array(
                [
                    float(weights_dict[j]) * scale_factors_vec[i]
                    for i, j in enumerate(job_ids)
                ]
            )
            unsaturated = np.array(
                [
                    j not in finalized and weights[i] > 0.0
                    for i, j in enumerate(job_ids)
                ]
            )
            if not unsaturated.any():
                break
            x_new, level, level_duals = self._raise_level(
                coeff_rows, weights, lower_bounds, unsaturated, A_base, b_base,
                zero_mask,
            )
            if x_new is None:
                break
            x = x_new
            # A stalled level (no increase over the previous iteration)
            # means SOMETHING is stuck even if every binding row drew a
            # zero dual at a degenerate optimum; widen the probe to the
            # skipped set below rather than deferring detection (which
            # the m+1 iteration cap cannot always absorb).
            stalled = prev_level is not None and level - prev_level <= 1e-9
            prev_level = level
            nets = coeff_rows @ x
            for i in np.where(unsaturated)[0]:
                lower_bounds[i] = nets[i]
            candidates = [
                i for i in np.where(unsaturated)[0]
                if abs(level_duals[i]) > 1e-9
            ]
            skipped = [
                i for i in np.where(unsaturated)[0] if i not in candidates
            ]
            newly_saturated = []
            for i in candidates:
                if self._is_saturated(
                    i, A_sat, b_base, coeff_rows, lower_bounds, zero_mask
                ):
                    newly_saturated.append(i)
            if not newly_saturated or stalled:
                # A degenerate optimum can leave a genuinely stuck job
                # with a zero dual on its binding row; before concluding
                # nothing is stuck (or when the level has stopped rising),
                # probe the jobs the filter skipped.
                for i in skipped:
                    if self._is_saturated(
                        i, A_sat, b_base, coeff_rows, lower_bounds, zero_mask
                    ):
                        newly_saturated.append(i)
            if not newly_saturated:
                # Nothing is provably stuck: the remaining jobs rose
                # together and will again; finalize them all at this level.
                for i in np.where(unsaturated)[0]:
                    finalized[job_ids[i]] = lower_bounds[i]
                break
            for i in newly_saturated:
                finalized[job_ids[i]] = lower_bounds[i]
        return x


class MaxMinFairnessWaterFillingPolicyWithPerf(Policy, WaterFillingAlgorithm):
    name = "MaxMinFairnessWaterFilling_Perf"

    def __init__(self, priority_reweighting_policies=None):
        Policy.__init__(self)
        WaterFillingAlgorithm.__init__(self, priority_reweighting_policies)
        self._proportional = ProportionalPolicy()

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        cluster_spec,
        entity_weights=None,
        entity_to_job_mapping=None,
    ):
        matrix, index = self.flatten(throughputs, cluster_spec)
        if matrix is None:
            return None
        m, n = matrix.shape
        job_ids, _ = index
        sf = self.scale_factors_array(scale_factors, job_ids, m, n)
        proportional = self._proportional.get_throughputs(
            matrix, index, self._num_workers
        ).reshape(-1)
        coeff_rows = np.zeros((m, m * n))
        for i in range(m):
            coeff_rows[i, i * n : (i + 1) * n] = matrix[i] / proportional[i]
        A_base, b_base = constraint_matrices(sf, self._num_workers)
        x = self._run(
            job_ids,
            coeff_rows,
            sf[:, 0],
            priority_weights,
            entity_weights,
            entity_to_job_mapping,
            A_base,
            b_base,
        )
        if x is None:
            return None
        return self.unflatten(x.reshape(m, n).clip(0.0, 1.0), index)


class MaxMinFairnessWaterFillingPolicy(Policy):
    """Throughput-agnostic water filling (time shares: all throughputs 1)."""

    name = "MaxMinFairnessWaterFilling"

    def __init__(self, priority_reweighting_policies=None):
        super().__init__()
        self._perf_policy = MaxMinFairnessWaterFillingPolicyWithPerf(
            priority_reweighting_policies
        )

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        cluster_spec,
        entity_weights=None,
        entity_to_job_mapping=None,
    ):
        flat = {
            job_id: {wt: 1.0 for wt in throughputs[job_id]}
            for job_id in throughputs
        }
        return self._perf_policy.get_allocation(
            flat,
            scale_factors,
            priority_weights,
            cluster_spec,
            entity_weights=entity_weights,
            entity_to_job_mapping=entity_to_job_mapping,
        )


class MaxMinFairnessWaterFillingPolicyWithPacking(
    PolicyWithPacking, WaterFillingAlgorithm
):
    name = "MaxMinFairnessWaterFilling_Packing"

    def __init__(self, priority_reweighting_policies=None):
        PolicyWithPacking.__init__(self)
        WaterFillingAlgorithm.__init__(self, priority_reweighting_policies)
        self._proportional = ProportionalPolicy()

    def get_allocation(
        self,
        throughputs,
        scale_factors,
        priority_weights,
        cluster_spec,
        entity_weights=None,
        entity_to_job_mapping=None,
    ):
        all_m, index = self.flatten(throughputs, cluster_spec)
        if all_m is None or len(all_m) == 0:
            return None
        job_ids, single_job_ids, worker_types, relevant = index
        C, W = len(job_ids), len(worker_types)
        S = len(single_job_ids)
        sf = self.scale_factors_array(scale_factors, job_ids, C, W)
        singles_matrix = np.array(
            [[throughputs[s][wt] for wt in worker_types] for s in single_job_ids]
        )
        proportional = self._proportional.get_throughputs(
            singles_matrix, (single_job_ids, worker_types), self._num_workers
        ).reshape(-1)
        coeff_rows = all_m.reshape(S, C * W) / proportional[:, None]
        A_base, b_base = packed_constraint_matrices(
            sf, self._num_workers, single_job_ids, relevant
        )
        zero_mask = (sf.reshape(-1) == 0).astype(bool)
        sf_vec = np.array([scale_factors[s] for s in single_job_ids], dtype=float)
        x = self._run(
            single_job_ids,
            coeff_rows,
            sf_vec,
            priority_weights,
            entity_weights,
            entity_to_job_mapping,
            A_base,
            b_base,
            zero_mask=zero_mask,
        )
        if x is None:
            return None
        return self.unflatten(x.reshape(C, W).clip(0.0, 1.0), index)
