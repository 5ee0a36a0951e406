"""Gandiva: time-slicing with opportunistic random packing.

When the cluster is oversubscribed, jobs are paired at random (same scale
factor only); a pair whose combined normalized throughput drops below 1.0
is dissolved. Each scheduled combination gets an equal split of the
cluster. The port of the JAX package's ``shockwave_tpu/policies/gandiva.py``:
the pairs come from ``random.Random(seed)``, the same Python stream in
both packages.
"""

from __future__ import annotations

import random

import numpy as np

from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.policies.base import PolicyWithPacking


class GandivaPolicy(PolicyWithPacking):
    name = "Gandiva_Packing"

    def __init__(self, seed=None):
        super().__init__()
        self._assigned_combinations = {}
        self._rng = random.Random(seed)

    def _equal_split(self, combos_to_schedule, index, scale_factors, cluster_spec):
        job_ids, _, worker_types, _ = index
        sf = self.scale_factors_array(
            scale_factors, job_ids, len(job_ids), len(worker_types)
        )
        x = np.zeros((len(job_ids), len(worker_types)))
        m = len(combos_to_schedule)
        for combo in combos_to_schedule:
            i = job_ids.index(combo)
            x[i] = np.array(
                [cluster_spec[wt] / m for wt in worker_types]
            ) / np.maximum(sf[i], 1.0)
        row_sums = np.maximum(x.sum(axis=1), 1.0)
        return x / row_sums[:, None]

    def _normalized_throughput(self, combo, throughputs, worker_types):
        if not combo.is_pair:
            return 0.0
        total = 0.0
        for wt in worker_types:
            packed = throughputs[combo][wt]
            for i, single in enumerate(combo.singletons()):
                if packed[i] <= 0.0:
                    return 0.0
                total += packed[i] / throughputs[single][wt]
        return total

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        all_m, index = self.flatten(throughputs, cluster_spec)
        if all_m is None or len(all_m) == 0:
            return None
        job_ids, single_job_ids, worker_types, _ = index

        # Dissolve combinations whose members left or whose packed
        # throughput fell below the isolated throughput.
        to_delete = []
        for job_id, (combo, other) in list(self._assigned_combinations.items()):
            if job_id not in job_ids or (other is not None and other not in job_ids):
                to_delete += [job_id, other]
                continue
            if (
                combo.is_pair
                and combo in throughputs
                and self._normalized_throughput(combo, throughputs, worker_types) < 1.0
            ):
                to_delete += [job_id, other]
        for job_id in to_delete:
            if job_id is not None:
                self._assigned_combinations.pop(job_id, None)

        requested = sum(scale_factors[s] for s in single_job_ids)
        available = sum(cluster_spec[wt] for wt in worker_types)

        if requested <= available:
            x = self._equal_split(single_job_ids, index, scale_factors, cluster_spec)
        else:
            unassigned = [
                s for s in single_job_ids if s not in self._assigned_combinations
            ]
            attempts = len(unassigned)
            while len(unassigned) > 1 and attempts > 0:
                attempts -= 1
                a, b = self._rng.sample(unassigned, 2)
                if scale_factors[a] != scale_factors[b]:
                    continue
                unassigned.remove(a)
                unassigned.remove(b)
                combo = JobId(a[0], b[0])
                self._assigned_combinations[a] = (combo, b)
                self._assigned_combinations[b] = (combo, a)
            for s in unassigned:
                self._assigned_combinations[s] = (s, None)
            combos = list(
                {combo for combo, _ in self._assigned_combinations.values()}
            )
            # A freshly drawn pair may have no oracle entry yet this round;
            # only schedule combos present in the throughput dict.
            combos = [c for c in combos if c in job_ids]
            x = self._equal_split(combos, index, scale_factors, cluster_spec)

        return self.unflatten(x, index)
