"""FIFO: jobs hold a whole worker (type) in arrival order until done.

Stateful across allocation calls: a scheduled job keeps its worker type
until it completes. ``perf`` mode re-derives the whole assignment each
call, picking each job's best worker type; ``packing`` mode then pairs
queued jobs with running ones greedily, where the pair's normalized
throughput beats a threshold. The port of the JAX package's
``shockwave_tpu/policies/fifo.py``, which draws the base mode's worker
type from its own seeded stream and uses the drawn index (Gavel's fifo.py
assigns a stale loop variable instead).
"""

from __future__ import annotations

import random
from typing import Dict, Optional

from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.policies.base import Policy


class FIFOPolicy(Policy):
    name = "FIFO"

    def __init__(self, mode: str = "base", seed: Optional[int] = None,
                 packing_threshold: float = 1.5):
        super().__init__()
        self._mode = mode
        self._assigned_type: Dict[JobId, str] = {}
        self._rng = random.Random(seed)
        self._packing_threshold = packing_threshold

    def _pack(self, queue, throughputs, scale_factors):
        """Greedily merge queued jobs into running singletons when the pair's
        normalized combined throughput clears the threshold."""
        while queue:
            candidate = queue.pop(0)
            best_gain = self._packing_threshold
            best_partner = None
            for scheduled, worker_type in self._assigned_type.items():
                if scheduled.is_pair:
                    continue
                if scale_factors[scheduled] != scale_factors[candidate]:
                    continue
                merged = JobId(scheduled[0], candidate[0])
                if merged not in throughputs:
                    continue
                packed = throughputs[merged][worker_type]
                normalized = 0.0
                for i, single in enumerate(merged.singletons()):
                    if packed[i] > 0:
                        normalized += packed[i] / throughputs[single][worker_type]
                if normalized > best_gain:
                    best_gain = normalized
                    best_partner = scheduled
            if best_partner is None:
                # FIFO order: nothing may jump the queue.
                break
            worker_type = self._assigned_type.pop(best_partner)
            self._assigned_type[JobId(best_partner[0], candidate[0])] = worker_type

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        available = dict(cluster_spec)
        if self._mode != "base":
            self._assigned_type = {}

        queue = [
            j for j in sorted(throughputs)
            if not j.is_pair and j not in self._assigned_type
        ]

        # Release slots of completed jobs; requeue surviving pair members.
        for scheduled in sorted(self._assigned_type):
            worker_type = self._assigned_type[scheduled]
            if scheduled not in throughputs:
                for single in scheduled.singletons():
                    if single in throughputs and single not in queue:
                        queue.append(single)
                queue.sort()
                del self._assigned_type[scheduled]
            else:
                available[worker_type] -= scale_factors[
                    scheduled.singletons()[0]
                ]

        available_types = sorted(t for t in available if available[t] > 0)

        while queue and available_types:
            job_id = queue.pop(0)
            sf = scale_factors[job_id]
            fitting = [t for t in available_types if available[t] >= sf]
            if not fitting:
                # Keep the head job in the queue, so that packing mode
                # can still pair it (Gavel's fifo.py drops it).
                queue.insert(0, job_id)
                break
            if self._mode == "base":
                worker_type = fitting[self._rng.randrange(len(fitting))]
            else:
                worker_type = max(fitting, key=lambda t: throughputs[job_id][t])
            if throughputs[job_id][worker_type] > 0:
                self._assigned_type[job_id] = worker_type
                available[worker_type] -= sf
                if available[worker_type] == 0:
                    available_types.remove(worker_type)

        if self._mode == "packing":
            self._pack(queue, throughputs, scale_factors)

        allocation = {
            job_id: {wt: 0.0 for wt in cluster_spec} for job_id in throughputs
        }
        for job_id, worker_type in self._assigned_type.items():
            if job_id in allocation:
                allocation[job_id][worker_type] = 1.0
        return allocation


class FIFOPolicyWithPerf(Policy):
    name = "FIFO_Perf"

    def __init__(self):
        super().__init__()
        self._policy = FIFOPolicy(mode="perf")

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        return self._policy.get_allocation(throughputs, scale_factors, cluster_spec)


class FIFOPolicyWithPacking(Policy):
    name = "FIFO_Packing"

    def __init__(self, packing_threshold: float = 1.5):
        super().__init__()
        self._policy = FIFOPolicy(mode="packing", packing_threshold=packing_threshold)

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        return self._policy.get_allocation(throughputs, scale_factors, cluster_spec)
