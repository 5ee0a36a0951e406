"""FIFO: jobs hold a whole worker (type) in arrival order until done.

Stateful across allocation calls: a scheduled job keeps its worker type
until it completes. ``perf`` mode re-derives the whole assignment each
call, picking each job's best worker type. The reference's ``packing``
mode comes with the first packed policy (ROADMAP.md, queue 1). The
port of the JAX package's ``shockwave_tpu/policies/fifo.py``, which draws
the base mode's worker type from its own seeded stream and uses the drawn
index (Gavel's fifo.py assigns a stale loop variable instead).
"""

from __future__ import annotations

import random
from typing import Dict, Optional

from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.policies.base import Policy


class FIFOPolicy(Policy):
    name = "FIFO"

    def __init__(self, mode: str = "base", seed: Optional[int] = None):
        super().__init__()
        self._mode = mode
        self._assigned_type: Dict[JobId, str] = {}
        self._rng = random.Random(seed)

    def get_allocation(self, throughputs, scale_factors, cluster_spec):
        available = dict(cluster_spec)
        if self._mode != "base":
            self._assigned_type = {}

        queue = [j for j in sorted(throughputs) if j not in self._assigned_type]

        # Release the slots of completed jobs.
        for scheduled in sorted(self._assigned_type):
            if scheduled not in throughputs:
                del self._assigned_type[scheduled]
            else:
                available[self._assigned_type[scheduled]] -= scale_factors[
                    scheduled]

        available_types = sorted(t for t in available if available[t] > 0)

        while queue and available_types:
            job_id = queue.pop(0)
            sf = scale_factors[job_id]
            fitting = [t for t in available_types if available[t] >= sf]
            if not fitting:
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
