"""Policy registry: name -> policy.

Every name of the JAX package's registry
(``shockwave_tpu/policies/__init__.py``): the Shockwave policies
(``shockwave``, the exact MILP on the host; ``shockwave_tpu``, the
production dispatch; ``shockwave_tpu_level``, ``shockwave_native``,
``shockwave_tpu_sharded``, the level solve over a solve mesh,
``shockwave_tpu_pdhg``, ``shockwave_tpu_relaxed`` and
``shockwave_tpu_cells``, the cell-decomposed market) and Gavel's policies
(FIFO, isolated, max-min fairness and its water-filling and
strategy-proof forms, finish-time fairness, min-total-duration, the
throughput-sum programs with cost and SLOs, Gandiva, AlloX and the packed
forms), whose LPs and assignments run on the host.
"""

from __future__ import annotations

import importlib
from typing import Optional

from shockwave_tpu_torch.policies.base import Policy

_BACKENDS = {
    "shockwave": "reference",
    "shockwave_tpu": "tpu",
    "shockwave_tpu_level": "level",
    "shockwave_native": "native",
    "shockwave_tpu_sharded": "sharded",
    "shockwave_tpu_relaxed": "relaxed",
    "shockwave_tpu_pdhg": "pdhg",
    "shockwave_tpu_cells": "cells",
}


# Gavel policies: name -> (module of this package, class). The modules
# load on first use, since scipy's import is slow.
_GAVEL = {
    "fifo": ("fifo", "FIFOPolicy"),
    "fifo_perf": ("fifo", "FIFOPolicyWithPerf"),
    "isolated": ("isolated", "IsolatedPolicy"),
    "max_min_fairness": ("max_min_fairness", "MaxMinFairnessPolicy"),
    "max_min_fairness_perf": ("max_min_fairness",
                              "MaxMinFairnessPolicyWithPerf"),
    "max_min_fairness_water_filling": ("water_filling",
                                       "MaxMinFairnessWaterFillingPolicy"),
    "max_min_fairness_water_filling_perf": (
        "water_filling", "MaxMinFairnessWaterFillingPolicyWithPerf"),
    "finish_time_fairness": ("finish_time_fairness",
                             "FinishTimeFairnessPolicy"),
    "finish_time_fairness_perf": ("finish_time_fairness",
                                  "FinishTimeFairnessPolicyWithPerf"),
    "min_total_duration": ("min_total_duration", "MinTotalDurationPolicy"),
    "min_total_duration_perf": ("min_total_duration",
                                "MinTotalDurationPolicyWithPerf"),
    "max_sum_throughput_perf": ("max_sum_throughput",
                                "ThroughputSumWithPerf"),
    "fifo_packed": ("fifo", "FIFOPolicyWithPacking"),
    "max_min_fairness_packed": ("max_min_fairness_packed",
                                "MaxMinFairnessPolicyWithPacking"),
    "max_min_fairness_water_filling_packed": (
        "water_filling", "MaxMinFairnessWaterFillingPolicyWithPacking"),
    "max_min_fairness_strategy_proof": (
        "strategy_proof", "MaxMinFairnessStrategyProofPolicyWithPerf"),
    "finish_time_fairness_packed": ("finish_time_fairness",
                                    "FinishTimeFairnessPolicyWithPacking"),
    "min_total_duration_packed": ("min_total_duration",
                                  "MinTotalDurationPolicyWithPacking"),
    "max_sum_throughput_normalized_by_cost_perf": (
        "max_sum_throughput", "ThroughputNormalizedByCostSumWithPerf"),
    "max_sum_throughput_normalized_by_cost_perf_SLOs": (
        "max_sum_throughput", "ThroughputNormalizedByCostSumWithPerfSLOs"),
    "max_sum_throughput_normalized_by_cost_packed_SLOs": (
        "max_sum_throughput", "ThroughputNormalizedByCostSumWithPackingSLOs"),
    "gandiva": ("gandiva", "GandivaPolicy"),
    "allox": ("allox", "AlloXPolicy"),
}
# Policies that draw from a seeded stream: FIFO's worker types and
# Gandiva's pairs.
_SEEDED = ("fifo", "gandiva")


def get_policy(policy_name: str, device="cuda",
               seed: Optional[int] = None) -> Policy:
    """The policy named ``policy_name``. ``device`` is where the Shockwave
    planner's device solves (level, PDHG, relaxed) run; the exact MILP
    (``shockwave``) and the Gavel policies solve on the host. ``seed``
    seeds FIFO's worker-type draws and Gandiva's pairs;
    ``allox_alpha=<a>`` truncates AlloX's queue to a times its jobs."""
    if policy_name in _BACKENDS:
        from shockwave_tpu_torch.policies.shockwave import ShockwavePolicy

        return ShockwavePolicy(backend=_BACKENDS[policy_name], device=device)
    if policy_name.startswith("allox_alpha="):
        from shockwave_tpu_torch.policies.allox import AlloXPolicy

        return AlloXPolicy(alpha=float(policy_name.split("allox_alpha=")[1]))
    if policy_name in _GAVEL:
        module, cls = _GAVEL[policy_name]
        cls = getattr(importlib.import_module(
            f"shockwave_tpu_torch.policies.{module}"), cls)
        return cls(seed=seed) if policy_name in _SEEDED else cls()
    raise ValueError(f"Unknown policy: {policy_name!r}")


def get_available_policies():
    return [*_BACKENDS, *_GAVEL]


__all__ = ["Policy", "get_policy", "get_available_policies"]
