"""Deterministic dual and price report of the EG market (DualReport).

The port of the JAX package's ``shockwave_tpu/solver/duals.py``: host
float64 numpy, a pure function of ``(problem, s)``, so a report is
bit-equal to the JAX package's on the same inputs and bit-stable under
replay. Every solver backend converges to an allocation ``s`` (rounds
granted per job over the planning window); the market prices that
explain it (the budget dual, the makespan dual and each job's marginal
welfare) are closed-form functions of that iterate:

* the marginal welfare density ``q_j beta_j / (A_j + eps + beta_j s_j)``
  is kernel A's prox slope and welfare-fill threshold;
* the per-chip-round price ``marginal_j / w_j`` with the budget-slack
  gate is ``cells.coordinator.congestion_price``'s;
* the makespan dual is the regularizer ``k`` carried by the jobs the
  lateness max binds on.

``_EPS`` is the solvers' own 1e-6, copied here (the JAX package imports
it from ``eg_jax``). The planners' market attribution
(``_market_attribution``) reads these reports after every replan with
the flight recorder or metrics on, and ``obs/explain.py`` builds the
per-job narratives from the records.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from shockwave_tpu_torch.solver.eg_problem import EGProblem

# The solvers' guard against log(0) and zero divisors (eg_level._EPS).
_EPS = 1e-6

# Budget-slack gate: below this utilization capacity is not scarce and
# the congestion price is zero (matches cells.coordinator).
_SLACK_TOL = 1e-3
# A job binds the makespan when its lateness is within this fraction of
# the achieved max (float64 comparison of second-scale quantities).
_BINDING_TOL = 1e-9


@dataclasses.dataclass
class DualReport:
    """Market duals and per-job attribution for one converged solve.

    All arrays are float64, indexed like the problem's job axis. Every
    field is a deterministic function of ``(problem, s)``.
    """

    s: np.ndarray  # rounds granted per job
    nworkers: np.ndarray  # chips per round each job occupies
    fair_share: np.ndarray  # priority-weighted fair rounds per job
    marginal_welfare: np.ndarray  # d(welfare)/d(s_j) at s (0 once sated)
    price: np.ndarray  # per chip-round density marginal_j / w_j
    welfare_contribution: np.ndarray  # q_j * log(progress_j + eps)
    spend: np.ndarray  # chip-rounds consumed: w_j * s_j
    makespan_binding: np.ndarray  # bool: job's lateness binds the max
    budget_dual: float  # congestion price of fleet capacity
    makespan_dual: float  # regularizer k (mass on binding jobs)
    makespan: float  # achieved max lateness (seconds)
    budget: float  # num_gpus * future_rounds (chip-rounds)
    budget_used: float  # sum(spend)

    @property
    def fairness_drift(self) -> float:
        """Budget-weighted fair-share deficit in [0, 1]: the fraction
        of the fleet's fair entitlement (in chip-rounds) that went
        unserved. 0 when every job got at least its weighted fair
        share; 1 when none did."""
        entitled = float(np.sum(self.fair_share * self.nworkers))
        if entitled <= 0.0:
            return 0.0
        deficit = np.maximum(self.fair_share - self.s, 0.0)
        return float(np.sum(deficit * self.nworkers) / entitled)

    def to_dict(self) -> dict:
        """Plain-JSON form (the attribution record's market block)."""
        return {
            "budget_dual": float(self.budget_dual),
            "makespan_dual": float(self.makespan_dual),
            "makespan_s": float(self.makespan),
            "budget": float(self.budget),
            "budget_used": float(self.budget_used),
            "fairness_drift": float(self.fairness_drift),
        }


def dual_report(
    problem: EGProblem,
    Y: Optional[np.ndarray] = None,
    s: Optional[np.ndarray] = None,
) -> DualReport:
    """Extract the :class:`DualReport` at a converged iterate.

    ``s`` is the allocation in rounds (the relaxed backends' converged
    iterate); ``Y`` the boolean schedule window (any backend's final
    answer; ``s = Y.sum(axis=1)``). Exactly one must be given.
    """
    if (Y is None) == (s is None):
        raise ValueError("dual_report needs exactly one of Y or s")
    if s is None:
        s = np.asarray(Y, np.float64).sum(axis=1)
    s = np.asarray(s, np.float64)

    J = problem.num_jobs
    R = float(problem.future_rounds)
    dur = max(float(problem.round_duration), 1e-9)
    pri = np.asarray(problem.priorities, np.float64)
    completed = np.asarray(problem.completed_epochs, np.float64)
    total_ep = np.maximum(np.asarray(problem.total_epochs, np.float64), _EPS)
    epoch_dur = np.maximum(
        np.asarray(problem.epoch_duration, np.float64), _EPS
    )
    remaining = np.asarray(problem.remaining_runtime, np.float64)
    w = np.asarray(problem.nworkers, np.float64)
    budget = float(problem.num_gpus) * R

    # The solver's welfare parameterization (eg_pdhg._pdhg_core).
    q = pri / (max(J, 1) * R)
    A = completed / total_ep
    beta = dur / (epoch_dur * total_ep)
    need_sec = np.maximum(
        np.asarray(problem.total_epochs, np.float64) - completed, 0.0
    ) * epoch_dur
    xcap = need_sec / dur

    progress = A + beta * np.minimum(s, xcap)
    welfare_contribution = q * np.log(progress + _EPS)
    unmet = s < xcap
    marginal = np.where(unmet, q * beta / (A + _EPS + beta * s), 0.0)
    fits = w <= float(problem.num_gpus)
    w_safe = np.where(w > 0, w, 1.0)
    price = np.where(fits, marginal / w_safe, 0.0)

    spend = w * s
    used = float(np.sum(spend))
    # Congestion price of fleet capacity: zero when the budget is
    # slack, else the steepest unmet-and-fits marginal density per chip
    # (cells.coordinator.congestion_price semantics).
    if used < budget * (1.0 - _SLACK_TOL):
        budget_dual = 0.0
    else:
        eligible = unmet & fits
        budget_dual = float(np.max(price[eligible])) if np.any(eligible) else 0.0

    lateness = remaining - dur * s
    makespan = float(np.max(lateness)) if J else 0.0
    makespan = max(makespan, 0.0)
    binding = lateness >= makespan - _BINDING_TOL * max(makespan, 1.0)
    if makespan <= 0.0:
        binding = np.zeros(J, bool)

    # Priority-weighted fair share: the rounds job j would hold if the
    # window's chip-rounds were split in proportion to priority alone
    # (the baseline the fairness forensics compare allocations against).
    pri_sum = float(np.sum(np.where(fits, pri, 0.0)))
    if pri_sum > 0.0:
        fair = np.where(fits, budget * pri / pri_sum / w_safe, 0.0)
    else:
        fair = np.zeros(J)
    fair = np.minimum(fair, R)

    return DualReport(
        s=s,
        nworkers=w,
        fair_share=fair,
        marginal_welfare=marginal,
        price=price,
        welfare_contribution=welfare_contribution,
        spend=spend,
        makespan_binding=binding,
        budget_dual=budget_dual,
        makespan_dual=float(problem.regularizer),
        makespan=makespan,
        budget=budget,
        budget_used=used,
    )


def welfare_at(problem: EGProblem, s: np.ndarray) -> float:
    """The normalized log-Nash welfare term at allocation ``s`` (the
    quantity ``marginal_welfare`` differentiates) — the oracle the
    finite-difference audit perturbs. Same normalization as
    :func:`dual_report` (and the what-if pricer's fixed-norm welfare),
    so FD deltas and reported marginals live on the same scale."""
    J = problem.num_jobs
    R = float(problem.future_rounds)
    dur = max(float(problem.round_duration), 1e-9)
    total_ep = np.maximum(np.asarray(problem.total_epochs, np.float64), _EPS)
    epoch_dur = np.maximum(
        np.asarray(problem.epoch_duration, np.float64), _EPS
    )
    completed = np.asarray(problem.completed_epochs, np.float64)
    q = np.asarray(problem.priorities, np.float64) / (max(J, 1) * R)
    A = completed / total_ep
    beta = dur / (epoch_dur * total_ep)
    need_sec = np.maximum(
        np.asarray(problem.total_epochs, np.float64) - completed, 0.0
    ) * epoch_dur
    xcap = need_sec / dur
    progress = A + beta * np.minimum(np.asarray(s, np.float64), xcap)
    return float(np.sum(q * np.log(progress + _EPS)))
