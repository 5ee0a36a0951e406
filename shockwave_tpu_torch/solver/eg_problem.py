"""The per-round Eisenberg-Gale planning problem, as arrays.

Every solver backend (the level-set solve on a torch device, the native
greedy on the host)
consumes the same :class:`EGProblem`: one row per active job, built by the
planner from the predictor state each time a plan is recomputed.

The decision variable of the boolean program is Y[j, r] in {0,1} — job j
occupies its gang of ``nworkers[j]`` accelerators in future round r
(reference: scheduler/shockwave.py:45-75). The objective co-optimizes
priority-weighted Nash social welfare (piecewise-log utility of epoch
progress, reference: shockwave.py:93-222) and a makespan regularizer
(reference: shockwave.py:330-388).

A structural fact both backends exploit: the objective depends on Y only
through the per-job planned-round counts s_j = sum_r Y[j, r] (utility via
planned runtime <= s_j * round_duration, makespan likewise); the rounds
dimension only enters through the per-round capacity constraint.

Switching cost (preemption-aware planning): with ``switch_cost`` (the
job family's measured relaunch overhead, seconds) and ``incumbent`` (1
for jobs holding workers when the plan is computed) set, the objective
charges regularizer * switch_cost_j for every incumbent the plan drops
entirely (s_j = 0) — i.e. dropping a running job is as bad as adding
its relaunch overhead to the makespan. The term still depends on Y
only through s_j (via the indicator 1[s_j >= 1]), and only ever RAISES
the first round's marginal utility, so every backend's concavity
argument survives. Both vectors default to None: the zero-overhead
problem is bit-identical to the historical objective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class EGProblem:
    """Arrays are parallel over the J active jobs."""

    priorities: np.ndarray  # p_j = ftf_j ** lambda, > 0
    completed_epochs: np.ndarray  # F_j
    total_epochs: np.ndarray  # E_j
    epoch_duration: np.ndarray  # D_j: interpolated mean epoch duration, > 0
    remaining_runtime: np.ndarray  # R_j: Dirichlet-predicted remaining seconds
    nworkers: np.ndarray  # g_j: gang size (scale factor)

    num_gpus: int  # per-round capacity
    round_duration: float
    future_rounds: int  # planning-window length (rounds)
    regularizer: float  # k: weight on the makespan term
    log_bases: np.ndarray  # piecewise-log breakpoints in [0, 1]

    # Preemption awareness (optional; None == zero overhead).
    switch_cost: Optional[np.ndarray] = None  # c_j: relaunch overhead, s
    incumbent: Optional[np.ndarray] = None  # a_j in {0, 1}: running now

    @property
    def num_jobs(self) -> int:
        return len(self.priorities)

    def switch_bonus(self) -> np.ndarray:
        """B_j = regularizer * c_j * a_j: the objective bonus for keeping
        incumbent j scheduled at all (equivalently, the penalty for
        dropping it). Zeros when either vector is unset."""
        if self.switch_cost is None or self.incumbent is None:
            return np.zeros(self.num_jobs)
        return (
            self.regularizer
            * np.asarray(self.switch_cost, dtype=np.float64)
            * np.asarray(self.incumbent, dtype=np.float64)
        )

    def log_base_values(self) -> np.ndarray:
        """log evaluated at the breakpoints, with log(0) -> log(1e-6)
        (reference: shockwave.py:99-105)."""
        bases = np.asarray(self.log_bases, dtype=np.float64)
        return np.log(np.where(bases == 0.0, 1e-6, bases))

    def objective_value(self, Y: np.ndarray, piecewise: bool = True) -> float:
        """Objective of a boolean schedule Y (J x R), used for backend
        quality comparison. With ``piecewise`` the utility is the chordal
        interpolation of log over ``log_bases`` (what the MILP optimizes);
        otherwise the exact log.
        """
        Y = np.asarray(Y, dtype=np.float64)
        s = Y.sum(axis=1)
        planned_sec = s * self.round_duration
        # Optimal planned epochs given s: run as far as the granted rounds
        # allow, capped at finishing the job.
        planned_epochs = np.minimum(
            planned_sec / self.epoch_duration,
            np.maximum(self.total_epochs - self.completed_epochs, 0.0),
        )
        progress = np.clip(
            (self.completed_epochs + planned_epochs) / self.total_epochs, 0.0, 1.0
        )
        if piecewise:
            utilities = np.interp(progress, self.log_bases, self.log_base_values())
        else:
            utilities = np.log(np.clip(progress, 1e-6, 1.0))
        welfare = float(
            np.sum(self.priorities * utilities)
            / (self.num_jobs * self.future_rounds)
        )
        makespan = float(
            np.max(
                np.maximum(
                    0.0,
                    self.remaining_runtime - self.epoch_duration * planned_epochs,
                )
            )
        )
        # Preemption charge: every incumbent the plan drops entirely pays
        # its relaunch overhead (regularizer-scaled seconds, the same
        # rate the makespan term charges).
        switch_penalty = float(np.sum(np.where(s < 0.5, self.switch_bonus(), 0.0)))
        return welfare - self.regularizer * makespan - switch_penalty

    def audit_schedule(self, Y: np.ndarray) -> None:
        """Assert Y is a feasible boolean schedule for this problem:
        binary entries (a job occupies a round at most once — no double
        grants), per-round gang capacity respected, window length
        respected, and no grants to gangs wider than the cluster.
        Raises AssertionError with a diagnostic on any violation. Used by
        the headline bench (bench.py) so the stress-scale number is backed
        by a feasibility proof of the produced schedule, not only its
        scalar objective."""
        Y = np.asarray(Y)
        J, R = Y.shape
        assert J == self.num_jobs and R == self.future_rounds, (
            f"schedule shape {Y.shape} != ({self.num_jobs}, "
            f"{self.future_rounds})"
        )
        binary = np.isin(Y, (0, 1)).all()
        assert binary, "schedule has non-boolean entries (double grant?)"
        too_wide = self.nworkers > self.num_gpus
        assert not np.any(Y[too_wide].sum(axis=1) > 0), (
            "grants to gangs wider than the cluster"
        )
        per_round = (Y * self.nworkers[:, None]).sum(axis=0)
        worst = int(np.argmax(per_round))
        assert (per_round <= self.num_gpus + 1e-6).all(), (
            f"round {worst} oversubscribed: {per_round[worst]} workers "
            f"> capacity {self.num_gpus}"
        )
