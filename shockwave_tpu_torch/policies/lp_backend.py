"""LP backends of the LP-shaped Gavel policies, on the host.

The port of the JAX package's ``shockwave_tpu/policies/lp_backend.py``.
scipy's HiGHS solves these programs, as it does there: they are small
(jobs x worker types) and run once per allocation update. The card is
kept for the Shockwave planner's solves. Each function builds the same
rows in the same order with the same bounds as the JAX package's, so
HiGHS sees the same program and returns the same vertex; on a degenerate
program (max-min with every throughput 1 has many optima) that is what
keeps the two packages' allocations equal.

The ``*_general`` forms take arbitrary objective rows over vec(x) and a
prebuilt (A_base, b_base) polytope; the wrappers below build the
per-job rows over the base polytope and delegate.

Failure contract: the solvers return None when the program is
infeasible or the solver fails; callers choose between a fallback and a
raise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.optimize import linprog

from shockwave_tpu_torch.policies.base import constraint_matrices


def _bounds(n_var: int, zero_mask: np.ndarray | None):
    if zero_mask is None:
        return [(0, None)] * n_var
    return [(0, 0) if zero_mask[i] else (0, None) for i in range(n_var)]


def max_min_lp_general(
    coeff_rows: np.ndarray,
    A_base: np.ndarray,
    b_base: np.ndarray,
    zero_mask: np.ndarray | None = None,
) -> np.ndarray | None:
    """maximize min_s coeff_rows[s] . x over {A_base x <= b_base, x >= 0}.

    ``zero_mask`` flags variables pinned to zero (e.g. mixed-scale pairs).
    """
    S, n_var = coeff_rows.shape
    A_ub = np.zeros((A_base.shape[0] + S, n_var + 1))
    A_ub[: A_base.shape[0], :n_var] = A_base
    b_ub = np.concatenate([b_base, np.zeros(S)])
    for s in range(S):
        A_ub[A_base.shape[0] + s, :n_var] = -coeff_rows[s]
        A_ub[A_base.shape[0] + s, -1] = 1.0
    c = np.zeros(n_var + 1)
    c[-1] = -1.0
    bounds = _bounds(n_var, zero_mask) + [(None, None)]
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not res.success:
        return None
    return res.x[:n_var]


def feasibility_lp_general(
    coeff_rows: np.ndarray,
    rates: np.ndarray,
    A_base: np.ndarray,
    b_base: np.ndarray,
    zero_mask: np.ndarray | None = None,
) -> np.ndarray | None:
    """Find x >= 0 with A_base x <= b_base and coeff_rows[s] . x >= rates[s]
    for every s, or None."""
    S, n_var = coeff_rows.shape
    A_ub = np.vstack([A_base, -coeff_rows])
    b_ub = np.concatenate([b_base, -np.asarray(rates, dtype=np.float64)])
    res = linprog(
        np.zeros(n_var),
        A_ub=A_ub,
        b_ub=b_ub,
        bounds=_bounds(n_var, zero_mask),
        method="highs",
    )
    if not res.success:
        return None
    return res.x


def max_sum_lp_general(
    objective: np.ndarray,
    A_base: np.ndarray,
    b_base: np.ndarray,
    zero_mask: np.ndarray | None = None,
) -> np.ndarray | None:
    """maximize objective . x over {A_base x <= b_base, x >= 0}; None if
    infeasible."""
    n_var = len(objective)
    res = linprog(
        -np.asarray(objective, dtype=np.float64),
        A_ub=A_base,
        b_ub=b_base,
        bounds=_bounds(n_var, zero_mask),
        method="highs",
    )
    if not res.success:
        return None
    return res.x


def _per_job_rows(coeffs: np.ndarray) -> np.ndarray:
    """Block-diagonal objective rows: row j covers x[j, :] only."""
    m, n = coeffs.shape
    rows = np.zeros((m, m * n))
    for j in range(m):
        rows[j, j * n : (j + 1) * n] = coeffs[j]
    return rows


def max_min_lp(
    coeffs: np.ndarray,
    scale_factors_array: np.ndarray,
    num_workers: Sequence[int],
) -> np.ndarray:
    """maximize  min_j sum_w coeffs[j,w] * x[j,w]  over the base polytope:
    the core of max-min fairness (coeffs = throughput * priority * scale
    factor). Raises on solver failure: the base polytope is never empty."""
    m, n = coeffs.shape
    A_base, b_base = constraint_matrices(scale_factors_array, num_workers)
    x = max_min_lp_general(_per_job_rows(coeffs), A_base, b_base)
    if x is None:
        raise RuntimeError("max_min LP failed")
    return x.reshape(m, n)


def feasibility_lp(
    rate_requirements: np.ndarray,
    coeffs: np.ndarray,
    scale_factors_array: np.ndarray,
    num_workers: Sequence[int],
) -> np.ndarray | None:
    """Find x in the base polytope with coeffs[j].x[j] >= rate_requirements[j]
    for every job, or None if infeasible."""
    m, n = coeffs.shape
    A_base, b_base = constraint_matrices(scale_factors_array, num_workers)
    x = feasibility_lp_general(
        _per_job_rows(coeffs), rate_requirements, A_base, b_base
    )
    if x is None:
        return None
    return x.reshape(m, n)


def max_sum_lp(
    objective_coeffs: np.ndarray,
    scale_factors_array: np.ndarray,
    num_workers: Sequence[int],
    extra_A_ub: np.ndarray | None = None,
    extra_b_ub: np.ndarray | None = None,
) -> np.ndarray | None:
    """maximize sum_jw objective_coeffs[j,w] * x[j,w] over the base polytope
    (plus optional extra rows over vec(x)); None if infeasible."""
    m, n = objective_coeffs.shape
    A_ub, b_ub = constraint_matrices(scale_factors_array, num_workers)
    if extra_A_ub is not None:
        A_ub = np.vstack([A_ub, extra_A_ub])
        b_ub = np.concatenate([b_ub, extra_b_ub])
    x = max_sum_lp_general(objective_coeffs.reshape(-1), A_ub, b_ub)
    if x is None:
        return None
    return x.reshape(m, n)
