"""Exact boolean solve of the EG planning program on the host.

The port of the JAX package's ``shockwave_tpu/solver/eg_milp.py``: the
mixed-integer program Shockwave's reference builds with CVXPY+GUROBI
(reference: scheduler/shockwave.py:330-411), formulated for scipy's
HiGHS ``milp`` with the same sparse matrices in the same row and column
order and the same ``mip_rel_gap`` / ``time_limit`` options, so that
HiGHS sees the JAX package's program. It is the ``shockwave`` policy's
backend and the yardstick the card's solves are timed against
(``tools/bench_sim.py --milp-baseline``).

Two formulations share one constraint builder:
  * ``solve_eg_milp``: tightened. The piecewise-log utility uses the
    lambda (convex combination of breakpoints) encoding without
    per-segment booleans: log is concave and each utility enters the
    maximized objective with a positive weight, so the LP optimum uses
    adjacent breakpoints anyway; only Y[j, r] is integer.
  * ``solve_eg_milp_reference_formulation``: the reference's own boolean
    boundary and adjacency encoding, for baseline timing: the same
    optimum, many more integer variables and a weaker LP relaxation.

In both, max(0, remaining - planned) per job and the max over jobs
collapse into one epigraph variable M with M >= remaining_j - D_j * pe_j,
M >= 0.

Switching cost: a job with a nonzero switch bonus (EGProblem.switch_bonus)
gets one continuous variable z_j in [0, 1] with z_j <= sum_r Y[j, r] and
objective weight +B_j; its optimum is min(1, s_j), the keep-incumbent
indicator, with no new integer variable. With zero bonus no z variable
is added.

Each solve can record HiGHS's status (``statuses=``): a solve that
stopped at its time limit (``TIME_LIMIT``) returns its incumbent, and its
plan then depends on the wall clock.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.solver.eg_problem import EGProblem

# scipy.optimize.milp statuses: 0 optimal (within mip_rel_gap), 1 the
# iteration or time limit, 2 infeasible, 3 unbounded, 4 another failure.
TIME_LIMIT = 1


def _solve_eg(
    problem: EGProblem,
    sos2_booleans: bool,
    rel_gap: float,
    time_limit: Optional[float],
    statuses: Optional[list] = None,
) -> np.ndarray:
    """Build and solve the EG program; returns Y (J x R) in {0, 1} and
    appends HiGHS's status to ``statuses`` where given.

    Variables: [Y (J*R, bin) | pe (J) | w (J*B)
                | bnd (J*B, bin) + adj (J*(B-1), bin) if sos2_booleans
                | M (1)].
    """
    J, R = problem.num_jobs, problem.future_rounds
    B = len(problem.log_bases)
    G = problem.num_gpus
    dur = problem.round_duration
    D = problem.epoch_duration
    bases = np.asarray(problem.log_bases, dtype=np.float64)
    log_vals = problem.log_base_values()

    switch_bonus = problem.switch_bonus()
    # Jobs whose dropped-incumbent penalty needs an indicator variable.
    z_jobs = [j for j in range(J) if switch_bonus[j] > 0.0]

    n_y, n_pe, n_w = J * R, J, J * B
    n_b = J * B if sos2_booleans else 0
    n_a = J * (B - 1) if sos2_booleans else 0
    n_z = len(z_jobs)
    n_var = n_y + n_pe + n_w + n_b + n_a + n_z + 1
    iY = lambda j, r: j * R + r
    iPE = lambda j: n_y + j
    iW = lambda j, b: n_y + n_pe + j * B + b
    iB = lambda j, b: n_y + n_pe + n_w + j * B + b
    iA = lambda j, b: n_y + n_pe + n_w + n_b + j * (B - 1) + b
    iZ = {j: n_y + n_pe + n_w + n_b + n_a + i for i, j in enumerate(z_jobs)}
    iM = n_var - 1

    rows, cols, vals, lo, hi = [], [], [], [], []
    row = 0

    def add(entries, lb, ub):
        nonlocal row
        for c, v in entries:
            rows.append(row)
            cols.append(c)
            vals.append(v)
        lo.append(lb)
        hi.append(ub)
        row += 1

    # Per-round capacity: sum_j g_j Y[j,r] <= G (reference: shockwave.py:64-75).
    for r in range(R):
        add(
            [(iY(j, r), float(problem.nworkers[j])) for j in range(J)],
            -np.inf,
            float(G),
        )
    for j in range(J):
        # Planned runtime fits in the granted rounds:
        # D_j pe_j - dur * sum_r Y[j,r] <= 0 (reference: shockwave.py:125-129).
        add(
            [(iPE(j), float(D[j]))] + [(iY(j, r), -dur) for r in range(R)],
            -np.inf,
            0.0,
        )
        if sos2_booleans:
            # Exactly two active boundaries, one adjacent pair
            # (reference: shockwave.py:163-172).
            add([(iB(j, b), 1.0) for b in range(B)], 2.0, 2.0)
            for b in range(B - 1):
                add(
                    [(iA(j, b), 1.0), (iB(j, b), -1.0), (iB(j, b + 1), -1.0)],
                    -1.0,
                    np.inf,
                )
                add([(iA(j, b), 1.0), (iB(j, b), -1.0)], -np.inf, 0.0)
                add([(iA(j, b), 1.0), (iB(j, b + 1), -1.0)], -np.inf, 0.0)
            add([(iA(j, b), 1.0) for b in range(B - 1)], 1.0, 1.0)
            # Weights supported only on active boundaries
            # (reference: shockwave.py:173-179).
            for b in range(B):
                add([(iW(j, b), 1.0), (iB(j, b), -1.0)], -np.inf, 0.0)
        # w_j on the simplex.
        add([(iW(j, b), 1.0) for b in range(B)], 1.0, 1.0)
        # sum_b w[j,b] * base_b == (completed_j + pe_j) / total_j.
        add(
            [(iW(j, b), float(bases[b])) for b in range(B)]
            + [(iPE(j), -1.0 / float(problem.total_epochs[j]))],
            float(problem.completed_epochs[j] / problem.total_epochs[j]),
            float(problem.completed_epochs[j] / problem.total_epochs[j]),
        )
        # Makespan epigraph: M + D_j pe_j >= remaining_j.
        add(
            [(iM, 1.0), (iPE(j), float(D[j]))],
            float(problem.remaining_runtime[j]),
            np.inf,
        )
        # Keep-incumbent indicator: z_j <= sum_r Y[j, r].
        if j in iZ:
            add(
                [(iZ[j], 1.0)] + [(iY(j, r), -1.0) for r in range(R)],
                -np.inf,
                0.0,
            )

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(row, n_var))

    # Maximize sum_j p_j * u_j / (J*R) - k * M + sum_j B_j z_j
    # (reference: shockwave.py:373-379, plus the switching-cost term).
    c = np.zeros(n_var)
    for j in range(J):
        for b in range(B):
            c[iW(j, b)] = -problem.priorities[j] * log_vals[b] / (J * R)
    for j in z_jobs:
        c[iZ[j]] = -float(switch_bonus[j])
    c[iM] = problem.regularizer

    integrality = np.zeros(n_var)
    integrality[:n_y] = 1
    integrality[n_y + n_pe + n_w : n_y + n_pe + n_w + n_b + n_a] = 1
    lb = np.zeros(n_var)
    ub = np.full(n_var, np.inf)
    ub[:n_y] = 1.0
    ub[n_y + n_pe + n_w : n_y + n_pe + n_w + n_b + n_a] = 1.0
    for j in z_jobs:
        ub[iZ[j]] = 1.0

    options = {"mip_rel_gap": rel_gap}
    if time_limit is not None:
        options["time_limit"] = float(time_limit)
    res = milp(
        c,
        constraints=LinearConstraint(A, np.array(lo), np.array(hi)),
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options=options,
    )
    if statuses is not None:
        statuses.append(int(res.status))
    if res.x is None:
        raise RuntimeError(f"EG MILP failed: {res.message}")
    return np.round(res.x[:n_y]).reshape(J, R).astype(np.int64)


def solve_eg_milp(
    problem: EGProblem,
    rel_gap: float = 1e-3,
    time_limit: Optional[float] = 15.0,
    statuses: Optional[list] = None,
) -> np.ndarray:
    """Tightened formulation (only Y integer); the production exact
    backend. HiGHS's status is appended to ``statuses`` where given."""
    with obs.backend_phases("milp", problem.num_jobs) as bp:
        Y = _solve_eg(problem, False, rel_gap, time_limit, statuses)
        bp.phase("milp")
    return Y


def solve_eg_milp_reference_formulation(
    problem: EGProblem,
    rel_gap: float = 1e-3,
    time_limit: Optional[float] = 15.0,
    statuses: Optional[list] = None,
) -> np.ndarray:
    """The reference's boolean-boundary encoding, for baseline timing."""
    return _solve_eg(problem, True, rel_gap, time_limit, statuses)


def reorder_unfair_jobs_milp(
    Y: np.ndarray,
    problem: EGProblem,
    rel_gap: float = 1e-3,
    time_limit: Optional[float] = 15.0,
    statuses: Optional[list] = None,
) -> np.ndarray:
    """Re-derive which rounds each job occupies, keeping its granted count
    and the capacity constraint, so that unfair (high-priority) jobs run
    earliest: minimize sum_j priority_j * mean-round-index_j
    (reference: shockwave.py:281-328, paper Appendix G.2). HiGHS's status
    is appended to ``statuses`` where given (none when no job has a
    round: there is nothing to solve).
    """
    with obs.backend_phases("milp", Y.shape[0], total=False) as bp:
        Y_out = _reorder_unfair_jobs_milp_inner(
            Y, problem, rel_gap, time_limit, statuses)
        bp.phase("reorder")
    return Y_out


def _reorder_unfair_jobs_milp_inner(
    Y: np.ndarray,
    problem: EGProblem,
    rel_gap: float,
    time_limit: Optional[float],
    statuses: Optional[list] = None,
) -> np.ndarray:
    J, R = Y.shape
    counts = Y.sum(axis=1)
    if counts.sum() == 0:
        return Y
    n_var = J * R
    iY = lambda j, r: j * R + r

    rows, cols, vals, lo, hi = [], [], [], [], []
    row = 0
    for r in range(R):
        for j in range(J):
            rows.append(row)
            cols.append(iY(j, r))
            vals.append(float(problem.nworkers[j]))
        lo.append(-np.inf)
        hi.append(float(problem.num_gpus))
        row += 1
    for j in range(J):
        for r in range(R):
            rows.append(row)
            cols.append(iY(j, r))
            vals.append(1.0)
        lo.append(float(counts[j]))
        hi.append(float(counts[j]))
        row += 1
    A = sparse.csr_matrix((vals, (rows, cols)), shape=(row, n_var))

    c = np.zeros(n_var)
    for j in range(J):
        if counts[j] > 0:
            for r in range(R):
                c[iY(j, r)] = problem.priorities[j] * r / counts[j]

    options = {"mip_rel_gap": rel_gap}
    if time_limit is not None:
        options["time_limit"] = float(time_limit)
    res = milp(
        c,
        constraints=LinearConstraint(A, np.array(lo), np.array(hi)),
        integrality=np.ones(n_var),
        bounds=Bounds(np.zeros(n_var), np.ones(n_var)),
        options=options,
    )
    if statuses is not None:
        statuses.append(int(res.status))
    if res.x is None:
        # Infeasible/timeout: keep the original schedule
        # (reference: shockwave.py:325-328).
        return Y
    return np.round(res.x).reshape(J, R).astype(np.int64)
