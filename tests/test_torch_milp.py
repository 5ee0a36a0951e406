"""The port's exact MILP (``solver/eg_milp.py``) against the JAX package's,
on the CPU.

Seeded planning problems of 8-64 jobs x 2-20 rounds (gangs 1-8 wide, some
jobs with nothing left to run, with and without a switch bonus) go through
both packages' tightened formulation, the reference's boolean-boundary
formulation and the MILP reorder of the unfair jobs. Both hand scipy's
HiGHS the same sparse program, so wherever both report status 0 (optimal
within the gap) their schedules must be equal in every entry. Each call's
HiGHS status is read back, and the ``shockwave`` policy's planner counts
them.
"""

import numpy as np
import pytest

from gavel_reference import MilpStatuses
from shockwave_tpu.solver import eg_milp as ref_milp
from shockwave_tpu.solver.eg_problem import EGProblem as RefEGProblem
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.solver import eg_milp
from shockwave_tpu_torch.solver.eg_problem import EGProblem
from test_torch_solver import _copy_problem

SEEDS = range(12)
LOG_BASES = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0])


def milp_problem(seed: int, bonus: bool) -> EGProblem:
    """A seeded problem of 8-64 jobs x 2-20 rounds on 4-32 GPUs."""
    rng = np.random.default_rng(7000 + seed)
    J = int(rng.integers(8, 65))
    R = int(rng.integers(2, 21))
    num_gpus = int(rng.choice([4, 8, 16, 32]))
    nworkers = rng.choice([1, 2, 4, 8], J, p=[0.55, 0.25, 0.12, 0.08])
    total = rng.integers(1, 60, J).astype(np.float64)
    completed = np.floor(total * rng.uniform(0.0, 1.0, J))
    epoch_dur = rng.uniform(20.0, 2000.0, J)
    remaining = (total - completed) * epoch_dur * rng.uniform(0.8, 1.2, J)
    done = rng.random(J) < 0.05
    completed = np.where(done, total, completed)
    remaining = np.where(done, 0.0, remaining)
    switch_cost = incumbent = None
    if bonus:
        switch_cost = np.where(rng.random(J) < 0.5,
                               rng.uniform(5.0, 300.0, J), 0.0)
        incumbent = (rng.random(J) < 0.4).astype(np.float64)
        switch_cost[0], incumbent[0] = 60.0, 1.0
    return EGProblem(
        priorities=rng.uniform(0.3, 2.5, J) ** 5,
        completed_epochs=completed,
        total_epochs=total,
        epoch_duration=epoch_dur,
        remaining_runtime=remaining,
        nworkers=nworkers.astype(np.float64),
        num_gpus=num_gpus,
        round_duration=120.0,
        future_rounds=R,
        regularizer=float(rng.choice([10.0, 1.0])),
        log_bases=LOG_BASES,
        switch_cost=switch_cost,
        incumbent=incumbent,
    )


def ref_solve(solve, *args):
    """The JAX package's solve and the HiGHS statuses of its calls."""
    with MilpStatuses() as milp:
        out = solve(*args, rel_gap=1e-3, time_limit=15.0)
    return out, [status for status, n in milp.counts.items()
                 for _ in range(n)]


@pytest.mark.parametrize("formulation", ["tightened", "reference"])
@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_milp_equals_the_reference(seed, bonus, formulation):
    problem = milp_problem(seed, bonus)
    ref_problem = _copy_problem(problem, RefEGProblem)
    if bonus:
        assert problem.switch_bonus().max() > 0
    port, ref = ((eg_milp.solve_eg_milp, ref_milp.solve_eg_milp)
                 if formulation == "tightened" else
                 (eg_milp.solve_eg_milp_reference_formulation,
                  ref_milp.solve_eg_milp_reference_formulation))
    statuses = []
    Y = port(problem, rel_gap=1e-3, time_limit=15.0, statuses=statuses)
    Y_ref, ref_statuses = ref_solve(ref, ref_problem)
    assert statuses == ref_statuses == [0]
    assert Y.dtype == Y_ref.dtype and np.array_equal(Y, Y_ref)
    problem.audit_schedule(Y)

    # The reorder of the unfair jobs into the earliest rounds.
    statuses = []
    Z = eg_milp.reorder_unfair_jobs_milp(Y, problem, rel_gap=1e-3,
                                         time_limit=15.0, statuses=statuses)
    Z_ref, ref_statuses = ref_solve(ref_milp.reorder_unfair_jobs_milp, Y_ref,
                                    ref_problem)
    assert statuses == ref_statuses
    assert np.array_equal(Z, Z_ref)
    assert np.array_equal(Z.sum(axis=1), Y.sum(axis=1))
    problem.audit_schedule(Z)


def test_an_empty_plan_is_not_reordered():
    problem = milp_problem(0, False)
    Y = np.zeros((problem.num_jobs, problem.future_rounds), dtype=np.int64)
    statuses = []
    assert eg_milp.reorder_unfair_jobs_milp(Y, problem,
                                            statuses=statuses) is Y
    assert statuses == []


def test_a_solve_stopped_at_its_time_limit_says_so():
    """A time limit HiGHS cannot meet: its status reads 1, whether or not
    it ended with an incumbent (none: the solve raises, as the JAX
    package's does)."""
    from shockwave_tpu_torch.tools.bench_sim import stress_problem

    problem = stress_problem(400, 30, 64, seed=3)
    statuses = []
    try:
        Y = eg_milp.solve_eg_milp_reference_formulation(
            problem, time_limit=1e-3, statuses=statuses)
    except RuntimeError:
        Y = None
    assert statuses == [eg_milp.TIME_LIMIT]
    if Y is not None:
        problem.audit_schedule(Y)


def test_planner_counts_its_milp_statuses():
    """The ``shockwave`` policy's planner runs the MILP and then the
    reorder, and keeps both calls' statuses."""
    problem = milp_problem(1, True)
    planner = get_policy("shockwave", device="cpu").make_planner(
        {"num_gpus": problem.num_gpus, "time_per_iteration": 120.0,
         "solver_timeout": 15.0})
    assert planner.backend == "reference"
    assert (planner.solver_rel_gap, planner.solver_timeout) == (1e-3, 15.0)
    Y, used = planner._solve_backend("reference", problem)
    assert used == "reference" and planner.milp_statuses == [0, 0]
    problem.audit_schedule(Y)
