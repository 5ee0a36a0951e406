"""The port's dual report (``shockwave_tpu_torch/solver/duals.py``)
against the JAX package's, on the CPU.

The seven cases of ``tests/test_explain.py::TestDualReport`` (:93-176),
each run on the port's report and each report held bit-equal, field by
field, to the JAX package's on the same problem and allocation; then
``solve_eg_pdhg_with_duals``: its report is ``dual_report`` of the
kernel's relaxed iterate, its plan the pdhg backend's, and its report
within the two summation orders' limits of the JAX package's
(tests/test_pdhg.py:377-398).
"""

import dataclasses

import numpy as np
import pytest
import torch

from shockwave_tpu.solver import duals as ref_duals
from shockwave_tpu.solver import eg_pdhg as ref_pdhg
from shockwave_tpu.solver.eg_problem import EGProblem
from shockwave_tpu_torch.solver import duals, eg_pdhg
from test_torch_solver import port_problem

ARRAYS = ("s", "nworkers", "fair_share", "marginal_welfare", "price",
          "welfare_contribution", "spend", "makespan_binding")
SCALARS = ("budget_dual", "makespan_dual", "makespan", "budget",
           "budget_used")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(num_jobs=4, num_gpus=4, future_rounds=6):
    """tests/test_explain.py::_problem, as the JAX package's EGProblem."""
    rng = np.random.RandomState(7)
    return EGProblem(
        priorities=1.0 + rng.rand(num_jobs),
        completed_epochs=rng.randint(0, 3, num_jobs).astype(np.float64),
        total_epochs=np.full(num_jobs, 8.0),
        epoch_duration=60.0 + 30.0 * rng.rand(num_jobs),
        remaining_runtime=300.0 + 200.0 * rng.rand(num_jobs),
        nworkers=np.ones(num_jobs),
        num_gpus=num_gpus,
        round_duration=120.0,
        future_rounds=future_rounds,
        regularizer=1e-3,
        log_bases=np.linspace(0.0, 1.0, 11),
    )


def report_pair(problem, **kw):
    """The port's report of the port's copy of ``problem``, after holding
    it bit-equal to the JAX package's report of ``problem``."""
    ours = duals.dual_report(port_problem(problem), **kw)
    ref = ref_duals.dual_report(problem, **kw)
    assert_bit_equal(ours, ref)
    return ours


def assert_bit_equal(ours, ref):
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)]
    for field in ARRAYS:
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for field in SCALARS:
        a, b = getattr(ours, field), getattr(ref, field)
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), field
    assert ours.fairness_drift == ref.fairness_drift
    assert ours.to_dict() == ref.to_dict()


class TestDualReport:
    def test_bit_stable_across_calls(self):
        problem = _problem()
        s = np.array([2.0, 1.0, 3.0, 0.0])
        a, b = report_pair(problem, s=s), report_pair(problem, s=s)
        for field in ARRAYS:
            assert getattr(a, field).tobytes() == getattr(b, field).tobytes()
        assert a.to_dict() == b.to_dict()

    def test_marginals_agree_with_finite_difference(self):
        problem = _problem()
        port = port_problem(problem)
        s = np.array([2.0, 1.5, 3.0, 1.0])
        report = report_pair(problem, s=s)
        h = 1e-5
        for j in range(problem.num_jobs):
            up, dn = s.copy(), s.copy()
            up[j] += h
            dn[j] -= h
            fd = (duals.welfare_at(port, up)
                  - duals.welfare_at(port, dn)) / (2 * h)
            assert duals.welfare_at(port, up) == ref_duals.welfare_at(
                problem, up)
            assert report.marginal_welfare[j] == pytest.approx(
                fd, rel=1e-5, abs=1e-9)

    def test_sated_job_has_zero_marginal(self):
        problem = _problem()
        need_rounds = (
            (problem.total_epochs[0] - problem.completed_epochs[0])
            * problem.epoch_duration[0] / problem.round_duration)
        s = np.array([need_rounds + 2.0, 1.0, 1.0, 1.0])
        report = report_pair(problem, s=s)
        assert report.marginal_welfare[0] == 0.0
        assert report.price[0] == 0.0

    def test_budget_dual_zero_when_capacity_slack(self):
        report = report_pair(_problem(), s=np.array([1.0, 1.0, 1.0, 1.0]))
        assert report.budget_used < report.budget
        assert report.budget_dual == 0.0

    def test_budget_dual_prices_scarcity_at_full_budget(self):
        problem = _problem(num_gpus=2)
        s = np.full(4, problem.num_gpus * problem.future_rounds / 4.0)
        report = report_pair(problem, s=s)
        assert report.budget_used == pytest.approx(report.budget)
        assert report.budget_dual > 0.0
        unmet = report.marginal_welfare > 0.0
        assert report.budget_dual == pytest.approx(
            float(np.max(report.price[unmet])))

    def test_spend_and_fairness_drift_semantics(self):
        problem = _problem()
        s = np.array([2.0, 1.0, 3.0, 0.0])
        report = report_pair(problem, s=s)
        np.testing.assert_array_equal(report.spend, problem.nworkers * s)
        assert 0.0 <= report.fairness_drift <= 1.0
        even = report_pair(problem, s=report.fair_share.copy())
        assert even.fairness_drift == 0.0

    def test_exactly_one_of_Y_or_s(self):
        port = port_problem(_problem())
        with pytest.raises(ValueError):
            duals.dual_report(port)
        with pytest.raises(ValueError):
            duals.dual_report(port, Y=np.zeros((4, 6)), s=np.zeros(4))
        # A schedule gives the report of its row sums.
        Y = np.zeros((4, 6))
        Y[0, :2] = Y[2, :3] = Y[1, 0] = 1
        report_pair(_problem(), Y=Y)


@pytest.mark.parametrize("num_jobs,num_gpus", [(4, 4), (12, 6), (40, 16)])
def test_pdhg_with_duals_reports_the_kernels_iterate(num_jobs, num_gpus):
    """The port's solve with duals on the CPU (kernel A's plain version):
    its report is ``dual_report`` of the relaxed iterate the same solve
    returns, bit for bit, its plan the pdhg backend's, two calls are
    bit-equal, and the report is within the limits of two summation
    orders of the JAX package's."""
    rng = np.random.RandomState(num_jobs)
    problem = EGProblem(
        priorities=1.0 + rng.rand(num_jobs),
        completed_epochs=rng.randint(0, 3, num_jobs).astype(np.float64),
        total_epochs=np.full(num_jobs, 8.0),
        epoch_duration=60.0 + 30.0 * rng.rand(num_jobs),
        remaining_runtime=300.0 + 2000.0 * rng.rand(num_jobs),
        nworkers=rng.randint(1, 3, num_jobs).astype(np.float64),
        num_gpus=num_gpus, round_duration=120.0, future_rounds=6,
        regularizer=1e-3, log_bases=np.linspace(0.0, 1.0, 6))
    port = port_problem(problem)
    Y, report = eg_pdhg.solve_eg_pdhg_with_duals(port, device="cpu")
    Y2, report2 = eg_pdhg.solve_eg_pdhg_with_duals(port, device="cpu")
    s, _, _ = eg_pdhg.solve_pdhg_relaxed(port, device="cpu")
    for other in (report2, duals.dual_report(port, s=s)):
        for field in ARRAYS:
            assert (getattr(report, field).tobytes()
                    == getattr(other, field).tobytes()), field
        assert report.to_dict() == other.to_dict()
    np.testing.assert_array_equal(Y, Y2)
    np.testing.assert_array_equal(Y, eg_pdhg.solve_eg_pdhg(port,
                                                           device="cpu"))
    port.audit_schedule(Y)
    ref_Y, ref_report = ref_pdhg.solve_eg_pdhg_with_duals(problem)
    np.testing.assert_allclose(report.s, ref_report.s, rtol=5e-3, atol=5e-3)
    # The JAX package's report of the port's iterate is the port's.
    assert_bit_equal(report, ref_duals.dual_report(problem, s=report.s))
