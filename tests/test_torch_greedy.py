"""The port's PyTorch greedy (``shockwave_tpu_torch/solver/eg_greedy.py``)
against the JAX package's jitted greedy (``eg_jax.solve_eg_greedy``), on
the CPU.

Schedules must be equal, element for element, at grant batches 1, 16 and
the adaptive batch, on the seeded problems of tests/test_native_solver.py
(J=8, R=5, 4 GPUs, seeds 0-5, and its switch-cost problems, seeds 0-3),
on problems of tests/test_shockwave_solver.py::random_problem and on the
seeded parity problems of ``bench_sim`` (gangs 1-8 wide, some wider than
the cluster, with and without a switch bonus). ``num_grants_for`` and
``grant_batch_for`` must equal the JAX package's, and
``counts_to_schedule`` with the native greedy unavailable must return the
JAX package's schedule there.
"""

import numpy as np
import pytest
import torch

from shockwave_tpu import native as ref_native
from shockwave_tpu.solver import eg_jax
from shockwave_tpu_torch import native
from shockwave_tpu_torch.solver import eg_greedy, eg_level
from test_shockwave_solver import TestSwitchingCost, random_problem
from test_torch_solver import port_problem, problems

BATCHES = [1, 16, None]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_schedule(problem, grant_batch):
    ref = eg_jax.solve_eg_greedy(problem, grant_batch=grant_batch)
    ours = eg_greedy.solve_eg_greedy(port_problem(problem), "cpu",
                                     grant_batch=grant_batch)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    assert np.all(problem.nworkers @ ours <= problem.num_gpus + 1e-9)
    return ours


@pytest.mark.parametrize("grant_batch", BATCHES)
@pytest.mark.parametrize("seed", range(6))
def test_native_solver_problems(seed, grant_batch):
    """tests/test_native_solver.py::test_matches_jax_greedy_quality's
    problems."""
    problem = random_problem(np.random.default_rng(seed), J=8, R=5,
                             num_gpus=4)
    assert_same_schedule(problem, grant_batch)


@pytest.mark.parametrize("grant_batch", BATCHES)
@pytest.mark.parametrize("seed", range(4))
def test_switch_cost_problems(seed, grant_batch):
    """tests/test_native_solver.py::test_switch_cost_matches_jax_greedy_
    quality's problems (the keep-incumbent bonus on the first round)."""
    problem = TestSwitchingCost().switchy_problem(seed, J=8, R=5, num_gpus=4)
    assert_same_schedule(problem, grant_batch)


@pytest.mark.parametrize("grant_batch", BATCHES)
@pytest.mark.parametrize("seed", range(8))
def test_random_problems(seed, grant_batch):
    problem = random_problem(np.random.default_rng(100 + seed), J=12, R=6,
                             num_gpus=5)
    assert_same_schedule(problem, grant_batch)


@pytest.mark.parametrize("bonus", [False, True], ids=["plain", "switch_bonus"])
def test_parity_problems(bonus):
    """Four seeded parity problems of the 64-slot band, each at every
    batch, and the large native-solver instance (J=200, R=20, 64 GPUs) at
    the adaptive batch."""
    for problem in problems(64, bonus, 4):
        for grant_batch in BATCHES:
            assert_same_schedule(problem, grant_batch)
    if not bonus:
        large = random_problem(np.random.default_rng(0), J=200, R=20,
                               num_gpus=64)
        assert_same_schedule(large, None)


def test_grant_counts_and_batches_are_the_reference():
    for seed in range(5):
        problem = random_problem(np.random.default_rng(seed), J=8 + seed,
                                 R=3 + seed, num_gpus=2 + 3 * seed)
        port = port_problem(problem)
        for slots in (64, 128, 1024):
            assert eg_greedy.num_grants_for(port, slots) == (
                eg_jax.num_grants_for(problem, slots))
    for grants in (1, 4095, 4096, 4097, 16384):
        assert eg_greedy.grant_batch_for(grants) == (
            eg_jax.grant_batch_for(grants))


@pytest.mark.parametrize("seed,bonus", [(0, False), (0, True), (1, False),
                                        (2, True)])
def test_counts_to_schedule_without_a_compiler(seed, bonus, monkeypatch):
    """The level solve's counts of four parity problems (gangs up to 8
    chips, which placement cannot always tile), with the native greedy
    unavailable in both packages: placement drops grants, the PyTorch
    greedy runs once, and the port's schedule is the JAX package's."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(ref_native, "available", lambda: False)
    problem = problems(64, bonus, 4)[seed]
    port = port_problem(problem)
    counts = eg_level.solve_level_counts(port, "cpu")[0]
    before = eg_greedy.SOLVES["cpu"]
    ours = eg_level.counts_to_schedule(counts, port, "cpu")
    assert eg_greedy.SOLVES["cpu"] == before + 1
    np.testing.assert_array_equal(
        ours, eg_jax.counts_to_schedule(counts, problem))


def test_fallback_is_taken_where_placement_drops_grants(monkeypatch):
    """Gangs of 2 on 3 chips: the counts (2, 2) cannot be placed in 2
    rounds, so the fallback runs (the PyTorch greedy, counted) and its
    schedule is the JAX package's."""
    from shockwave_tpu.solver.eg_problem import EGProblem

    from shockwave_tpu_torch.tools import bench_sim

    fields = dict(
        priorities=np.array([1.0, 2.0]), completed_epochs=np.zeros(2),
        total_epochs=np.full(2, 10.0), epoch_duration=np.full(2, 100.0),
        remaining_runtime=np.full(2, 1000.0), nworkers=np.full(2, 2.0),
        num_gpus=3, round_duration=100.0, future_rounds=2,
        regularizer=1e-3, log_bases=bench_sim.LOG_BASES)
    problem = EGProblem(**fields)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(ref_native, "available", lambda: False)
    counts = np.array([2, 2])
    before = eg_greedy.SOLVES["cpu"]
    ours = eg_level.counts_to_schedule(counts, port_problem(problem), "cpu",
                                       polish=False)
    assert eg_greedy.SOLVES["cpu"] == before + 1
    np.testing.assert_array_equal(
        ours, eg_jax.counts_to_schedule(counts, problem, polish=False))


def test_bench_sim_problems_are_the_reference_tests():
    """``bench_sim.greedy_problems`` (chip_smoke.py's greedy check) are
    tests/test_native_solver.py's problems, field by field."""
    import dataclasses

    from shockwave_tpu_torch.tools import bench_sim

    ref = [random_problem(np.random.default_rng(seed), J=8, R=5, num_gpus=4)
           for seed in range(6)]
    ref += [TestSwitchingCost().switchy_problem(seed, J=8, R=5, num_gpus=4)
            for seed in range(4)]
    ref.append(random_problem(np.random.default_rng(0), J=200, R=20,
                              num_gpus=64))
    ours = [p for _, p in bench_sim.greedy_problems()]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for field in dataclasses.fields(b):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, field.name


def test_check_greedy_passes_on_the_cpu():
    from shockwave_tpu_torch.tools import bench_sim

    bad, rows = bench_sim.check_greedy(bench_sim.greedy_problems()[:3], "cpu")
    assert bad == []
    assert [r["differ"] for r in rows] == [0, 0, 0]
