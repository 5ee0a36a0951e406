"""The port's level-set solve and its host helpers against the JAX
package's, on the same EGProblems made from numpy seeds.

Counts must be equal and objectives within 1e-6 relative: the objective's
sum over jobs is taken in another order than XLA's, so its last bits may
differ. Padding, slot bands, rounding, placement, reordering and the
native greedy must be bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu import native as ref_native
from shockwave_tpu.solver import eg_jax
from shockwave_tpu.solver import rounding as ref_rounding
from shockwave_tpu.solver.eg_problem import EGProblem
from shockwave_tpu_torch import native
from shockwave_tpu_torch.solver import eg_level, rounding
from shockwave_tpu_torch.solver.eg_problem import EGProblem as PortEGProblem
from shockwave_tpu_torch.tools import bench_sim

BANDS = tuple(bench_sim.PARITY_PER_BAND)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _copy_problem(problem, cls):
    fields = {}
    for field in dataclasses.fields(problem):
        value = getattr(problem, field.name)
        fields[field.name] = (np.array(value) if isinstance(value, np.ndarray)
                              else value)
    return cls(**fields)


def port_problem(problem: EGProblem) -> PortEGProblem:
    """A JAX-package EGProblem as the port's, field by field, arrays
    copied as numpy arrays (the state counterpart of
    ``models/convert.py::params_from_jax``)."""
    return _copy_problem(problem, PortEGProblem)


def random_problem(seed: int, band: int, bonus: bool) -> EGProblem:
    """The seeded parity problem of ``bench_sim.parity_problem`` (gangs
    1-8 wide, some wider than the cluster, some finished jobs, with
    ``bonus`` incumbents with a relaunch overhead) as the JAX package's."""
    return _copy_problem(bench_sim.parity_problem(seed, band, bonus),
                         EGProblem)


def problems(band: int, bonus: bool, count: int = None):
    return [_copy_problem(p, EGProblem)
            for p in bench_sim.parity_problems(band, bonus, count)]


@pytest.mark.parametrize("bonus", [False, True], ids=["plain", "switch_bonus"])
@pytest.mark.parametrize("band", BANDS)
def test_level_counts_equal_the_reference(band, bonus):
    for problem in problems(band, bonus):
        assert eg_level.num_slots_for(problem.num_jobs) == band
        assert np.any(problem.switch_bonus() > 0) == bonus
        ref_counts, ref_obj = eg_jax.solve_level_counts(problem)
        counts, obj = eg_level.solve_level_counts(port_problem(problem),
                                                  "cpu")
        np.testing.assert_array_equal(counts, ref_counts)
        assert obj == pytest.approx(ref_obj, rel=1e-6)


@pytest.mark.parametrize("band", BANDS)
def test_host_helpers_are_bit_identical(band):
    """pad_problem, num_slots_for, refine_counts, order_schedule,
    reorder_rounds, counts_to_schedule and the native greedy, on the
    same problems and the reference's counts."""
    for i, problem in enumerate(problems(band, bonus=band % 128 == 0,
                                         count=4)):
        port = port_problem(problem)
        slots = eg_jax.num_slots_for(problem.num_jobs)
        assert eg_level.num_slots_for(port.num_jobs) == slots
        ref_packed = eg_jax.pad_problem(problem, slots)
        packed = eg_level.pad_problem(port, slots, "cpu")
        for name, value in ref_packed.items():
            np.testing.assert_array_equal(packed[name].numpy(),
                                          np.asarray(value), err_msg=name)
        counts, _ = eg_jax.solve_level_counts(problem)
        refined = rounding.refine_counts(counts, port)
        np.testing.assert_array_equal(
            refined, ref_rounding.refine_counts(counts, problem))
        args = (problem.priorities, problem.nworkers, problem.num_gpus)
        Y = rounding.order_schedule(refined, *args, problem.future_rounds)
        np.testing.assert_array_equal(
            Y, ref_rounding.order_schedule(refined, *args,
                                           problem.future_rounds))
        np.testing.assert_array_equal(
            rounding.reorder_rounds(Y.copy(), *args),
            ref_rounding.reorder_rounds(Y.copy(), *args))
        np.testing.assert_array_equal(
            eg_level.counts_to_schedule(counts, port, "cpu"),
            eg_jax.counts_to_schedule(counts, problem))
        if i < 2 and ref_native.available():
            np.testing.assert_array_equal(
                native.solve_eg_greedy_native(port),
                ref_native.solve_eg_greedy_native(problem))


def test_levels_equal_jnp_linspace_bitwise():
    for n in (2, 16, 64, 65):
        np.testing.assert_array_equal(
            eg_level.levels(n, "cpu").numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, n)))
    # The trap the explicit grid avoids.
    assert not np.array_equal(torch.linspace(0, 1, 64).numpy(),
                              np.asarray(jnp.linspace(0.0, 1.0, 64)))


def test_interp_is_jnp_interp_bitwise():
    rng = np.random.default_rng(7)
    xp = np.array([0.0, 0.2, 0.4, 0.4, 0.6, 0.8, 1.0], np.float32)
    fp = np.log(np.where(xp == 0.0, 1e-6, xp)).astype(np.float32)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 4979), xp,
                        np.nextafter(xp, 2), np.nextafter(xp, -2)])
    x = x.astype(np.float32).reshape(-1, 8)
    ours = eg_level.interp(torch.from_numpy(x), torch.from_numpy(xp),
                           torch.from_numpy(fp))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jnp.interp(x, xp, fp)))


def test_solves_are_counted_by_device():
    before = eg_level.SOLVES["cpu"]
    eg_level.solve_level_counts(port_problem(random_problem(3, 64, False)),
                                torch.device("cpu"))
    assert eg_level.SOLVES["cpu"] == before + 1


def test_unpackable_counts_without_a_compiler_raise(monkeypatch):
    """Placement that drops grants falls back to the greedy. With no
    compiler to build the native one, the port takes its PyTorch greedy
    and returns the JAX package's schedule (which takes its jitted greedy
    there); a native greedy that was built and raises is raised, not
    swapped for the PyTorch one."""
    from shockwave_tpu.solver.eg_problem import EGProblem as RefEGProblem

    fields = dict(
        priorities=np.ones(2), completed_epochs=np.zeros(2),
        total_epochs=np.full(2, 10.0), epoch_duration=np.full(2, 100.0),
        remaining_runtime=np.full(2, 1000.0), nworkers=np.full(2, 2.0),
        num_gpus=3, round_duration=100.0, future_rounds=2,
        regularizer=1e-3, log_bases=bench_sim.LOG_BASES)
    problem, ref = PortEGProblem(**fields), RefEGProblem(**fields)
    counts = np.array([2, 1])
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(ref_native, "available", lambda: False)
    Y = eg_level.counts_to_schedule(counts, problem, "cpu", polish=False)
    np.testing.assert_array_equal(
        Y, eg_jax.counts_to_schedule(counts, ref, polish=False))
    # The greedy's plan: one round each, feasible in both rounds.
    assert Y.sum(axis=1).tolist() == [1, 1]
    assert np.all(problem.nworkers @ Y <= problem.num_gpus)

    def broken(problem):
        raise RuntimeError("a built native greedy that fails")

    monkeypatch.setattr(native, "available", lambda: True)
    monkeypatch.setattr(native, "solve_eg_greedy_native", broken)
    with pytest.raises(RuntimeError, match="built native greedy"):
        eg_level.counts_to_schedule(counts, problem, "cpu", polish=False)


@pytest.mark.parametrize("name", ["solve_eg_level", "solve_level_counts",
                                  "pad_problem"])
def test_level_solve_needs_an_explicit_device(name):
    problem = port_problem(random_problem(3, 64, False))
    args = (problem, 64) if name == "pad_problem" else (problem,)
    with pytest.raises(TypeError, match="device"):
        getattr(eg_level, name)(*args)


def test_device_check_passes_equal_counts_and_names_a_miss(monkeypatch):
    """``bench_sim.check_device_counts`` (the card's counts against the
    CPU's, in chip_smoke.py) is silent on equal solves and names a
    problem whose counts or objective moved."""
    sample = bench_sim.parity_problems(64, True, 3)
    assert bench_sim.check_device_counts(sample, "cpu") == []
    solve = eg_level.solve_level_counts
    cpu = torch.device("cpu")

    def off_by_one(problem, device):
        counts, obj = solve(problem, cpu)
        if device == "count":
            counts = counts.copy()
            counts[0] += 1
        return counts, obj * (1 + 1e-5) if device == "objective" else obj

    monkeypatch.setattr(eg_level, "solve_level_counts", off_by_one)
    assert [m.split(":")[1] for m in bench_sim.check_device_counts(
        sample, "count")] == [" 1 counts differ"] * 3
    assert all("objective" in m for m in bench_sim.check_device_counts(
        sample, "objective"))


def test_parity_problems_cover_every_band():
    sample = bench_sim.parity_problems()
    assert len(sample) == 204
    slots = {eg_level.num_slots_for(p.num_jobs) for p in sample}
    assert slots == set(bench_sim.PARITY_PER_BAND)


def test_crossover_and_sample():
    rows = [dict(jobs=j, level_ms=l, native_ms=n) for j, l, n in
            [(10, 5, 1), (300, 4, 5), (200, 6, 5), (900, 3, 9)]]
    assert bench_sim.crossover(rows) == 300
    assert bench_sim.crossover(rows + [dict(jobs=950, level_ms=9,
                                            native_ms=8)]) is None
    problems = [bench_sim.seeded_problem(j, num_gpus=8)
                for j in (*range(1, 34), 3, 7)]
    sample = [p.num_jobs for p in bench_sim.sample_by_jobs(problems)]
    assert sample == [1, 4, 7, 10, 13, 16, 18, 21, 24, 27, 30, 33]
    assert [p.num_jobs for p in bench_sim.sample_by_jobs(
        problems[:5])] == [1, 2, 3, 4, 5]
