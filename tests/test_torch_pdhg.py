"""The port's restarted PDHG solve (plain version of kernel A) and its host
helpers against the JAX package's, on the CPU.

Inputs are the JAX package's seeded bench problems (``bench.make_problem``,
numpy seeds) and hand-built analytic instances. The port's plain
``_pdhg_core`` repeats the reference's float32 arithmetic op for op; only
its sums run in another order, so it is held to the reference's own limits
for two summation orders of the same arithmetic (tests/test_pdhg.py:
377-398): ``s`` within rtol = atol = 5e-3, the objective within
1e-3 (1 + |obj|) and the rounded counts' objective within 2e-3 (1 + |o|).
The host helpers (rounding, warm-start alignment) must be exact. All
problems stay below 8192 jobs, where the reference's ``solve_eg_pdhg``
would go sharded over the 8 host devices the conftest gives JAX.

The rest are the port's copies of the reference's contracts
(tests/test_pdhg.py:47-198).
"""

import numpy as np
import pytest
import torch

import bench
from shockwave_tpu.solver import eg_pdhg as ref_pdhg
from shockwave_tpu.solver import rounding as ref_rounding
from shockwave_tpu.solver import warm_start as ref_warm_start
from shockwave_tpu_torch.ops import eg_pdhg as kernel
from shockwave_tpu_torch.solver import eg_level, eg_pdhg, rounding, warm_start
from shockwave_tpu_torch.solver.eg_problem import EGProblem
from test_torch_solver import port_problem

S_TOL = 5e-3
OBJ_TOL = 1e-3
ROUNDED_TOL = 2e-3
# The problems of the parity tests: (jobs, rounds, GPUs, seed).
BENCH_CASES = [(100, 20, 64, 0), (100, 20, 64, 1), (100, 20, 64, 5),
               (1000, 50, 256, 0)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counts_objective(problem, counts):
    R = problem.future_rounds
    Y = (np.arange(R)[None, :] < np.asarray(counts)[:, None]).astype(float)
    return problem.objective_value(Y)


def rounded_objective(problem, s):
    return counts_objective(problem, ref_rounding.round_counts(
        s, problem.nworkers, problem.num_gpus, problem.future_rounds))


def assert_matches(problem, s, obj, ref_s, ref_obj):
    """The three limits of two summation orders (module docstring)."""
    np.testing.assert_allclose(s, ref_s, rtol=S_TOL, atol=S_TOL)
    assert abs(obj - ref_obj) <= OBJ_TOL * (1.0 + abs(ref_obj))
    o, ref_o = rounded_objective(problem, s), rounded_objective(problem,
                                                                ref_s)
    assert abs(o - ref_o) <= ROUNDED_TOL * (1.0 + abs(ref_o))


def solve(problem, **kwargs):
    return eg_pdhg.solve_pdhg_relaxed(port_problem(problem), device="cpu",
                                      **kwargs)


@pytest.mark.parametrize("jobs, rounds, gpus, seed", BENCH_CASES)
def test_plain_core_matches_the_reference(jobs, rounds, gpus, seed):
    p = bench.make_problem(num_jobs=jobs, future_rounds=rounds,
                           num_gpus=gpus, seed=seed)
    ref_s, ref_obj, ref_info = ref_pdhg.solve_pdhg_relaxed(p)
    s, obj, info = solve(p)
    assert_matches(p, s, obj, ref_s, ref_obj)
    assert info["cycles"] == ref_info["cycles"]
    assert info["converged"] == ref_info["converged"]
    assert info["welfare_filled"] == ref_info["welfare_filled"]


@pytest.mark.parametrize("seed", [0, 3])
def test_projected_warm_start_matches_the_reference(seed):
    """max_cycles=0: the warm start's budget projection (the reference's
    ``_project``, which ``project_budget`` repeats) within 1e-6, and the
    solve's objective within 1e-6 relative. The solve then runs the
    welfare fill, whose 80-step bisection on a sum moves ``s`` by up to
    ~1.5e-5 between the two summation orders; ``s`` is held to the
    two-orders limit."""
    import jax.numpy as jnp
    from shockwave_tpu.solver import eg_jax
    from shockwave_tpu_torch.solver import eg_relaxed

    p = bench.make_problem(num_jobs=100, future_rounds=20, num_gpus=64,
                           seed=seed)
    rough = np.random.default_rng(seed).uniform(-2.0, p.future_rounds + 2,
                                                p.num_jobs)
    slots = eg_level.num_slots_for(p.num_jobs)
    host = eg_pdhg._packed_args(port_problem(p), slots, rough, 1e-4, 1e-5)
    w = host[0] * host[6]
    s_max = np.where((host[6] <= p.num_gpus) & (host[0] > 0),
                     np.float32(p.future_rounds), np.float32(0.0))
    budget = np.float32(p.num_gpus) * np.float32(p.future_rounds)
    ref_proj = np.asarray(eg_jax._project(
        jnp.asarray(host[8]), jnp.asarray(w), jnp.asarray(budget),
        jnp.asarray(s_max)))
    proj = eg_relaxed._project(*(torch.from_numpy(np.asarray(x)) for x in (
        host[8], w, budget, s_max))).numpy()
    np.testing.assert_allclose(proj, ref_proj, rtol=1e-6, atol=1e-6)

    ref_s, ref_obj, _ = ref_pdhg.solve_pdhg_relaxed(p, s0=rough,
                                                    max_cycles=0)
    s, obj, info = solve(p, s0=rough, max_cycles=0)
    assert obj == pytest.approx(ref_obj, rel=1e-6)
    assert_matches(p, s, obj, ref_s, ref_obj)
    assert info["cycles"] == 0 and not info["converged"]


@pytest.mark.parametrize("seed", [0, 1])
def test_restart_path_matches_the_reference(seed):
    """With the stall stop disabled the restart-to-average branch and the
    primal-weight rebalancing run for up to 40 cycles in both. Which
    cycles restart depends on near-ties of two residuals, so the counts
    differ between summation orders (seed 0: the reference restarts 5
    times and converges at cycle 14, the port converges exactly, at
    residual 0, at cycle 11 without one); the result is held to the
    two-orders limits."""
    p = bench.make_problem(num_jobs=1000, future_rounds=50, num_gpus=256,
                           seed=seed)
    kw = dict(stall_rel=-1.0, tol=1e-6, max_cycles=40)
    ref_s, ref_obj, ref_info = ref_pdhg.solve_pdhg_relaxed(p, **kw)
    s, obj, info = solve(p, **kw)
    assert_matches(p, s, obj, ref_s, ref_obj)
    assert ref_info["restarts"] >= 1
    assert info["restarts"] >= 1 or info["residual"] == 0.0


def test_wrapper_on_the_cpu_is_the_plain_version():
    p = port_problem(bench.make_problem(num_jobs=40, future_rounds=8,
                                        num_gpus=16, seed=0))
    slots = eg_level.num_slots_for(p.num_jobs)
    packed = torch.from_numpy(eg_pdhg._packed_args(p, slots, None, 1e-4,
                                                   1e-5))
    kernel.reset_launch_counts()
    out = kernel.pdhg(torch.stack([packed, packed]), 96, 40)
    plain = eg_pdhg._pdhg_core(packed, 96, 40)
    assert out.shape == (2, slots + len(eg_pdhg.DIAG))
    assert torch.equal(out[0], plain) and torch.equal(out[1], plain)
    assert kernel.LAUNCHES["eg_pdhg"] == 0
    with pytest.raises(ValueError, match="packed problems"):
        kernel.pdhg(packed, 96, 40)


def test_sharded_scale_with_several_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(eg_pdhg, "SHARDED_PDHG_MIN_JOBS", 4)
    assert eg_pdhg.sharded_min_jobs() == 4
    p = port_problem(bench.make_problem(num_jobs=8, future_rounds=4,
                                        num_gpus=4, seed=0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eg_pdhg.solve_eg_pdhg(p, device="cuda")


def test_sharded_threshold_is_the_reference_default():
    assert eg_pdhg.SHARDED_PDHG_MIN_JOBS == ref_pdhg.SHARDED_PDHG_MIN_JOBS
    assert eg_pdhg.DEFAULT_MAX_CYCLES == ref_pdhg.DEFAULT_MAX_CYCLES
    assert eg_pdhg.DEFAULT_INNER_ITERS == ref_pdhg.DEFAULT_INNER_ITERS


# -- host helpers: exact --------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_round_counts_and_schedule_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    p = bench.make_problem(num_jobs=int(rng.integers(5, 300)),
                           future_rounds=int(rng.integers(4, 40)),
                           num_gpus=int(rng.choice([8, 64, 256])), seed=seed)
    R = p.future_rounds
    # Fractional, integral, out-of-box and over-budget rows.
    s = rng.uniform(-1.0, R + 1.0, p.num_jobs)
    s[::7] = np.round(s[::7])
    args = (p.nworkers, p.num_gpus, R)
    np.testing.assert_array_equal(rounding.round_counts(s, *args),
                                  ref_rounding.round_counts(s, *args))
    sched_args = (s, p.priorities, p.nworkers, p.num_gpus, R)
    np.testing.assert_array_equal(
        rounding.schedule_from_relaxed(*sched_args),
        ref_rounding.schedule_from_relaxed(*sched_args))
    np.testing.assert_array_equal(
        rounding.schedule_from_relaxed(*sched_args, problem=port_problem(p)),
        ref_rounding.schedule_from_relaxed(*sched_args, problem=p))


@pytest.mark.parametrize("seed", range(6))
def test_warm_start_alignment_equals_the_reference(seed):
    """Seeded churn: departures, survivors (reordered) and arrivals."""
    rng = np.random.default_rng(seed)
    prev_ids = [f"j{i}" for i in rng.permutation(40)[:int(rng.integers(0,
                                                                       30))]]
    prev_counts = rng.integers(0, 10, len(prev_ids)).astype(float)
    survivors = [j for j in prev_ids if rng.random() < 0.7]
    arrivals = [f"n{i}" for i in range(int(rng.integers(0, 6)))]
    new_ids = list(rng.permutation(survivors + arrivals))
    nworkers = rng.choice([1.0, 2.0, 4.0], len(new_ids))
    for fill in (0.0, -1.0):
        np.testing.assert_array_equal(
            warm_start.align_rows(prev_ids, prev_counts, new_ids, fill),
            ref_warm_start.align_rows(prev_ids, prev_counts, new_ids, fill))
    for gpus, rounds in ((8, 10), (2, 4)):
        got = warm_start.delta_patch_counts(prev_ids, prev_counts, new_ids,
                                            nworkers, gpus, rounds)
        want = ref_warm_start.delta_patch_counts(
            prev_ids, prev_counts, new_ids, nworkers, gpus, rounds)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    # No churn: the identity alignment.
    np.testing.assert_array_equal(
        warm_start.align_rows(prev_ids, prev_counts, list(prev_ids)),
        prev_counts)


# -- the reference's contracts (tests/test_pdhg.py:47-198) ---------------


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_matches_level_backend(seed):
    """The full pdhg backend (solve, rounding, polish, placement) lands
    within 0.1% of the level backend, both the port's, on the CPU."""
    p = port_problem(bench.make_problem(num_jobs=100, future_rounds=20,
                                        num_gpus=64, seed=seed))
    Y = eg_pdhg.solve_eg_pdhg(p, device="cpu")
    p.audit_schedule(Y)
    o_pdhg = p.objective_value(Y)
    o_level = p.objective_value(eg_level.solve_eg_level(p, "cpu"))
    assert o_pdhg >= o_level - 1e-3 * abs(o_level)


LOG_BASES = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0])


def test_analytic_single_job_completes():
    p = EGProblem(
        priorities=np.array([2.0]), completed_epochs=np.array([0.0]),
        total_epochs=np.array([4.0]), epoch_duration=np.array([60.0]),
        remaining_runtime=np.array([240.0]), nworkers=np.array([1.0]),
        num_gpus=4, round_duration=60.0, future_rounds=10, regularizer=10.0,
        log_bases=LOG_BASES,
    )
    s, obj, info = eg_pdhg.solve_pdhg_relaxed(p, device="cpu")
    assert info["converged"]
    assert s[0] >= 4.0 - 1e-3
    assert abs(obj) < 1e-3


def test_analytic_symmetric_jobs_split_evenly():
    J = 8
    p = EGProblem(
        priorities=np.full(J, 3.0), completed_epochs=np.zeros(J),
        total_epochs=np.full(J, 10.0), epoch_duration=np.full(J, 100.0),
        remaining_runtime=np.full(J, 1000.0), nworkers=np.ones(J),
        num_gpus=4, round_duration=100.0, future_rounds=10,
        regularizer=1e-3, log_bases=LOG_BASES,
    )
    s, _, _ = eg_pdhg.solve_pdhg_relaxed(p, device="cpu")
    assert np.all(np.abs(s - 5.0) < 0.35), s
    assert float(np.sum(s)) <= 40.0 + 1e-3


def test_switch_bonus_keeps_incumbent():
    J = 4
    base = dict(
        priorities=np.array([0.01, 10.0, 10.0, 10.0]),
        completed_epochs=np.zeros(J), total_epochs=np.full(J, 10.0),
        epoch_duration=np.full(J, 100.0),
        remaining_runtime=np.full(J, 1000.0), nworkers=np.ones(J),
        num_gpus=1, round_duration=100.0, future_rounds=4,
        regularizer=1e-3, log_bases=LOG_BASES,
    )
    blind = EGProblem(**base)
    s_blind, _, _ = eg_pdhg.solve_pdhg_relaxed(blind, device="cpu")
    assert rounding.round_counts(s_blind, blind.nworkers, 1, 4)[0] == 0
    aware = EGProblem(**base, switch_cost=np.array([1e5, 0.0, 0.0, 0.0]),
                      incumbent=np.array([1.0, 0.0, 0.0, 0.0]))
    s_aware, _, _ = eg_pdhg.solve_pdhg_relaxed(aware, device="cpu")
    assert rounding.round_counts(s_aware, aware.nworkers, 1, 4)[0] >= 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_restarts_trigger_and_preserve_quality(seed):
    """With the objective-stall stop disabled the adaptive machinery
    engages and the long run's rounded objective matches the default
    adaptive stop. Restart-to-average fires unless the last iterate
    reaches an exact fixed point first (residual 0, where no average can
    be closer): on seed 0 the port's summation order does that at cycle
    11 (see test_restart_path_matches_the_reference)."""
    p = port_problem(bench.make_problem(num_jobs=1000, future_rounds=50,
                                        num_gpus=256, seed=seed))
    s_default, _, info_default = eg_pdhg.solve_pdhg_relaxed(p, device="cpu")
    s_long, _, info_long = eg_pdhg.solve_pdhg_relaxed(
        p, stall_rel=-1.0, tol=1e-6, max_cycles=40, device="cpu")
    assert info_long["restarts"] >= 1 or info_long["residual"] == 0.0
    assert info_long["cycles"] > info_default["cycles"]
    args = (p.nworkers, p.num_gpus, p.future_rounds)
    o_default = counts_objective(p, rounding.round_counts(s_default, *args))
    o_long = counts_objective(p, rounding.round_counts(s_long, *args))
    assert o_default >= o_long - 1e-3 * abs(o_long)


def test_solution_warm_start_roundtrip():
    p = port_problem(bench.make_problem(num_jobs=100, future_rounds=20,
                                        num_gpus=64, seed=2))
    s1, obj1, info1 = eg_pdhg.solve_pdhg_relaxed(p, device="cpu")
    s2, obj2, info2 = eg_pdhg.solve_pdhg_relaxed(p, s0=s1, device="cpu")
    assert obj2 >= obj1 - 1e-5 * (1.0 + abs(obj1))
    assert info2["cycles"] <= info1["cycles"] + 1
    _, obj3, _ = eg_pdhg.solve_pdhg_relaxed(
        p, s0=np.full(p.num_jobs, -7.0), device="cpu")
    assert obj3 >= obj1 - 1e-3 * (1.0 + abs(obj1))


def test_polish_never_hurts():
    p = port_problem(bench.make_problem(num_jobs=100, future_rounds=20,
                                        num_gpus=64, seed=3))
    rough = np.random.default_rng(0).uniform(0.0, p.future_rounds,
                                             p.num_jobs)
    _, obj_ref, _ = eg_pdhg.solve_pdhg_relaxed(p, device="cpu")
    polished = eg_pdhg.polish_relaxed(p, rough, device="cpu")
    _, obj_at_polished, _ = eg_pdhg.solve_pdhg_relaxed(
        p, s0=polished, max_cycles=0, device="cpu")
    _, obj_at_rough, _ = eg_pdhg.solve_pdhg_relaxed(
        p, s0=rough, max_cycles=0, device="cpu")
    assert obj_at_polished >= obj_at_rough - 1e-6 * (1 + abs(obj_at_rough))
    assert obj_at_polished >= obj_ref - 1e-2 * (1 + abs(obj_ref))
