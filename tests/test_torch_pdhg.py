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

import sys

import jax
import jax.numpy as jnp
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
    times and converges at cycle 14, the port converges at cycle 11
    without one; both end at a float32 residual of exactly 0.0, see
    test_both_zero_residuals_are_float32_fixed_points and
    test_restart_count_turns_on_a_near_tie); the result is held to the
    two-orders limits."""
    p = bench.make_problem(num_jobs=1000, future_rounds=50, num_gpus=256,
                           seed=seed)
    kw = dict(stall_rel=-1.0, tol=1e-6, max_cycles=40)
    ref_s, ref_obj, ref_info = ref_pdhg.solve_pdhg_relaxed(p, **kw)
    s, obj, info = solve(p, **kw)
    assert_matches(p, s, obj, ref_s, ref_obj)
    assert ref_info["restarts"] >= 1
    assert info["restarts"] >= 1 or info["residual"] == 0.0
    if seed == 0:
        # The reference ends at the same float32 fixed point.
        assert ref_info["residual"] == info["residual"] == 0.0


def _reference_cycles(p, max_cycles, **kw):
    """The reference's solve (``_pdhg_core`` under ``jax.jit``, as
    ``solve_pdhg_relaxed`` runs it) with its cycle loop's body wrapped to
    carry out what the last cycle saw: its omega, its last iterate (s, y,
    lam), its iterate sums (the average times ``inner_iters``) and its two
    float32 residuals, average and last (the scalar pair of its
    ``jnp.minimum``). Nothing of the reference changes: ``jax.lax.scan``,
    ``jax.lax.while_loop`` and ``jnp.minimum`` are wrapped only while it
    is traced. Returns ((s, obj, diag), final loop state, packed args,
    scalar kwargs)."""
    slots = eg_level.num_slots_for(p.num_jobs)
    args = ref_pdhg._packed_args(p, slots, None)
    scalars = dict(round_duration=float(p.round_duration),
                   future_rounds=float(p.future_rounds),
                   regularizer=float(p.regularizer), tol=float(kw["tol"]),
                   stall_rel=float(kw["stall_rel"]))
    real_scan, real_while, real_min = (jax.lax.scan, jax.lax.while_loop,
                                       jnp.minimum)
    seen = {"scan": [], "min": [], "on": False}
    finals = []

    def scan(f, init, xs, length=None, **kwargs):
        out = real_scan(f, init, xs, length=length, **kwargs)
        if seen["on"]:
            seen["scan"].append(out[0])
        return out

    def minimum(a, b):
        if seen["on"] and jnp.shape(a) == () == jnp.shape(b):
            seen["min"].append((a, b))
        return real_min(a, b)

    def while_loop(cond, body, init):
        keys = list(init)
        zero = jnp.zeros((), jnp.float32)
        last = (init["s"], init["y"], zero)

        def body2(state):
            seen["on"] = True
            try:
                new = body({k: state[k] for k in keys})
            finally:
                seen["on"] = False
            s_c, y_c, l_c, ss, sy, sl = seen["scan"][-1]
            return dict(new, c_omega=state["omega"], c_res=seen["min"][-1],
                        c_last=(s_c, y_c, l_c), c_sums=(ss, sy, sl))

        final = real_while(lambda state: cond({k: state[k] for k in keys}),
                           body2, dict(init, c_omega=init["omega"],
                                       c_res=(zero, zero), c_last=last,
                                       c_sums=last))
        finals.append(final)
        return {k: final[k] for k in keys}

    def run(*a, **k):
        out = ref_pdhg._pdhg_core(*a, **k, max_cycles=max_cycles,
                                  inner_iters=ref_pdhg.DEFAULT_INNER_ITERS,
                                  axis_name=None)
        return out, finals[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", scan)
        mp.setattr(jax.lax, "while_loop", while_loop)
        mp.setattr(jnp, "minimum", minimum)
        out, final = jax.jit(run)(*args, **scalars)
    return (jax.tree_util.tree_map(np.asarray, out),
            jax.tree_util.tree_map(np.asarray, final), args, scalars)


def _port_cycles(p, max_cycles, **kw):
    """The port's plain ``_pdhg_core`` and its locals as it returns (the
    last cycle's tau, sigma, iterates and residuals), read by a profile
    hook. Returns (output row, locals)."""
    slots = eg_level.num_slots_for(p.num_jobs)
    packed = torch.from_numpy(eg_pdhg._packed_args(
        port_problem(p), slots, None, kw["tol"], kw["stall_rel"]))
    code = eg_pdhg._pdhg_core.__code__
    found = {}

    def hook(frame, event, arg):
        if event == "return" and frame.f_code is code:
            found.update(frame.f_locals)

    old = sys.getprofile()
    sys.setprofile(hook)
    try:
        out = eg_pdhg._pdhg_core(packed, max_cycles,
                                 eg_pdhg.DEFAULT_INNER_ITERS)
    finally:
        sys.setprofile(old)
    return out.numpy(), found


def _steps_of(omega):
    """(tau, sigma) of a cycle from its omega, in float32 as both
    packages compute them."""
    omega, safety = np.float32(omega), np.float32(ref_pdhg._STEP_SAFETY)
    sqrt2 = np.float32(ref_pdhg._SQRT2)
    return safety * omega / sqrt2, safety / (omega * sqrt2)


def _movement_f64(args, scalars, s, y, lam, tau, sigma):
    """The reference's fixed-point residual (``movement``,
    shockwave_tpu/solver/eg_pdhg.py:278-285: one PDHG step's movement,
    the same bisection depths) in float64 at (s, y, lam) with the given
    step sizes. Returns (residual, primal part, dual part)."""
    (active, priorities, completed, total, epoch_dur, remaining, nworkers,
     bonus, _, num_gpus) = (np.asarray(a, np.float64) for a in args)
    eps = ref_pdhg._EPS
    tau, sigma = float(tau), float(sigma)
    dur = max(scalars["round_duration"], eps)
    R, k = scalars["future_rounds"], scalars["regularizer"]
    total_ep = np.maximum(total, eps)
    epoch_dur = np.maximum(epoch_dur, eps)
    s_max = np.where((nworkers <= num_gpus) & (active > 0), R, 0.0)
    q = active * priorities / (max(active.sum(), 1.0) * R)
    A = completed / total_ep
    beta = dur / (epoch_dur * total_ep)
    need_sec = np.maximum(total - completed, 0.0) * epoch_dur
    xcap = need_sec / dur
    bonus = active * bonus
    C = max(np.max(np.where(active > 0, remaining - need_sec, 0.0)), 0.0)
    rem_sh = (remaining - C) / dur
    w = active * nworkers
    wnorm = np.sqrt(max((w * w).sum(), eps))
    what, bhat = w / wnorm, float(num_gpus) * R / wnorm
    cap = k * dur

    def prox_primal(v):
        lo, hi = np.zeros_like(v), s_max.copy()
        for _ in range(ref_pdhg._PROX_BISECT):
            mid = 0.5 * (lo + hi)
            slope = np.where(mid < xcap, -q * beta / (A + eps + beta * mid),
                             0.0) - np.where(mid < 1.0, bonus, 0.0)
            neg = mid - v + tau * slope < 0.0
            lo, hi = np.where(neg, mid, lo), np.where(neg, hi, mid)
        return 0.5 * (lo + hi)

    def proj_dual(v):
        v = np.maximum(v, 0.0) * active
        if v.sum() <= cap:
            return v
        lo, hi = 0.0, v.max()
        for _ in range(ref_pdhg._DUAL_BISECT):
            mid = 0.5 * (lo + hi)
            lo, hi = ((mid, hi) if np.maximum(v - mid, 0.0).sum() > cap
                      else (lo, mid))
        return np.maximum(v - 0.5 * (lo + hi), 0.0)

    s, y, lam = (np.asarray(x, np.float64) for x in (s, y, lam))
    s2 = prox_primal(s + tau * (y - lam * what))
    sbar = 2.0 * s2 - s
    y2 = proj_dual(y + sigma * (rem_sh - sbar))
    lam2 = max(float(lam) + sigma * ((what * sbar).sum() - bhat), 0.0)
    dp = float(np.sqrt(((s2 - s) ** 2).sum()))
    dd = float(np.sqrt(((y2 - y) ** 2).sum() + (lam2 - lam) ** 2))
    return float(np.hypot(dp, dd)), dp, dd


RESTART_PROBLEM = dict(num_jobs=1000, future_rounds=50, num_gpus=256,
                       seed=0)
RESTART_KW = dict(stall_rel=-1.0, tol=1e-6)


def test_both_zero_residuals_are_float32_fixed_points():
    """The port ends at a float32 residual of 0.0 without a restart, the
    reference at 0.0 after 5 (1000 x 50 x 256, seed 0, stall stop off,
    tol 1e-6). Neither zero is exact: the reference's residual formula
    in float64 reads 1.798e-3 at both packages' last iterates, agreeing
    to 1e-6 relative, with the same split (primal ~3.5e-7, the rest
    dual). One PDHG step from there moves nothing in float32 in either
    package. So the port's residual and stop test are the reference's,
    and its zero is the reference's own float32 fixed point."""
    p = bench.make_problem(**RESTART_PROBLEM)
    (ref_s, ref_obj, ref_diag), ref_final, args, scalars = _reference_cycles(
        p, 40, **RESTART_KW)
    # The wrapped run is the reference's own solve, bit for bit.
    s, obj, info = ref_pdhg.solve_pdhg_relaxed(p, max_cycles=40,
                                               **RESTART_KW)
    assert np.array_equal(ref_s[:p.num_jobs], s.astype(np.float32))
    assert float(ref_obj) == obj
    assert int(ref_diag["restarts"]) == info["restarts"] == 5
    out, port = _port_cycles(p, 40, **RESTART_KW)
    diag = dict(zip(eg_pdhg.DIAG, out[-len(eg_pdhg.DIAG):]))
    assert diag["restarts"] == 0 and diag["converged"] == 1.0
    assert float(ref_diag["residual"]) == diag["residual"] == 0.0

    ref_res = _movement_f64(args, scalars, ref_final["s"], ref_final["y"],
                            ref_final["lam"], *_steps_of(
                                ref_final["c_omega"]))
    port_res = _movement_f64(args, scalars, port["s"].numpy(),
                             port["y"].numpy(), port["lam"].item(),
                             port["tau"].item(), port["sigma"].item())
    for res, dp, dd in (ref_res, port_res):
        assert 1.7e-3 < res < 1.9e-3
        assert dp < 1e-6 and dd == pytest.approx(res, rel=1e-6)
    assert port_res[0] == pytest.approx(ref_res[0], rel=1e-6)


def test_restart_count_turns_on_a_near_tie():
    """Where the restart counts part (same problem): cycle 5, the sixth.

    Up to cycle 4 neither package restarts, and cycle by cycle their
    float32 residuals agree to 2e-4 relative, which is what summation
    order leaves of a norm of step differences (s ~ 25, steps ~ 1e-2).
    At cycle 5 the reference's average iterate beats its last by 1.8e-5
    relative (0.7188735 against 0.7188863), ten times inside the two
    packages' disagreement there (2.4e-4 on the average's residual): the
    reference restarts to the average, the port keeps its last iterate
    (its average reads 1.4e-4 worse). Evaluated in float64, the
    reference's own two cycle-5 iterates rank the other way (the last
    6e-5 closer to a fixed point), as the port's do: the reference's
    restart is a float32 rounding of a near tie, and the port's choice is
    the exact arithmetic's. From there the trajectories differ, and both
    converge to the same result within the two-orders limits
    (test_restart_path_matches_the_reference)."""
    p = bench.make_problem(**RESTART_PROBLEM)
    for cycles in range(1, 7):
        _, _, ref_info = ref_pdhg.solve_pdhg_relaxed(p, max_cycles=cycles,
                                                     **RESTART_KW)
        _, _, info = solve(p, max_cycles=cycles, **RESTART_KW)
        assert info["residual"] == pytest.approx(ref_info["residual"],
                                                 rel=2e-4)
        # Up to cycle 4 neither restarts; at cycle 5 only the reference.
        assert ref_info["restarts"] == int(cycles == 6)
        assert info["restarts"] == 0

    (_, _, ref_diag), ref, args, scalars = _reference_cycles(p, 6,
                                                             **RESTART_KW)
    assert int(ref_diag["restarts"]) == 1
    ref_avg, ref_last = (float(x) for x in ref["c_res"])
    _, port = _port_cycles(p, 6, **RESTART_KW)
    port_avg, port_last = port["res_a"].item(), port["res_c"].item()
    # float32: the reference takes the average by a margin far inside the
    # packages' disagreement; the port keeps the last iterate.
    ref_margin = (ref_last - ref_avg) / ref_last
    noise = max(abs(port_avg - ref_avg) / ref_avg,
                abs(port_last - ref_last) / ref_last)
    assert 0.0 < ref_margin < 1e-4 and ref_margin < noise / 5
    assert port_avg >= port_last
    assert (port_avg - port_last) / port_last < 2e-4
    # float64, the reference's iterates and step sizes: the last iterate
    # is the closer one.
    steps = _steps_of(ref["c_omega"])
    inv = np.float32(1.0 / ref_pdhg.DEFAULT_INNER_ITERS)
    avg64 = _movement_f64(args, scalars, *(x * inv for x in ref["c_sums"]),
                          *steps)[0]
    last64 = _movement_f64(args, scalars, *ref["c_last"], *steps)[0]
    assert last64 < avg64 < last64 * (1.0 + 1e-4)
    # And so at the port's cycle-5 iterates.
    port_steps = port["tau"].item(), port["sigma"].item()
    port_avg64 = _movement_f64(args, scalars, port["s_a"].numpy(),
                               port["y_a"].numpy(), port["l_a"].item(),
                               *port_steps)[0]
    port_last64 = _movement_f64(args, scalars, port["s_c"].numpy(),
                                port["y_c"].numpy(), port["l_c"].item(),
                                *port_steps)[0]
    assert port_last64 < port_avg64


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
    reaches a float32 fixed point first (residual 0, where no average can
    be closer): on seed 0 the port's summation order does that at cycle
    11 without a restart (test_restart_count_turns_on_a_near_tie)."""
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
