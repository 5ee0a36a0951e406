"""Restarted PDHG solve of the relaxed EG market (first-order, matrix-free).

The counterpart of the JAX package's ``shockwave_tpu/solver/eg_pdhg.py``
on one device: the plain PyTorch ``_pdhg_core`` (eg_pdhg.py:121-500 with
``axis_name=None``) and the entry points ``_default_s0`` (:633),
``_packed_args`` (:647), ``solve_pdhg_relaxed`` (:672),
``polish_relaxed`` (:787), ``solve_eg_pdhg_with_duals`` (:806, its
report from :mod:`shockwave_tpu_torch.solver.duals`) and
``solve_eg_pdhg`` (:850); the lanes of the
cells market and the what-if fleet are packed here too
(:func:`pack_problems`, :func:`overlay_lanes`, :func:`solve_lanes`). The
method is the reference's; its docstring gives the saddle-point
formulation, the restart-to-average scheme, the objective-stall stop
and the closed-form welfare fill.

On a CUDA device a solve is one launch of kernel A
(``shockwave_tpu_torch/ops/csrc/eg_pdhg.cu``, wrapper
:func:`shockwave_tpu_torch.ops.eg_pdhg.pdhg`): one copy in, one fetch
out. On the CPU the wrapper runs :func:`_pdhg_core` here, which is that
kernel's plain version: the same float32 arithmetic, op for op, with
every global reduction a ``torch.sum``/``torch.max``. The two differ
only in the order of those sums, so they agree to the reference's own
limits for two summation orders (``tests/test_pdhg.py:377-398``): ``s``
within rtol = atol = 5e-3, the objective within 1e-3 (1 + |obj|).

Where the reference has a ``lax.cond`` (the dual projection skips its
bisection when the cap is slack) the plain version computes both
branches and selects, which gives the same values without a host
round trip; its one host read per cycle is the while-loop's test.

The sharded path (``solve_pdhg_relaxed_sharded``, one problem's job axis
over several cards) is not ported: at the reference's dispatch scale
with more than one card visible, :func:`solve_eg_pdhg` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.solver.eg_level import _EPS, num_slots_for
from shockwave_tpu_torch.solver.eg_problem import EGProblem

_F32 = torch.float32
_SQRT2 = 1.4142135623730951
# Step-size safety factor: tau * sigma * ||K||^2 = _STEP_SAFETY^2 < 1.
_STEP_SAFETY = 0.95
# Bisection depths: primal prox over [0, R] and the dual capped-simplex
# threshold; the budget projection and the welfare fill take 60 and 80.
_PROX_BISECT = 30
_DUAL_BISECT = 30
_BUDGET_BISECT = 60
_FILL_BISECT = 80

DEFAULT_MAX_CYCLES = 96
DEFAULT_INNER_ITERS = 40
DEFAULT_TOL = 1e-4
# Objective-stall stop: once the best feasible iterate stops improving
# by stall_rel (relative) for _STALL_CYCLES consecutive cycles, stop. A
# negative stall_rel disables it.
_STALL_REL = 1e-5
_STALL_CYCLES = 3

# Fleet scale from which the reference routes a solve to its sharded
# mesh path when more than one device is visible
# (shockwave_tpu/solver/eg_pdhg.py:99): the reference's default, kept as
# it is. The sharded path is not ported, so there the solve raises; the
# reference's SHOCKWAVE_PDHG_SHARDED_MIN_JOBS override waits with it.
SHARDED_PDHG_MIN_JOBS = 8192

# Rows of the packed problem, one per padded job slot; the last row
# holds the scalars in its first entries (SCALARS).
ROWS = ("active", "priorities", "completed", "total", "epoch_dur",
        "remaining", "nworkers", "switch_bonus", "s0")
SCALARS = ("num_gpus", "round_duration", "future_rounds", "regularizer",
           "tol", "stall_rel")
# Entries after the slots in a solve's output row, in order.
DIAG = ("best_obj", "cycles", "iterations", "restarts", "residual",
        "residual0", "converged", "welfare_filled")


def sharded_min_jobs() -> int:
    """The dispatch threshold, :data:`SHARDED_PDHG_MIN_JOBS`."""
    return SHARDED_PDHG_MIN_JOBS


def _pdhg_core(packed: torch.Tensor, max_cycles: int,
               inner_iters: int) -> torch.Tensor:
    """Plain version of kernel A on one packed problem ([len(ROWS) + 1,
    slots] float32, see :func:`_packed_args`). Returns one float32 row:
    the best budget-feasible ``s`` over the slots, then :data:`DIAG`."""
    device = packed.device
    (active, priorities, completed, total, epoch_dur, remaining, nworkers,
     switch_bonus, s0) = packed[:len(ROWS)]
    scal = packed[len(ROWS)]
    num_gpus, round_duration, R, k, tol, stall_rel = (
        scal[i] for i in range(len(SCALARS)))

    def f32(x):
        return torch.tensor(x, dtype=_F32, device=device)

    eps = f32(_EPS)
    zero = f32(0.0)
    dur = torch.maximum(round_duration, eps)
    total_ep = torch.maximum(total, eps)
    epoch_dur = torch.maximum(epoch_dur, eps)
    fits = (nworkers <= num_gpus) & (active > 0)
    s_max = torch.where(fits, R, zero)
    num_active = torch.maximum(active.sum(), f32(1.0))
    # Welfare coefficients: progress_j(s) = A_j + beta_j * min(s, xcap_j).
    q = active * priorities / (num_active * R)
    A = completed / total_ep
    beta = dur / (epoch_dur * total_ep)
    need_sec = torch.maximum(total - completed, zero) * epoch_dur
    xcap = need_sec / dur
    bonus = active * switch_bonus
    # Lateness floor no grant can move; padded slots contribute 0.
    C = torch.maximum(
        torch.where(active > 0, remaining - need_sec, zero).max(), zero)
    rem_sh = (remaining - C) / dur
    # Budget row, normalized so ||K||^2 = 2.
    w = active * nworkers
    budget = num_gpus * R
    wnorm = torch.sqrt(torch.maximum((w * w).sum(), eps))
    what = w / wnorm
    bhat = budget / wnorm
    cap = k * dur
    nqb = -q * beta
    one = f32(1.0)
    half = f32(0.5)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def prox_primal(v, tau):
        """prox of tau * (phi - B min(., 1)) + box, by a fixed bisection
        on the sign of the 1-D subproblem's monotone derivative."""
        lo = torch.zeros_like(v)
        hi = s_max
        for _ in range(_PROX_BISECT):
            mid = half * (lo + hi)
            slope = torch.where(mid < xcap, nqb / (A + eps + beta * mid),
                                zero)
            slope = slope - torch.where(mid < one, bonus, zero)
            neg = (mid - v + tau * slope) < zero
            lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
        return half * (lo + hi)

    def proj_dual(v):
        """Projection onto {y >= 0, sum y <= k * dur}: the bisection on
        the threshold runs always and is selected when the cap binds."""
        v = torch.maximum(v, zero) * active
        total_v = v.sum()
        lo, hi = zero, v.max()
        for _ in range(_DUAL_BISECT):
            mid = half * (lo + hi)
            over = torch.maximum(v - mid, zero).sum() > cap
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        projected = torch.maximum(v - half * (lo + hi), zero)
        return torch.where(total_v > cap, projected, v)

    w_pos = w > 0
    wmin = -torch.where(w_pos, -w, f32(-torch.inf)).max()
    max_s_max = s_max.max()

    def project_budget(s):
        """Euclidean projection onto {0 <= s <= s_max, w . s <= budget}."""
        clipped = clip(s, zero, s_max)
        need = (w * clipped).sum() > budget
        hi = (s.abs().max() + max_s_max) / torch.maximum(wmin, eps)
        lo = zero
        for _ in range(_BUDGET_BISECT):
            mid = half * (lo + hi)
            over = (w * clip(s - mid * w, zero, s_max)).sum() > budget
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        lam = half * (lo + hi)
        return torch.where(need, clip(s - lam * w, zero, s_max), clipped)

    def objective(s):
        progress = A + beta * torch.minimum(s, xcap)
        welfare = (q * torch.log(progress + eps)).sum()
        welfare = welfare + (bonus * torch.minimum(s, one)).sum()
        makespan = torch.maximum(C, (remaining - dur * s).max())
        return welfare - k * makespan

    def pdhg_step(s, y, lam, tau, sigma):
        s_new = prox_primal(s + tau * (y - lam * what), tau)
        sbar = 2.0 * s_new - s
        y_new = proj_dual(y + sigma * (rem_sh - sbar))
        lam_new = torch.maximum(lam + sigma * ((what * sbar).sum() - bhat),
                                zero)
        return s_new, y_new, lam_new

    def movement(s, y, lam, tau, sigma):
        s2, y2, l2 = pdhg_step(s, y, lam, tau, sigma)
        ds, dy, dl = s2 - s, y2 - y, l2 - lam
        dp = torch.sqrt((ds * ds).sum())
        dd = torch.sqrt((dy * dy).sum() + dl * dl)
        return torch.sqrt(dp * dp + dd * dd), dp, dd

    def welfare_fill(s):
        """Closed-form KKT water-fill of the residual budget, holding the
        achieved makespan (reference eg_pdhg.py:287-374)."""
        M = torch.maximum(C, (remaining - dur * s).max())
        n_min = clip(torch.ceil((remaining - M) / dur - 1e-4), zero, s_max)
        hi = torch.maximum(torch.minimum(xcap, s_max), n_min)
        hi = torch.maximum(
            hi, torch.where(bonus > 0, torch.minimum(one, s_max), zero))
        gain = q * beta
        w_safe = torch.where(w_pos, w, one)
        beta_safe = torch.maximum(beta, f32(1e-20))
        xcap0 = torch.maximum(xcap, zero)

        def s_of(lam):
            lw = lam * w_safe
            raw_w = (gain / lw - A - eps) / beta_safe
            raw_b = (gain / torch.maximum(lw - bonus, f32(1e-30)) - A
                     - eps) / beta_safe
            s_lam = torch.where(
                raw_w >= one, raw_w,
                torch.where(lw <= bonus, one,
                            torch.minimum(clip(raw_b, zero, one), xcap0)))
            return clip(s_lam, n_min, hi)

        dens_min = gain / ((A + eps + beta * n_min) * w_safe)
        lam_hi = 2.0 * torch.maximum(
            torch.maximum(dens_min.max(), (bonus / w_safe).max()),
            f32(1e-30))
        lam_lo = f32(1e-30)
        for _ in range(_FILL_BISECT):
            mid = torch.sqrt(lam_lo * lam_hi)
            over = (w * s_of(mid)).sum() > budget
            lam_lo = torch.where(over, mid, lam_lo)
            lam_hi = torch.where(over, lam_hi, mid)
        return torch.where((w * hi).sum() <= budget, hi, s_of(lam_hi))

    s = clip(s0, zero, s_max)
    y = torch.zeros_like(s)
    lam = zero
    best_s = project_budget(s)
    best_obj = objective(best_s)
    omega = torch.sqrt((s_max * s_max).sum() + 1.0) / (cap + 1.0)
    res = res0 = f32(torch.inf)
    restarts = cycle = stall = 0
    done = False
    inv = f32(1.0 / inner_iters)
    step_safety, sqrt2 = f32(_STEP_SAFETY), f32(_SQRT2)
    while cycle < max_cycles and not done:
        tau = step_safety * omega / sqrt2
        sigma = step_safety / (omega * sqrt2)
        ss, sy, sl = torch.zeros_like(s), torch.zeros_like(y), zero
        s_c, y_c, l_c = s, y, lam
        for _ in range(inner_iters):
            s_c, y_c, l_c = pdhg_step(s_c, y_c, l_c, tau, sigma)
            ss, sy, sl = ss + s_c, sy + y_c, sl + l_c
        s_a, y_a, l_a = ss * inv, sy * inv, sl * inv
        res_c, dp_c, dd_c = movement(s_c, y_c, l_c, tau, sigma)
        res_a, dp_a, dd_a = movement(s_a, y_a, l_a, tau, sigma)
        # Restart-to-average when the cycle's average is closer to a
        # fixed point than the last iterate.
        use_avg = res_a < res_c
        s = torch.where(use_avg, s_a, s_c)
        y = torch.where(use_avg, y_a, y_c)
        lam = torch.where(use_avg, l_a, l_c)
        res = torch.minimum(res_a, res_c)
        dp = torch.where(use_avg, dp_a, dp_c)
        dd = torch.where(use_avg, dd_a, dd_c)
        omega = clip(torch.sqrt(omega * dd / torch.maximum(dp, f32(1e-12))),
                     f32(1e-4), f32(1e4))
        s_f = project_budget(s)
        obj = objective(s_f)
        better = obj > best_obj
        improved = obj > best_obj + stall_rel * (1.0 + best_obj.abs())
        denom = (1.0 + torch.sqrt((s * s).sum())
                 + torch.sqrt((y * y).sum() + lam * lam))
        best_s = torch.where(better, s_f, best_s)
        best_obj = torch.maximum(obj, best_obj)
        res0 = res if cycle == 0 else res0
        # The while-loop's test: one host read a cycle.
        use_avg, improved, converged = (
            torch.stack([use_avg, improved, res <= tol * denom]).tolist())
        restarts += int(use_avg)
        stall = 0 if improved else stall + 1
        cycle += 1
        done = converged or stall >= _STALL_CYCLES

    # Exact welfare tail, kept only when the summed per-job delta says it
    # improves the objective and the fill stays within the budget.
    s_filled = welfare_fill(best_s)
    prog_new = A + beta * torch.minimum(s_filled, xcap)
    prog_old = A + beta * torch.minimum(best_s, xcap)
    d_welfare = (
        q * (torch.log(prog_new + eps) - torch.log(prog_old + eps))
        + bonus * (torch.minimum(s_filled, one) - torch.minimum(best_s, one))
    ).sum()
    d_makespan = (torch.maximum(C, (remaining - dur * s_filled).max())
                  - torch.maximum(C, (remaining - dur * best_s).max()))
    delta = d_welfare - k * d_makespan
    feasible = (w * s_filled).sum() <= budget * f32(1.0 + 1e-6)
    fill_wins = (delta > 0) & feasible
    best_s = torch.where(fill_wins, s_filled, best_s)
    best_obj = torch.where(fill_wins, best_obj + delta, best_obj)
    diag = torch.stack([
        best_obj, f32(cycle), f32(cycle * inner_iters), f32(restarts),
        res, res0, f32(float(done)), fill_wins.to(_F32)])
    return torch.cat([best_s, diag])


def _default_s0(problem: EGProblem) -> np.ndarray:
    """Demand-point warm start: every job asks for exactly the rounds it
    needs to finish (clipped to the window)."""
    need_sec = (
        np.maximum(problem.total_epochs - problem.completed_epochs, 0.0)
        * problem.epoch_duration
    )
    return np.minimum(
        need_sec / max(problem.round_duration, 1e-9),
        float(problem.future_rounds),
    )


def _packed_args(problem: EGProblem, slots: int, s0, tol: float,
                 stall_rel: float) -> np.ndarray:
    """The problem padded to ``slots`` as one float32 host buffer
    ([len(ROWS) + 1, slots]): the reference's padded fields (fill 0, or 1
    for total, epoch_dur and nworkers), the switch bonus (zeros for an
    overhead-blind problem), the warm start ``s0`` (the demand point by
    default), and the scalars :data:`SCALARS`."""
    J = problem.num_jobs
    if J > slots:
        raise ValueError(f"{J} jobs > {slots} slots")
    if s0 is None:
        s0 = _default_s0(problem)
    host = np.zeros((len(ROWS) + 1, slots), dtype=np.float32)
    host[[3, 4, 6]] = 1.0
    for i, x in enumerate((
            np.ones(J), problem.priorities, problem.completed_epochs,
            problem.total_epochs, problem.epoch_duration,
            problem.remaining_runtime, problem.nworkers,
            problem.switch_bonus())):
        host[i, :J] = x
    host[len(ROWS) - 1, :J] = np.asarray(s0, np.float32)[:J]
    host[len(ROWS), :len(SCALARS)] = (
        float(problem.num_gpus), float(problem.round_duration),
        float(problem.future_rounds), float(problem.regularizer),
        float(tol), float(stall_rel))
    return host


def pack_problems(problems, s0s, slots: int, tol: float,
                  stall_rel: float) -> np.ndarray:
    """Several problems as one host buffer of lanes ([C, len(ROWS) + 1,
    slots] float32), each lane :func:`_packed_args` of its problem with
    its own scalar row (``num_gpus`` first): the counterpart of the JAX
    package's ``cells/batched.py::_stack_cells`` without its inert
    padding lanes."""
    return np.stack([_packed_args(p, slots, s0, tol, stall_rel)
                     for p, s0 in zip(problems, s0s)])


def overlay_lanes(base: np.ndarray, job_mask: np.ndarray,
                  priority_scale: np.ndarray, num_gpus, switch_scale,
                  round_duration, future_rounds, regularizer) -> np.ndarray:
    """Scenario lanes over one packed problem ``base`` ([len(ROWS) + 1,
    slots]): lane i holds ``active * job_mask[i]``, ``priorities *
    priority_scale[i]`` and ``switch_bonus * switch_scale[i]`` as float32
    products (the JAX package's ``whatif/scenario.py:129-131``), the base's
    other rows, and its own ``num_gpus``, ``round_duration``,
    ``future_rounds`` and ``regularizer`` in its scalar row (``tol`` and
    ``stall_rel`` stay the base's). Masks and scales are [L, slots]
    float32, the rest [L]."""
    lanes = np.repeat(base[None], len(num_gpus), axis=0)
    f32 = np.float32
    lanes[:, 0] = base[0] * np.asarray(job_mask, f32)
    lanes[:, 1] = base[1] * np.asarray(priority_scale, f32)
    lanes[:, 7] = base[7] * np.asarray(switch_scale, f32)[:, None]
    scalars = lanes[:, len(ROWS)]
    for i, values in enumerate((num_gpus, round_duration, future_rounds,
                                regularizer)):
        scalars[:, i] = np.asarray(values, f32)
    return lanes


def solve_lanes(packed: np.ndarray, max_cycles: int = DEFAULT_MAX_CYCLES,
                inner_iters: int = DEFAULT_INNER_ITERS,
                device="cuda") -> Tuple[np.ndarray, int]:
    """Solve packed lanes ([P, len(ROWS) + 1, slots]) on ``device``: one
    copy in, kernel A as a grid of P blocks (one launch, or one a chunk
    where a global instantiation's state would not fit the card:
    ``ops/eg_pdhg.py::lane_chunk``), one fetch out. Returns the output
    rows ([P, slots + len(DIAG)] float32) and the lanes a launch took."""
    from shockwave_tpu_torch.ops import eg_pdhg as kernel

    lanes = torch.from_numpy(np.ascontiguousarray(packed)).to(
        torch.device(device))
    chunk = kernel.lane_chunk(lanes)
    out = kernel.pdhg(lanes, int(max_cycles), int(inner_iters), chunk=chunk)
    return out.cpu().numpy(), chunk


def solve_lanes_on_mesh(packed: np.ndarray, mesh, axis_name: str,
                        band: int, max_cycles: int = DEFAULT_MAX_CYCLES,
                        inner_iters: int = DEFAULT_INNER_ITERS
                        ) -> Tuple[np.ndarray, int]:
    """:func:`solve_lanes` with the lanes split over ``mesh``'s places
    along ``axis_name``: the JAX package's ``shard_map`` of a band of
    ``band`` lanes (which the P places divide) in contiguous blocks of
    ``band / P``, its padding lanes dropped. Each place that holds lanes
    takes one copy in and one grid launch of kernel A on its device, all
    launched before the first fetch; the rows come back in lane order.
    Lanes are independent, so each is its one-lane launch in every bit.
    Returns the output rows and the most lanes a launch took."""
    from shockwave_tpu_torch.ops import eg_pdhg as kernel
    from shockwave_tpu_torch.parallel.mesh import axis_devices

    devices = axis_devices(mesh, axis_name)
    if band % len(devices) or band < len(packed):
        raise ValueError(f"{len(packed)} lanes in a band of {band} do not "
                         f"split over {len(devices)} places")
    per = band // len(devices)
    outs, chunk = [], 0
    for i, device in enumerate(devices):
        block = packed[i * per:(i + 1) * per]
        if not len(block):
            break
        lanes = torch.from_numpy(np.ascontiguousarray(block)).to(device)
        place_chunk = kernel.lane_chunk(lanes)
        outs.append(kernel.pdhg(lanes, int(max_cycles), int(inner_iters),
                                chunk=place_chunk))
        chunk = max(chunk, place_chunk)
    return np.concatenate([out.cpu().numpy() for out in outs]), chunk


def _diag_to_host(row: np.ndarray) -> dict:
    d = dict(zip(DIAG, row))
    return {
        "cycles": int(d["cycles"]),
        "iterations": int(d["iterations"]),
        "restarts": int(d["restarts"]),
        "residual": float(d["residual"]),
        "residual0": float(d["residual0"]),
        "converged": bool(d["converged"]),
        "welfare_filled": bool(d["welfare_filled"]),
    }


def solve_pdhg_relaxed(
    problem: EGProblem,
    s0: Optional[np.ndarray] = None,
    max_cycles: int = DEFAULT_MAX_CYCLES,
    inner_iters: int = DEFAULT_INNER_ITERS,
    tol: float = DEFAULT_TOL,
    stall_rel: float = _STALL_REL,
    device="cuda",
) -> Tuple[np.ndarray, float, dict]:
    """Device head of the single-device PDHG solve: pad, copy to
    ``device`` (one copy), solve, fetch (one fetch). Returns (s [J]
    float64, objective, diagnostics)."""
    slots = num_slots_for(problem.num_jobs)
    host = _packed_args(problem, slots, s0, tol, stall_rel)
    out = solve_lanes(host[None], max_cycles, inner_iters, device)[0][0]
    return (out[:problem.num_jobs].astype(np.float64),
            float(out[slots]), _diag_to_host(out[slots:]))


def polish_relaxed(
    problem: EGProblem,
    s: np.ndarray,
    max_cycles: int = 24,
    inner_iters: int = DEFAULT_INNER_ITERS,
    tol: float = DEFAULT_TOL,
    device="cuda",
) -> np.ndarray:
    """Bounded PDHG polish of a relaxed iterate (the PGD backend's
    parity-gap closer): warm-start at ``s`` and return the best
    budget-feasible iterate, never worse than ``s`` in the true relaxed
    objective."""
    s2, _, _ = solve_pdhg_relaxed(
        problem, s0=s, max_cycles=max_cycles, inner_iters=inner_iters,
        tol=tol, device=device,
    )
    return s2


def _refuse_sharded_scale(problem: EGProblem, device) -> None:
    """The reference shards a solve this large over several cards; that
    solve is not ported, so the port raises rather than quietly solving
    on one."""
    if (problem.num_jobs >= sharded_min_jobs() and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"the sharded PDHG solve is not ported to shockwave_tpu_torch "
            f"yet (ROADMAP.md, queue 2); at {problem.num_jobs} jobs with "
            f"{torch.cuda.device_count()} cards the reference would shard")


def solve_eg_pdhg(
    problem: EGProblem,
    s0: Optional[np.ndarray] = None,
    polish: bool = True,
    max_cycles: int = DEFAULT_MAX_CYCLES,
    inner_iters: int = DEFAULT_INNER_ITERS,
    tol: float = DEFAULT_TOL,
    device="cuda",
) -> np.ndarray:
    """End-to-end PDHG backend solve on ``device``; returns a feasible
    boolean schedule Y ([J, R]): the device head, then integer rounding,
    exchange polish and per-round placement on the host (the tail every
    counts-producing backend shares)."""
    from shockwave_tpu_torch.solver.eg_level import counts_to_schedule
    from shockwave_tpu_torch.solver.rounding import round_counts

    device = torch.device(device)
    _refuse_sharded_scale(problem, device)
    with obs.backend_phases("pdhg", problem.num_jobs) as bp:
        s, _, _ = solve_pdhg_relaxed(
            problem, s0=s0, max_cycles=max_cycles, inner_iters=inner_iters,
            tol=tol, device=device,
        )
        bp.phase("device")
        counts = round_counts(
            s, problem.nworkers, problem.num_gpus, problem.future_rounds
        )
        Y = counts_to_schedule(counts, problem, device, polish=polish)
        bp.phase("host")
    return Y


def solve_eg_pdhg_with_duals(
    problem: EGProblem,
    s0: Optional[np.ndarray] = None,
    polish: bool = True,
    max_cycles: int = DEFAULT_MAX_CYCLES,
    inner_iters: int = DEFAULT_INNER_ITERS,
    tol: float = DEFAULT_TOL,
    device="cuda",
):
    """The PDHG backend solve on ``device`` (one launch of kernel A on a
    card) plus its :class:`~shockwave_tpu_torch.solver.duals.DualReport`,
    taken at the relaxed iterate before integer rounding, where the
    saddle's duals are exact; then the host tail of
    :func:`solve_eg_pdhg`. Returns ``(Y, report)``. The report is the
    host function ``dual_report(problem, s=s)`` of the kernel's ``s``, so
    a bitwise repeatable kernel gives a bit-equal report (the JAX
    package's eg_pdhg.py:806-846)."""
    from shockwave_tpu_torch.solver.duals import dual_report
    from shockwave_tpu_torch.solver.eg_level import counts_to_schedule
    from shockwave_tpu_torch.solver.rounding import round_counts

    device = torch.device(device)
    _refuse_sharded_scale(problem, device)
    with obs.backend_phases("pdhg", problem.num_jobs) as bp:
        s, _, _ = solve_pdhg_relaxed(
            problem, s0=s0, max_cycles=max_cycles, inner_iters=inner_iters,
            tol=tol, device=device,
        )
        bp.phase("device")
        report = dual_report(problem, s=s)
        counts = round_counts(
            s, problem.nworkers, problem.num_gpus, problem.future_rounds
        )
        Y = counts_to_schedule(counts, problem, device, polish=polish)
        bp.phase("host")
    return Y, report
