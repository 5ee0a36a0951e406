"""Level-set solve of the EG planning program on a torch device.

The counterpart of the JAX package's ``shockwave_tpu/solver/eg_jax.py``
for the planner's level backend: ``solve_level`` (eg_jax.py:387),
``solve_level_counts`` (:548), ``solve_eg_level`` (:528),
``counts_to_schedule`` (:631), ``pad_problem`` (:668), ``num_slots_for``
(:700) and ``_EPS``. The reference jits ``solve_level`` with XLA; no
Pallas kernel sits under it, so here it is plain PyTorch on an explicit
device: the CPU in the tests, the card in production. Its integer plans
are bit-identical to the reference's (tests/test_torch_solver.py).

What keeps them identical:
  * every operation is float32, one eager op at a time, and where XLA
    contracts a product feeding a sum into a fused multiply-add (the
    interpolation, the level grids, the objective), :func:`fma` computes
    it rounded once, as XLA does on the CPU;
  * the levels are ``arange(64) * f32(1/63)``, which equals
    ``jnp.linspace(0, 1, 64)`` bit for bit (``torch.linspace`` differs
    in 30 of the 64 values);
  * ``jnp.interp`` is reproduced op for op (:func:`interp`);
  * the density sort is stable, as ``jnp.argsort`` is, so ties and the
    ``-inf`` cells keep index order, and ``argmax`` takes the first
    maximum in both;
  * prefix sums add integer gang widths in float32, exact in any order
    while the running total stays below 2^24;
  * every scalar that divides is a float32 tensor on the device: on CUDA,
    PyTorch divides by a host scalar as a multiplication by its
    reciprocal, which can be off by an ulp.
Only the objective's sum over jobs is taken in another order than XLA's,
so objectives may differ in their last bits; a plan changes only where
two different count vectors tie to an ulp.

The two passes over the 64 levels are batched as [64, J*R] tensors (the
reference's ``vmap``), and a solve makes one device-to-host fetch, of
the winning counts and objective together. Not ported, because they
are JAX's own: the serialized-executable warm start
(``solver/warm_start.py``) and the sanitizer hooks
(``analysis/sanitize.py``).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from shockwave_tpu_torch import native, obs
from shockwave_tpu_torch.solver.eg_problem import EGProblem
from shockwave_tpu_torch.solver.rounding import order_schedule, refine_counts

_EPS = 1e-6
GRID_SIZE = 64
_F32 = torch.float32
# jnp.interp's guard against a zero-width breakpoint interval.
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))

# Level solves by the device type their tensors lay on (chip_smoke.py
# reads it to show the main path solved on the card).
SOLVES: Counter = Counter()


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``, op for op: constant extrapolation to
    ``fp[0]`` / ``fp[-1]`` outside ``xp``."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, fp[i - 1],
                    fma(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float32, rounded once, as XLA contracts a product
    feeding a sum into one fused multiply-add. The float32 product is
    exact in float64, so only the sum rounds there; rounding it again to
    float32 differs from a single rounding only when the float64 sum
    falls within 2^-29 of a float32 tie."""
    f64 = torch.float64
    return (torch.as_tensor(a).to(f64) * torch.as_tensor(b).to(f64)
            + torch.as_tensor(c).to(f64)).to(_F32)


def levels(grid_size: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, grid_size)`` in float32, bit for bit."""
    step = torch.tensor(1.0 / (grid_size - 1), dtype=_F32, device=device)
    return torch.arange(grid_size, dtype=_F32, device=device) * step


def solve_level(
    active: torch.Tensor,  # [J] 0/1 mask over padded job slots
    priorities: torch.Tensor,  # [J]
    completed: torch.Tensor,  # [J]
    total: torch.Tensor,  # [J]
    epoch_dur: torch.Tensor,  # [J]
    remaining: torch.Tensor,  # [J]
    nworkers: torch.Tensor,  # [J]
    num_gpus: torch.Tensor,  # scalar
    log_bases: torch.Tensor,  # [B] piecewise-log breakpoints
    log_vals: torch.Tensor,  # [B] log at the breakpoints
    round_duration: float,
    future_rounds: int,
    regularizer: float,
    switch_bonus: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-set solve (eg_jax.py:387-525; its docstring gives the
    method): for each makespan level t, the closed-form mandatory counts
    n_min(t), then a threshold fill of the leftover budget in marginal
    density order; 64 levels, then 64 more between the winner's grid
    neighbours. Returns (counts [J] int32, best objective), both on the
    inputs' device."""
    device = active.device
    R = future_rounds
    J = priorities.shape[0]

    def scalar(x):
        return torch.tensor(x, dtype=_F32, device=device)

    dur = scalar(round_duration)
    reg = scalar(regularizer)
    epoch_dur = torch.clamp_min(epoch_dur, _EPS)
    fits = (nworkers <= num_gpus) & (active > 0)
    num_active = torch.clamp_min(active.sum(), 1.0)
    norm = num_active * R
    need_sec = torch.clamp_min(total - completed, 0.0) * epoch_dur
    budget = num_gpus * R

    # Utility and lateness tables over round counts k = 0..R.
    k_sec = torch.arange(R + 1, dtype=_F32, device=device) * dur
    planned_sec = torch.minimum(k_sec[None, :], need_sec[:, None])
    progress = (completed[:, None] + planned_sec / epoch_dur[:, None]) / (
        total[:, None])
    U = (active[:, None] * priorities[:, None]
         * interp(progress, log_bases, log_vals) / norm)
    if switch_bonus is not None:
        # Keep-incumbent bonus on every k >= 1: it raises only the first
        # marginal, so the within-job density order stays decreasing.
        first = torch.arange(R + 1, device=device)[None, :] >= 1
        U = U + torch.where(first, switch_bonus[:, None], 0.0)
    L = active[:, None] * torch.clamp_min(remaining[:, None] - planned_sec,
                                          0.0)
    dU = U[:, 1:] - U[:, :-1]  # [J, R]
    density = dU / nworkers[:, None]

    # Makespan floor: fitting jobs can use the whole window, the others
    # stay at their current lateness.
    is_active = active > 0
    L_best = torch.where(fits, L[:, R], L[:, 0])
    floor = torch.where(is_active, L_best, 0.0).max()
    M0 = torch.where(is_active, L[:, 0], 0.0).max()

    # The density order does not depend on t: one stable sort, and the
    # inverse permutation to bring per-cell takes back to job order.
    usable = fits[:, None] & (density > 1e-12)
    d_flat = torch.where(usable, density, -torch.inf).reshape(-1)
    order = torch.argsort(-d_flat, stable=True)
    d_ok = torch.isfinite(d_flat[order])
    w_cell = nworkers[:, None].expand(J, R).reshape(-1)
    w_sorted = torch.where(d_ok, w_cell[order], 0.0)
    k_sorted = (order % R).to(_F32)
    j_sorted = order // R
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(J * R, device=device)
    jobs = torch.arange(J, device=device)[None, :]

    def eval_levels(t):  # t: [T] makespan levels
        T = t.shape[0]
        t_eff = torch.maximum(t, floor)
        n_min = torch.ceil(
            torch.clamp_min(remaining[None, :] - t_eff[:, None], 0.0) / dur)
        n_min = torch.where(fits[None, :], torch.clamp(n_min, 0.0, float(R)),
                            0.0)
        residual = budget - (nworkers[None, :] * n_min).sum(dim=1)
        # Welfare fill: cells above the mandatory count, in density
        # order, while the budget lasts.
        open_sorted = d_ok[None, :] & (k_sorted[None, :] >= n_min[:, j_sorted])
        w_open = torch.where(open_sorted, w_sorted[None, :], 0.0)
        cum = torch.cumsum(w_open, dim=1)
        take = (cum <= residual[:, None]) & open_sorted
        taken = take[:, inv_order].reshape(T, J, R).to(_F32).sum(dim=2)
        counts = (n_min + taken).to(torch.int32)
        index = counts.long()
        U_at = U[jobs, index]
        L_at = L[jobs, index]
        obj = fma(-reg, L_at.max(dim=1).values, U_at.sum(dim=1))
        return counts, torch.where(residual >= 0.0, obj, -torch.inf)

    span = torch.clamp_min(M0 - floor, 0.0)
    lin = levels(GRID_SIZE, device)
    counts1, obj1 = eval_levels(fma(span, lin, floor))
    best1 = torch.argmax(obj1).reshape(1)
    # Refine between the winner's grid neighbours.
    step = span / scalar(GRID_SIZE - 1)
    lo = fma(span, lin.index_select(0, best1)[0], floor) - step
    counts2, obj2 = eval_levels(fma(2.0 * step, lin, lo))
    counts = torch.cat([counts1, counts2])
    obj = torch.cat([obj1, obj2])
    best = torch.argmax(obj).reshape(1)
    return counts.index_select(0, best)[0], obj.index_select(0, best)[0]


def solve_eg_level(problem: EGProblem, device) -> np.ndarray:
    """End-to-end level-set solve on ``device``; returns a feasible
    boolean schedule Y ([J, R]). Counts the level solve makes are
    aggregate-budget feasible but not always packable per round under
    gang widths; :func:`counts_to_schedule` then weighs the greedy
    against the placement."""
    with obs.backend_phases("level", problem.num_jobs) as bp:
        counts, _ = solve_level_counts(problem, device)
        bp.phase("device")
        Y = counts_to_schedule(counts, problem, device)
        bp.phase("host")
    return Y


def solve_level_counts(problem: EGProblem,
                       device) -> Tuple[np.ndarray, float]:
    """Device head of the level solve: pad, copy to ``device`` (one
    copy), solve, fetch the counts and objective (one fetch)."""
    device = torch.device(device)
    slots = num_slots_for(problem.num_jobs)
    packed = pad_problem(problem, slots, device)
    counts, obj = solve_level(
        packed["active"], packed["priorities"], packed["completed"],
        packed["total"], packed["epoch_dur"], packed["remaining"],
        packed["nworkers"], packed["num_gpus"], packed["log_bases"],
        packed["log_vals"],
        round_duration=float(problem.round_duration),
        future_rounds=int(problem.future_rounds),
        regularizer=float(problem.regularizer),
        switch_bonus=packed.get("switch_bonus"),
    )
    SOLVES[counts.device.type] += 1
    # The objective's bits ride along with the counts: one fetch.
    host = torch.cat([counts, obj.reshape(1).view(torch.int32)]).cpu().numpy()
    return (host[: problem.num_jobs].astype(np.int64),
            float(host[-1:].view(np.float32)[0]))


def counts_to_schedule(
    counts: np.ndarray, problem: EGProblem, device, polish: bool = True
) -> np.ndarray:
    """Host tail of the level solve: exchange polish, per-round
    placement, and, where placement dropped grants (gang widths that do
    not tile the cluster), the greedy if it scores better: the native
    greedy where a C++ compiler builds it, else the PyTorch greedy
    (:func:`shockwave_tpu_torch.solver.eg_greedy.solve_eg_greedy`) on
    ``device``. Unlike the reference (eg_jax.py:651-664), a native greedy
    that was built and then raises is an error, raised here, not a
    reason to switch solvers."""
    if polish:
        counts = refine_counts(counts, problem)
    Y = order_schedule(
        counts,
        problem.priorities,
        problem.nworkers,
        problem.num_gpus,
        problem.future_rounds,
    )
    if np.any(Y.sum(axis=1) < counts):
        if native.available():
            Y_alt = native.solve_eg_greedy_native(problem)
        else:
            from shockwave_tpu_torch.solver.eg_greedy import solve_eg_greedy

            Y_alt = solve_eg_greedy(problem, device)
        if problem.objective_value(Y_alt) > problem.objective_value(Y):
            Y = Y_alt
    return Y


def pad_problem(problem: EGProblem, num_slots: int,
                device) -> Dict[str, torch.Tensor]:
    """Pack an EGProblem into padded float32 tensors on ``device``: the
    reference's fields (``switch_bonus`` only when some bonus is
    nonzero), plus the piecewise-log breakpoints and their values, all
    from one host buffer in one copy."""
    J = problem.num_jobs
    if J > num_slots:
        raise ValueError(f"{J} jobs > {num_slots} slots")
    rows = [
        ("active", np.ones(J), 0.0),
        ("priorities", problem.priorities, 0.0),
        ("completed", problem.completed_epochs, 0.0),
        ("total", problem.total_epochs, 1.0),
        ("epoch_dur", problem.epoch_duration, 1.0),
        ("remaining", problem.remaining_runtime, 0.0),
        ("nworkers", problem.nworkers, 1.0),
    ]
    bonus = problem.switch_bonus()
    if np.any(bonus > 0.0):
        rows.append(("switch_bonus", bonus, 0.0))
    bases = np.asarray(problem.log_bases, dtype=np.float32)
    B = bases.shape[0]
    host = np.empty(len(rows) * num_slots + 1 + 2 * B, dtype=np.float32)
    for i, (_, x, fill) in enumerate(rows):
        row = host[i * num_slots:(i + 1) * num_slots]
        row[:] = fill
        row[:J] = x
    tail = len(rows) * num_slots
    host[tail] = float(problem.num_gpus)
    host[tail + 1:tail + 1 + B] = bases
    host[tail + 1 + B:] = problem.log_base_values()
    flat = torch.from_numpy(host).to(device)
    packed = {name: flat[i * num_slots:(i + 1) * num_slots]
              for i, (name, _, _) in enumerate(rows)}
    packed["num_gpus"] = flat[tail]
    packed["log_bases"] = flat[tail + 1:tail + 1 + B]
    packed["log_vals"] = flat[tail + 1 + B:]
    return packed


def num_slots_for(num_jobs: int, minimum: int = 64) -> int:
    """Next power-of-two slot count >= num_jobs."""
    n = minimum
    while n < num_jobs:
        n *= 2
    return n
