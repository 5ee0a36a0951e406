"""Projected-gradient (Adam) solve of the relaxed EG program.

The counterpart of the JAX package's relaxed backend in
``shockwave_tpu/solver/eg_jax.py``: ``_project`` (:46), ``_objective``
(:75-117, with the annealed logsumexp temperature ``tau``), the gradient
``jax.grad`` takes of it, ``solve_relaxed`` (:121-205) and the entry
point ``solve_eg_jax`` (:716-757), here :func:`solve_eg_relaxed`, with
its bounded PDHG polish. The reference's docstrings give the method: the
boolean program collapses exactly to a J-dimensional concave problem
over the per-job round counts s, solved by 256 Adam steps with a cosine
step size, each re-projected onto the budget-box polytope, keeping the
best iterate by the true objective.

On a CUDA device a solve is one launch of kernel B
(``shockwave_tpu_torch/ops/csrc/eg_relaxed.cu``, wrapper
:func:`shockwave_tpu_torch.ops.eg_relaxed.relaxed`); on the CPU the
wrapper runs :func:`solve_relaxed` here, the kernel's plain version.

The gradient is written out (:func:`_grad`) in the order of the
reference's reverse pass, and like ``jax.grad`` it gives half the
derivative to each side where ``min``/``max`` tie: ``min(s, 1)`` at
s = 1, the planned-epochs cap ``min(granted / epoch_dur, left)`` at the
cap, and ``max(0, lateness)`` at zero lateness. ``torch.clamp`` does
not split at its bounds, so it appears only where no gradient is taken.

``solve_relaxed_batch`` (the reference's vmap over problems, :208) is
not on the planner's path and is not ported (ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.solver.eg_level import _EPS, num_slots_for
from shockwave_tpu_torch.solver.eg_problem import EGProblem

_F32 = torch.float32
DEFAULT_NUM_STEPS = 256
_PROJECT_BISECT = 60

# Rows of the packed problem, one per padded job slot; the last row
# holds the scalars in its first entries (SCALARS). ``half_lr`` is the
# reference's ``base_lr * 0.5`` = 0.05 R and ``s_init`` its R / 2, each
# rounded once to float32 as its Python constants are.
ROWS = ("active", "priorities", "completed", "total", "epoch_dur",
        "remaining", "nworkers", "switch_bonus")
SCALARS = ("num_gpus", "round_duration", "future_rounds", "regularizer",
           "half_lr", "s_init")
# Entries after the slots in a solve's output row.
DIAG = ("best_obj", "steps")


def _unpack(packed: torch.Tensor) -> dict:
    p = dict(zip(ROWS, packed[:len(ROWS)]))
    scal = packed[len(ROWS)]
    p.update((name, scal[i]) for i, name in enumerate(SCALARS))
    return p


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=device)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _project(s, weights, budget, s_max):
    """Euclidean projection onto {0 <= s <= s_max, weights . s <= budget}
    (eg_jax.py:46): 60 bisection steps on the budget row's dual."""
    zero = _f32(0.0, s.device)
    half = _f32(0.5, s.device)
    clipped = _clip(s, zero, s_max)
    need = (weights * clipped).sum() > budget
    wmin = torch.where(weights > 0, weights, _f32(torch.inf, s.device)).min()
    hi = (s.abs().max() + s_max.max()) / torch.maximum(
        wmin, _f32(_EPS, s.device))
    lo = zero
    for _ in range(_PROJECT_BISECT):
        mid = half * (lo + hi)
        over = (weights * _clip(s - mid * weights, zero, s_max)).sum() > budget
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    lam = half * (lo + hi)
    return torch.where(need, _clip(s - lam * weights, zero, s_max), clipped)


def _planned(s, p):
    """Granted seconds -> planned epochs, capped at finishing the job;
    returns (planned, granted / epoch_dur, the cap)."""
    a = s * p["round_duration"] / p["epoch_dur"]
    b = torch.maximum(p["total"] - p["completed"], _f32(0.0, s.device))
    return torch.minimum(a, b), a, b


def _objective(s, p, tau=None):
    """The relaxed objective (eg_jax.py:75-117); ``tau`` None is the hard
    makespan max, else its logsumexp smoothing at temperature ``tau``.
    ``p`` holds the unpacked problem with ``epoch_dur`` floored at
    ``_EPS`` and ``num_active``."""
    zero = _f32(0.0, s.device)
    planned, _, _ = _planned(s, p)
    progress = (p["completed"] + planned) / p["total"]
    welfare = (p["active"] * p["priorities"]
               * torch.log(progress + _f32(_EPS, s.device))).sum() / (
        torch.maximum(p["num_active"], _f32(1.0, s.device))
        * p["future_rounds"])
    welfare = welfare + (p["active"] * p["switch_bonus"]
                         * torch.minimum(s, _f32(1.0, s.device))).sum()
    lateness = p["active"] * torch.maximum(
        zero, p["remaining"] - p["epoch_dur"] * planned)
    if tau is None:
        makespan = lateness.max()
    else:
        z = lateness / tau
        amax = z.max()
        makespan = tau * (torch.log(torch.exp(z - amax).sum()) + amax)
    return welfare - p["regularizer"] * makespan


def _d_min(x, y):
    """d min(x, y) / dx as jax.grad takes it: 1 where x < y, half where
    they tie, 0 where x > y."""
    return torch.where(x < y, 1.0, torch.where(x == y, 0.5, 0.0)).to(_F32)


def _d_max(x, y):
    """d max(x, y) / dx as jax.grad takes it: 1 where x > y, half where
    they tie, 0 where x < y."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0)).to(_F32)


def _grad(s, p, tau):
    """d _objective(s, tau) / ds, in the order of jax.grad's reverse
    pass."""
    one = _f32(1.0, s.device)
    planned, a, b = _planned(s, p)
    u = (p["completed"] + planned) / p["total"] + _f32(_EPS, s.device)
    ct_welfare = one / (torch.maximum(p["num_active"], one)
                        * p["future_rounds"])
    ct_planned_w = ct_welfare * (p["active"] * p["priorities"]) / u / p[
        "total"]
    # Makespan: tau * logsumexp(lateness / tau), its max held constant.
    x = p["remaining"] - p["epoch_dur"] * planned
    z = p["active"] * torch.maximum(_f32(0.0, s.device), x) / tau
    e = torch.exp(z - z.max())
    ct_lateness = -p["regularizer"] * tau / e.sum() * e / tau
    ct_x = ct_lateness * p["active"] * _d_max(x, 0.0)
    ct_planned = ct_planned_w + -(ct_x * p["epoch_dur"])
    g = ct_planned * _d_min(a, b) / p["epoch_dur"] * p["round_duration"]
    return g + p["active"] * p["switch_bonus"] * _d_min(s, one)


def _prepare(packed: torch.Tensor) -> dict:
    p = _unpack(packed)
    p["epoch_dur"] = torch.maximum(p["epoch_dur"],
                                   _f32(_EPS, packed.device))
    p["num_active"] = p["active"].sum()
    return p


def solve_relaxed(packed: torch.Tensor,
                  num_steps: int = DEFAULT_NUM_STEPS) -> torch.Tensor:
    """Plain version of kernel B (eg_jax.py:121-205) on one packed problem
    ([len(ROWS) + 1, slots] float32, see :func:`_packed_args`). Returns
    one float32 row: the best ``s`` over the slots, its objective and
    the steps run."""
    device = packed.device
    p = _prepare(packed)
    R = p["future_rounds"]
    zero = _f32(0.0, device)
    weights = p["active"] * p["nworkers"]
    budget = p["num_gpus"] * R
    fits = (p["nworkers"] <= p["num_gpus"]) & (p["active"] > 0)
    s_max = torch.where(fits, R, zero)
    lateness_scale = torch.maximum((p["remaining"] * p["active"]).max(),
                                   _f32(1.0, device))
    tau0 = 0.05 * lateness_scale
    ratio = _f32(1.0, device) / tau0
    s = _project(torch.zeros_like(weights) + p["s_init"], weights, budget,
                 s_max)
    m = torch.zeros_like(s)
    v = torch.zeros_like(s)
    best_s, best_obj = s, _objective(s, p)
    b1, b2 = _f32(0.9, device), _f32(0.999, device)
    pi, steps = _f32(math.pi, device), _f32(num_steps, device)
    one = _f32(1.0, device)
    for i in range(num_steps):
        i_f = _f32(i, device)
        tau = tau0 * torch.pow(ratio, i_f / steps)
        g = _grad(s, p, tau)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        m_hat = m / (one - torch.pow(b1, i_f + 1.0))
        v_hat = v / (one - torch.pow(b2, i_f + 1.0))
        lr = p["half_lr"] * (one + torch.cos(pi * i_f / steps))
        s = _project(s + lr * m_hat / (torch.sqrt(v_hat) + 1e-8), weights,
                     budget, s_max)
        val = _objective(s, p)
        better = val > best_obj
        best_s = torch.where(better, s, best_s)
        best_obj = torch.where(better, val, best_obj)
    return torch.cat([best_s, best_obj.reshape(1), steps.reshape(1)])


def _packed_args(problem: EGProblem, slots: int) -> np.ndarray:
    """The problem padded to ``slots`` as one float32 host buffer
    ([len(ROWS) + 1, slots]): the reference's padded fields (fill 0, or 1
    for total, epoch_dur and nworkers), the switch bonus (zeros for an
    overhead-blind problem, which adds exactly nothing) and the scalars
    :data:`SCALARS`."""
    J = problem.num_jobs
    if J > slots:
        raise ValueError(f"{J} jobs > {slots} slots")
    R = int(problem.future_rounds)
    host = np.zeros((len(ROWS) + 1, slots), dtype=np.float32)
    host[[3, 4, 6]] = 1.0
    for i, x in enumerate((
            np.ones(J), problem.priorities, problem.completed_epochs,
            problem.total_epochs, problem.epoch_duration,
            problem.remaining_runtime, problem.nworkers,
            problem.switch_bonus())):
        host[i, :J] = x
    host[len(ROWS), :len(SCALARS)] = (
        float(problem.num_gpus), float(problem.round_duration), float(R),
        float(problem.regularizer), 0.1 * R * 0.5, R / 2.0)
    return host


def solve_relaxed_problem(problem: EGProblem,
                          num_steps: int = DEFAULT_NUM_STEPS,
                          device="cuda") -> tuple:
    """Device head of the relaxed solve: pad, copy to ``device`` (one
    copy), solve, fetch (one fetch). Returns (s [J] float64, objective)."""
    from shockwave_tpu_torch.ops import eg_relaxed as kernel

    slots = num_slots_for(problem.num_jobs)
    packed = torch.from_numpy(_packed_args(problem, slots)).to(
        torch.device(device))
    out = kernel.relaxed(packed[None], int(num_steps))[0].cpu().numpy()
    return out[:problem.num_jobs].astype(np.float64), float(out[slots])


def solve_eg_relaxed(problem: EGProblem,
                     num_steps: int = DEFAULT_NUM_STEPS,
                     pdhg_polish: bool = True, device="cuda") -> np.ndarray:
    """End-to-end relaxed solve of one problem on ``device``; returns s
    (float64, [J]). The PGD iterate is finished by a bounded PDHG polish
    (:func:`shockwave_tpu_torch.solver.eg_pdhg.polish_relaxed`), which can
    only improve it; ``pdhg_polish=False`` returns the raw PGD iterate
    (the ladder's relaxed rung does so, so a failing PDHG kernel cannot
    take out the rung that exists to recover from it)."""
    with obs.backend_phases("relaxed", problem.num_jobs):
        s, _ = solve_relaxed_problem(problem, num_steps, device)
        if pdhg_polish:
            from shockwave_tpu_torch.solver.eg_pdhg import polish_relaxed

            s = polish_relaxed(problem, s, device=device)
        return s
