"""Exact-marginal, placement-aware greedy of the EG planning program.

The counterpart of the JAX package's ``shockwave_tpu/solver/eg_jax.py``
greedy: ``solve_greedy`` (:218), ``num_grants_for`` (:708),
``grant_batch_for`` (:759) and ``solve_eg_greedy`` (:772). The reference
jits it as one XLA ``while_loop``; no Pallas kernel sits under it, so
here it is a Python loop over float32 tensor ops on an explicit device.
It is ``counts_to_schedule``'s fallback where no C++ compiler builds the
native greedy (``native/eg_greedy.cpp``, its semantic twin), so it
stays plain PyTorch: a fallback that runs only without a compiler is not
worth a kernel.

Each step grants one (job, round) cell, or with ``grant_batch`` B > 1
one cell to each of the top B jobs by stale gain density, to the job
with the largest gain in objective per worker, in the most-free round it
does not already occupy, so the schedule is feasible by construction.

The schedules are the reference's, bit for bit, by the rules the level
solve keeps (``eg_level``'s module docstring): float32 one op at a time,
``jnp.interp`` op for op (:func:`eg_level.interp`), XLA's fused
multiply-add where it contracts a product feeding a sum (the lateness
and the gain), ``argmax`` taking the first maximum, and the top B by a
stable sort (``lax.top_k`` puts the lower index first among ties). A
step after the last grant changes nothing, so the loop reads its
``done`` flag from the device only every :data:`DONE_CHECK` steps.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from shockwave_tpu_torch.solver.eg_level import (_EPS, fma, interp,
                                                 num_slots_for, pad_problem)
from shockwave_tpu_torch.solver.eg_problem import EGProblem

_F32 = torch.float32
# Steps between two reads of the loop's ``done`` flag (one device sync).
DONE_CHECK = 32
# Greedy solves by the device type their tensors lay on (chip_smoke.py
# reads it to show that a run took the fallback, and where).
SOLVES: Counter = Counter()


def solve_greedy(
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
    num_grants: int,
    grant_batch: int = 1,
    switch_bonus: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The greedy (eg_jax.py:218-381; its docstring gives the method).
    Returns the float32 schedule [J, R] on the inputs' device."""
    device = active.device
    R = int(future_rounds)
    J = priorities.shape[0]

    def scalar(x):
        return torch.tensor(x, dtype=_F32, device=device)

    dur = scalar(round_duration)
    reg = scalar(regularizer)
    epoch_dur = torch.clamp_min(epoch_dur, _EPS)
    fits = (nworkers <= num_gpus) & (active > 0)
    num_active = torch.clamp_min(active.sum(), 1.0)
    norm = num_active * R
    need_epochs = torch.clamp_min(total - completed, 0.0)
    tiny = scalar(1e-12)
    neg_inf = scalar(-float("inf"))
    rank = torch.arange(R, dtype=_F32, device=device)

    # Utility and lateness at every round count k = 0..R+1, [J, R+2]:
    # the reference evaluates them at n and n + 1 each step, element by
    # element with these operations, so a table gives the same bits.
    k = torch.arange(R + 2, dtype=_F32, device=device)[None, :]
    planned = torch.minimum(k * dur / epoch_dur[:, None], need_epochs[:, None])
    progress = (completed[:, None] + planned) / total[:, None]
    U = (priorities[:, None] * interp(progress, log_bases, log_vals)
         / norm)
    if switch_bonus is not None:
        U = U + torch.where(k >= 0.5, switch_bonus[:, None], 0.0)
    # XLA contracts remaining - epoch_dur * planned into one FMA.
    L = active[:, None] * torch.clamp_min(
        fma(-epoch_dur[:, None], planned, remaining[:, None]), 0.0)

    B = int(grant_batch)
    Y = torch.zeros((J, R), dtype=_F32, device=device)
    free = num_gpus.to(_F32).expand(R).clone()
    done = torch.zeros((), dtype=torch.bool, device=device)
    if B > 1:
        widths = nworkers.cpu().numpy()
        score_rank = np.arange(R, dtype=np.float32)
    n_steps = -(-int(num_grants) // B)
    for i in range(n_steps):
        if i and i % DONE_CHECK == 0 and bool(done):
            break
        n = Y.sum(dim=1).long()[:, None]
        ell = L.gather(1, n)[:, 0]
        # max and second max of lateness, for "max excluding j".
        m1 = ell.max()
        is_max = ell >= m1
        m2 = torch.where(is_max, neg_inf, ell).max()
        m2 = torch.where(is_max.sum() > 1, m1, m2)
        m_excl = torch.where(is_max, m2, m1)

        welfare_gain = (U.gather(1, n + 1) - U.gather(1, n))[:, 0]
        new_makespan = torch.maximum(m_excl, L.gather(1, n + 1)[:, 0])
        gain = fma(reg, m1 - new_makespan, welfare_gain)

        open_cell = (Y == 0) & (free[None, :] >= nworkers[:, None])
        feasible = fits & open_cell.any(dim=1) & ~done
        gain = torch.where(feasible, gain, neg_inf)
        density = torch.where(feasible, gain / nworkers, neg_inf)

        if B == 1:
            j = torch.argmax(density).reshape(1)
            grant = gain.index_select(0, j) > tiny
            open_j = open_cell.index_select(0, j)[0]
            score = torch.where(open_j, free * (R + 1.0) - rank, neg_inf)
            r = torch.argmax(score).reshape(1)
            add = torch.where(grant, 1.0, 0.0)
            Y.index_put_((j, r), add, accumulate=True)
            free.index_put_((r,), -add * nworkers.index_select(0, j),
                            accumulate=True)
            done = done | ~grant[0]
            continue
        # The top B jobs by density take a cell each, in turn, each
        # against the capacity the ones before it left. A job is in the
        # top B once, so its row is as the step found it; the turns run
        # on the host, on integers exact in float32, from one fetch.
        top_density, top_jobs = torch.sort(density, descending=True,
                                           stable=True)
        top = top_jobs[:B]
        host = torch.cat([
            (top_density[:B] > tiny).to(_F32)[:, None],
            Y.index_select(0, top), free.expand(B, R)], dim=1).cpu().numpy()
        jobs = top.cpu().numpy()
        free_h = host[0, R + 1:].copy()
        rounds = np.zeros(B, dtype=np.int64)
        adds = np.zeros(B, dtype=np.float32)
        for b in range(B):
            w = widths[jobs[b]]
            open_b = (host[b, 1:R + 1] == 0) & (free_h >= w)
            if not (host[b, 0] and open_b.any()):
                continue
            r = int(np.argmax(np.where(open_b,
                                       free_h * np.float32(R + 1.0)
                                       - score_rank, -np.inf)))
            rounds[b], adds[b] = r, 1.0
            free_h[r] -= w
        Y.index_put_((top, torch.from_numpy(rounds).to(device)),
                     torch.from_numpy(adds).to(device), accumulate=True)
        free.copy_(torch.from_numpy(free_h))
        done = done | torch.tensor(not adds.any(), device=device)
    return Y


def num_grants_for(problem: EGProblem, num_slots: int) -> int:
    """Loop bound: no schedule can receive more grants than the budget
    admits for the narrowest gang, nor than slots * window."""
    by_budget = int(problem.num_gpus) * int(problem.future_rounds)
    by_slots = num_slots * int(problem.future_rounds)
    return max(1, min(by_budget, by_slots))


def grant_batch_for(num_grants: int) -> int:
    """The reference's adaptive batch (eg_jax.py:759): single grants up
    to 4096 of them, batches of 16 above. Its thresholds come from the
    reference's own sweep and are kept as its defaults."""
    return 16 if num_grants > 4096 else 1


def solve_eg_greedy(problem: EGProblem, device,
                    grant_batch: Optional[int] = None) -> np.ndarray:
    """End-to-end greedy solve on ``device``; returns a feasible boolean
    schedule Y ([J, R], int64)."""
    device = torch.device(device)
    slots = num_slots_for(problem.num_jobs)
    packed = pad_problem(problem, slots, device)
    grants = num_grants_for(problem, slots)
    if grant_batch is None:
        grant_batch = grant_batch_for(grants)
    Y = solve_greedy(
        packed["active"], packed["priorities"], packed["completed"],
        packed["total"], packed["epoch_dur"], packed["remaining"],
        packed["nworkers"], packed["num_gpus"], packed["log_bases"],
        packed["log_vals"],
        round_duration=float(problem.round_duration),
        future_rounds=int(problem.future_rounds),
        regularizer=float(problem.regularizer),
        num_grants=grants,
        grant_batch=int(grant_batch),
        switch_bonus=packed.get("switch_bonus"),
    )
    SOLVES[Y.device.type] += 1
    return Y.cpu().numpy()[: problem.num_jobs].astype(np.int64)
