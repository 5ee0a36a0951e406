"""Boolean schedule recovery from the relaxed solve or from per-job round
counts (host side).

The JAX package's ``shockwave_tpu/solver/rounding.py``, in numpy as
there, giving the same integers:
  * ``round_counts``: fractional per-job round counts s -> integers n,
    respecting the aggregate budget sum_j g_j n_j <= R * G (the first-order
    backends' rounding);
  * ``refine_counts``: exchange polish of the counts;
  * ``order_schedule``: place each job's n_j rounds into the planning
    window under per-round capacity, earliest-first by unfairness
    priority — a greedy solution of the reordering program the reference
    solves as a second MILP (reference: shockwave.py:281-328): minimize
    sum_j priority_j * mean-round-index_j;
  * ``reorder_rounds``: the same reordering applied to any schedule;
  * ``schedule_from_relaxed``: round, polish and place a relaxed s.
"""

from __future__ import annotations

import numpy as np


def round_counts(
    s: np.ndarray, nworkers: np.ndarray, num_gpus: int, future_rounds: int
) -> np.ndarray:
    """Fractional round counts -> integers under the round-seconds budget.

    Floors are always budget-feasible (the relaxed s was); the leftover
    budget is granted as round-ups in order of largest fractional part,
    breaking ties toward higher-priority-independent larger remainders.
    """
    s = np.clip(np.asarray(s, dtype=np.float64), 0.0, future_rounds)
    g = np.asarray(nworkers, dtype=np.float64)
    budget = float(num_gpus) * future_rounds
    n = np.floor(s + 1e-9)
    used = float(np.sum(g * n))
    # Defensive: a caller may hand in an over-budget s (ours never is);
    # shed load from the widest gangs first.
    while used > budget + 1e-9:
        candidates = np.where(n > 0)[0]
        if len(candidates) == 0:
            break
        j = candidates[np.argmax(g[candidates])]
        n[j] -= 1
        used -= g[j]
    frac = s - n
    for j in np.argsort(-frac):
        if frac[j] <= 1e-9 or n[j] >= future_rounds:
            continue
        if used + g[j] <= budget + 1e-9:
            n[j] += 1
            used += g[j]
    return n.astype(np.int64)


def order_schedule(
    counts: np.ndarray,
    priorities: np.ndarray,
    nworkers: np.ndarray,
    num_gpus: int,
    future_rounds: int,
) -> np.ndarray:
    """Assign each job its ``counts[j]`` rounds under per-round capacity.
    Returns Y (J x R) in {0, 1}.

    Best effort: aggregate-budget-feasible counts are not always per-round
    packable with gang constraints (e.g. g=[2,2], G=3, R=2, counts=[2,1]),
    so row sums of the result may fall short of ``counts``. Callers that
    need every grant placed must check row sums against ``counts``:
    solve_eg_level (the production device path) falls back to the
    packable-by-construction greedy when this placement drops grants;
    the relaxed backend accepts the shortfall.
    """
    counts = np.asarray(counts, dtype=np.int64)
    J = len(counts)
    R = int(future_rounds)
    Y = np.zeros((J, R), dtype=np.int64)
    need = counts.copy()
    # Placement completeness trumps ordering: counts drive utility and
    # makespan, round indices only the (secondary) unfairness objective.
    # Job-major, widest gangs first (narrow jobs backfill around them —
    # narrow-first fragments capacity and silently drops wide jobs'
    # grants), priority-desc within a width, each job earliest-first.
    order = sorted(
        range(J), key=lambda j: (-nworkers[j], -priorities[j], j)
    )
    free = np.full(R, float(num_gpus))
    for j in order:
        if need[j] <= 0:
            continue
        # A job occupies each round at most once, so its rounds must be
        # DISTINCT: taking the most-free rounds (ties -> earliest) is the
        # exchange-argument-safe choice; earliest-first clustering can
        # strand later jobs with capacity spread one-per-round.
        rounds = sorted(range(R), key=lambda r: (-free[r], r))
        for r in rounds:
            if need[j] <= 0:
                break
            if nworkers[j] <= free[r]:
                Y[j, r] = 1
                need[j] -= 1
                free[r] -= nworkers[j]
    return Y


def reorder_columns(Y: np.ndarray, priorities: np.ndarray) -> np.ndarray:
    """Permute the window's rounds so unfair jobs run earliest.

    Weak form of the reordering program, kept as the fallback when the
    re-placement in :func:`reorder_rounds` can't fit a job: column
    permutations preserve per-round feasibility and per-job counts by
    construction, and among them sorting columns by total priority weight
    (heaviest first) is exact by the rearrangement inequality.
    """
    Y = np.asarray(Y)
    counts = Y.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        weight = np.where(counts > 0, priorities / np.maximum(counts, 1), 0.0)
    column_weight = weight @ Y
    perm = np.argsort(-column_weight, kind="stable")
    return Y[:, perm]


def reorder_rounds(
    Y: np.ndarray,
    priorities: np.ndarray,
    nworkers: np.ndarray,
    num_gpus: int,
) -> np.ndarray:
    """Re-place each job's planned rounds so unfair jobs run earliest.

    The counterpart of the reference's second MILP (reference:
    shockwave.py:281-328): minimize sum_j priority_j * mean-round-index_j
    subject to unchanged per-job round counts and per-round gang capacity.
    Round-major greedy (a naive job-major placement deadlocks at full
    budget utilization): fill rounds earliest-first, within each round
    first placing *urgent* jobs — those whose remaining count is within
    ``margin`` of the rounds left, which must therefore run in (nearly)
    every remaining round — then the highest priority-per-round jobs that
    fit. A pure rate-greedy fill (margin 0) can strand several
    almost-critical jobs on the same late round, so on failure the
    placement retries with growing margins, converging to
    fully-slack-driven (earliest-deadline-first) placement; if even that
    fails (gang-packing corner), fall back to the (always-feasible)
    column-permutation reordering of the original Y.
    """
    Y = np.asarray(Y)
    J, R = Y.shape
    counts = Y.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rate = np.where(counts > 0, priorities / np.maximum(counts, 1), 0.0)
    order = sorted(range(J), key=lambda j: (-rate[j], j))

    def attempt(margin: int):
        new_Y = np.zeros_like(Y)
        need = counts.astype(np.int64).copy()
        for r in range(R):
            free = float(num_gpus)
            rounds_left = R - r
            in_round = np.zeros(J, dtype=bool)
            # Urgent jobs, most-constrained (least slack) first.
            urgent = [
                j
                for j in order
                if 0 < need[j] and need[j] + margin >= rounds_left
            ]
            for j in sorted(urgent, key=lambda j: (-need[j], -rate[j])):
                if need[j] >= rounds_left and nworkers[j] > free:
                    return None  # a truly critical job no longer fits
                if nworkers[j] <= free:
                    in_round[j] = True
                    free -= nworkers[j]
            for j in order:
                if need[j] > 0 and not in_round[j] and nworkers[j] <= free:
                    in_round[j] = True
                    free -= nworkers[j]
                    if free <= 0:
                        break
            new_Y[in_round, r] = 1
            need[in_round] -= 1
        return new_Y if not need.any() else None

    for margin in (0, 1, 2, 4, R):
        new_Y = attempt(margin)
        if new_Y is not None:
            return new_Y
    return reorder_columns(Y, priorities)


def refine_counts(counts: np.ndarray, problem, max_moves: int = 2000) -> np.ndarray:
    """Exact-marginal exchange repair of per-job round counts.

    The relaxed solve's projected gradients are scale-normalized, so the
    makespan term's huge-but-narrow gradient (one argmax job) can be
    underserved. This local search evaluates the TRUE objective deltas:
    each move either grants one spare round or shifts a round from the
    donor with the cheapest loss to the receiver with the largest gain,
    applying the best strictly-improving move until none exists. At the
    single-move local optimum, two compound escapes cover the
    width-mismatched moves a 1-for-1 exchange cannot reach — one wide
    donor funding several narrow receivers, and several narrow donors
    funding one wide receiver — which is what closes the relaxed
    backend's rounding gap to the MILP's level (~0.1% on the mid-scale
    guard, tests/test_shockwave_solver.py).
    """
    p = problem
    counts = counts.astype(np.float64).copy()
    R = float(p.future_rounds)
    budget = float(p.num_gpus) * R
    need_sec = np.maximum(p.total_epochs - p.completed_epochs, 0.0) * p.epoch_duration
    log_vals = p.log_base_values()
    switch_bonus = p.switch_bonus()

    def welfare(n):
        planned_sec = np.minimum(n * p.round_duration, need_sec)
        progress = (p.completed_epochs + planned_sec / p.epoch_duration) / p.total_epochs
        util = np.interp(np.clip(progress, 0, 1), p.log_bases, log_vals)
        base = p.priorities * util / (p.num_jobs * p.future_rounds)
        # Keep-incumbent bonus on the first granted round, so the
        # exchange moves optimize the same extended objective the
        # device solvers and the MILP do.
        return base + np.where(n >= 0.5, switch_bonus, 0.0)

    def lateness(n):
        planned_sec = np.minimum(n * p.round_duration, need_sec)
        return np.maximum(0.0, p.remaining_runtime - planned_sec)

    def margins(n):
        """(gain_plus, loss_minus): exact objective deltas of granting /
        removing one round per job at counts ``n``. The regularizer term
        uses the leave-one-out max (top-2 trick) so a move that changes
        the argmax job's own lateness is credited correctly."""
        w = welfare(n)
        ell = lateness(n)
        m1 = ell.max() if len(ell) else 0.0
        is_max = ell >= m1
        m2 = (
            np.max(np.where(is_max, -np.inf, ell))
            if is_max.sum() < len(ell)
            else m1
        )
        if is_max.sum() > 1:
            m2 = m1
        m_excl = np.where(is_max, m2, m1)
        gain = (
            welfare(n + 1)
            - w
            + p.regularizer * (m1 - np.maximum(m_excl, lateness(n + 1)))
        )
        gain[n >= R] = -np.inf
        loss = (
            w
            - welfare(n - 1)
            + p.regularizer * (np.maximum(m_excl, lateness(n - 1)) - m1)
        )
        loss[n <= 0] = np.inf
        return gain, loss

    def donor_escape(loss_minus, used):
        """One donor (cheapest per distinct width) frees budget that a
        greedy sequence of best single grants then consumes."""
        donors = []
        for width in np.unique(p.nworkers):
            mask = (p.nworkers == width) & (counts > 0)
            if mask.any():
                donors.append(
                    int(np.argmin(np.where(mask, loss_minus, np.inf)))
                )
        for a in donors:
            if not np.isfinite(loss_minus[a]):
                continue
            sim = counts.copy()
            sim[a] -= 1
            sim_used = used - p.nworkers[a]
            delta = -loss_minus[a]
            granted = False
            for _ in range(16):
                gain, _ = margins(sim)
                gain[p.nworkers > budget - sim_used] = -np.inf
                b = int(np.argmax(gain))
                if not np.isfinite(gain[b]) or gain[b] <= 0.0:
                    break
                sim[b] += 1
                sim_used += p.nworkers[b]
                delta += gain[b]
                granted = True
            if granted and delta > 1e-9:
                return sim
        return None

    def receiver_escape(gain_plus, used):
        """Several cheapest donors jointly free the budget one wide
        receiver needs."""
        for b in np.argsort(-gain_plus)[:4]:
            if not np.isfinite(gain_plus[b]):
                continue
            sim = counts.copy()
            sim_used = used
            delta = 0.0
            for _ in range(8):
                if p.nworkers[b] <= budget - sim_used:
                    break
                _, loss = margins(sim)
                loss[b] = np.inf
                a = int(np.argmin(loss))
                if not np.isfinite(loss[a]):
                    break
                sim[a] -= 1
                sim_used -= p.nworkers[a]
                delta -= loss[a]
            if p.nworkers[b] > budget - sim_used:
                continue
            gain, _ = margins(sim)
            if np.isfinite(gain[b]) and delta + gain[b] > 1e-9:
                sim[b] += 1
                return sim
        return None

    for _ in range(max_moves):
        used = float(np.sum(counts * p.nworkers))
        gain_plus, loss_minus = margins(counts)

        best_delta, best_move = 1e-9, None
        # Pure grant into spare budget.
        feasible_add = p.nworkers <= budget - used
        if feasible_add.any():
            b = int(np.argmax(np.where(feasible_add, gain_plus, -np.inf)))
            if feasible_add[b] and gain_plus[b] > best_delta:
                best_delta, best_move = gain_plus[b], (None, b)
        # Swap: cheapest donor -> best receiver (argmax over the two
        # one-dimensional margins is exchange-optimal for a single move).
        a = int(np.argmin(loss_minus))
        if np.isfinite(loss_minus[a]):
            swap_ok = p.nworkers <= budget - used + p.nworkers[a]
            swap_gain = np.where(swap_ok, gain_plus, -np.inf) - loss_minus[a]
            swap_gain[a] = -np.inf
            b = int(np.argmax(swap_gain))
            if swap_gain[b] > best_delta:
                best_delta, best_move = swap_gain[b], (a, b)
        if best_move is None:
            # Single-move local optimum: compound escapes (see docstring).
            sim = donor_escape(loss_minus, used)
            if sim is None:
                sim = receiver_escape(gain_plus, used)
            if sim is None:
                break
            counts = sim
            continue
        donor, receiver = best_move
        if donor is not None:
            counts[donor] -= 1
        counts[receiver] += 1
    return counts.astype(np.int64)


def schedule_from_relaxed(
    s: np.ndarray,
    priorities: np.ndarray,
    nworkers: np.ndarray,
    num_gpus: int,
    future_rounds: int,
    problem=None,
) -> np.ndarray:
    counts = round_counts(s, nworkers, num_gpus, future_rounds)
    if problem is not None:
        counts = refine_counts(counts, problem)
    return order_schedule(counts, priorities, nworkers, num_gpus, future_rounds)
