"""Cross-cell reconciliation: prices, capacity flow, migration.

Cells are independent markets; what couples them is the fleet's total
capacity and the accident of which jobs landed where. The coordinator
recovers that coupling with the market's own currency — each cell's
*congestion price*, the marginal welfare density an extra chip-round
would buy there (the budget row's shadow price, read off the solved
allocation). Chips flow from cheap cells to congested ones; when the
price spread persists after capacity has rebalanced, jobs migrate —
and a migration is never free: an incumbent's move is charged its
PR-1 switching cost (the measured relaunch overhead the objective
already prices), so the coordinator only moves a job when the
cross-cell welfare gain beats the real cost of relaunching it.

Everything here is pure, deterministic host math over solved
allocations — the replay exactness of a cell-decomposed decision log
depends on it. The port's copy of the JAX package's
``shockwave_tpu/cells/coordinator.py`` (numpy, float64), line for line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from shockwave_tpu_torch.solver.eg_problem import EGProblem

_EPS = 1e-9
# A cell is "slack" (price 0) while its plan leaves more than this
# fraction of the budget unused — the market did not clear, so an
# extra chip there buys nothing the cell wanted.
_SLACK_FRACTION = 1e-3


def demand_rounds(problem: EGProblem) -> np.ndarray:
    """Rounds of service each job still needs: remaining epochs
    converted through epoch duration into round units (the same
    per-job cap the PDHG projection enforces)."""
    dur = max(float(problem.round_duration), _EPS)
    need_epochs = np.maximum(
        problem.total_epochs - problem.completed_epochs, 0.0
    )
    epoch_dur = np.maximum(problem.epoch_duration, _EPS)
    return need_epochs * epoch_dur / dur


def congestion_price(problem: EGProblem, s: np.ndarray) -> float:
    """Marginal welfare density of one more chip-round in this cell:
    max over jobs still short of their demand cap of
    q_j beta_j / ((A_j + beta_j s_j + eps) w_j) — the same marginal
    the PDHG welfare water-fill thresholds on. 0 when the budget did
    not clear (spare capacity => an extra chip is worthless here)."""
    s = np.asarray(s, dtype=np.float64)
    J = problem.num_jobs
    if J == 0:
        return 0.0
    R = float(problem.future_rounds)
    dur = max(float(problem.round_duration), _EPS)
    w = np.maximum(np.asarray(problem.nworkers, dtype=np.float64), _EPS)
    budget = float(problem.num_gpus) * R
    used = float(np.sum(w * s))
    if used < budget * (1.0 - _SLACK_FRACTION):
        return 0.0
    total = np.maximum(problem.total_epochs, _EPS)
    epoch_dur = np.maximum(problem.epoch_duration, _EPS)
    A = problem.completed_epochs / total
    beta = dur / (epoch_dur * total)
    q = problem.priorities / (J * R)
    xcap = demand_rounds(problem)
    unmet = (s + 1e-6) < np.minimum(xcap, R)
    fits = problem.nworkers <= problem.num_gpus
    unmet &= fits
    if not np.any(unmet):
        return 0.0
    density = q * beta / ((A + _EPS + beta * s) * w)
    return float(np.max(density[unmet]))


def spare_chips(problem: EGProblem, s: np.ndarray) -> int:
    """Whole chips the cell's solved plan leaves idle across the
    window (the donatable surplus)."""
    s = np.asarray(s, dtype=np.float64)
    R = float(problem.future_rounds)
    used = float(np.sum(np.asarray(problem.nworkers) * s))
    return max(0, int((float(problem.num_gpus) * R - used) // max(R, 1.0)))


@dataclasses.dataclass
class CapacityMove:
    src: str
    dst: str
    chips: int
    price_src: float
    price_dst: float

    def as_dict(self) -> dict:
        return {
            "src": self.src,
            "dst": self.dst,
            "chips": self.chips,
            "price_src": self.price_src,
            "price_dst": self.price_dst,
        }


def propose_capacity_move(
    names: Sequence[str],
    prices: Dict[str, float],
    spares: Dict[str, int],
    capacities: Dict[str, int],
    floors: Dict[str, int],
    price_ratio_tol: float = 0.25,
) -> Optional[CapacityMove]:
    """One step of the price-adjustment loop: chips from the cheapest
    cell with donatable surplus to the most congested cell. None when
    prices are already within ``price_ratio_tol`` of each other (or no
    cell can donate) — the loop's fixed point."""
    if len(names) < 2:
        return None
    dst = max(names, key=lambda n: (prices.get(n, 0.0), n))
    p_dst = prices.get(dst, 0.0)
    if p_dst <= 0.0:
        return None
    donors = [
        n
        for n in names
        if n != dst
        and min(spares.get(n, 0), capacities[n] - floors.get(n, 1)) >= 1
        and prices.get(n, 0.0) <= (1.0 - price_ratio_tol) * p_dst
    ]
    if not donors:
        return None
    src = min(donors, key=lambda n: (prices.get(n, 0.0), n))
    give = min(
        spares.get(src, 0),
        capacities[src] - floors.get(src, 1),
        max(1, capacities[dst] // 8),
    )
    if give < 1:
        return None
    return CapacityMove(
        src=src, dst=dst, chips=int(give),
        price_src=prices.get(src, 0.0), price_dst=p_dst,
    )


@dataclasses.dataclass
class Migration:
    job: object
    src: str
    dst: str
    gain: float
    cost: float
    incumbent: bool

    def as_dict(self) -> dict:
        return {
            "job": str(self.job),
            "src": self.src,
            "dst": self.dst,
            "gain": self.gain,
            "cost": self.cost,
            "incumbent": self.incumbent,
        }


def plan_migrations(
    names: Sequence[str],
    problems: Dict[str, EGProblem],
    solutions: Dict[str, np.ndarray],
    job_ids: Dict[str, List[object]],
    prices: Dict[str, float],
    capacities: Dict[str, int],
    max_moves: int = 8,
    price_ratio_tol: float = 0.5,
) -> List[Migration]:
    """Migrations from the most congested cell to the cheapest one,
    priced through the switching-cost term: candidate j moves only
    when its cross-cell gain — the price spread times the chip-rounds
    of demand the congested cell left unserved for j — exceeds its
    switch bonus (regularizer x measured relaunch overhead for
    incumbents; free for jobs not currently holding workers). Largest
    net gain first, bounded by ``max_moves``."""
    if len(names) < 2:
        return []
    src = max(names, key=lambda n: (prices.get(n, 0.0), n))
    p_src = prices.get(src, 0.0)
    if p_src <= 0.0:
        return []
    others = [n for n in names if n != src]
    dst = min(others, key=lambda n: (prices.get(n, 0.0), n))
    p_dst = prices.get(dst, 0.0)
    if p_src - p_dst < price_ratio_tol * p_src:
        return []
    problem = problems[src]
    s = np.asarray(solutions[src], dtype=np.float64)
    ids = job_ids[src]
    xcap = np.minimum(demand_rounds(problem), float(problem.future_rounds))
    unmet = np.maximum(xcap - s, 0.0)
    bonus = problem.switch_bonus()
    incumbent = (
        np.asarray(problem.incumbent, dtype=np.float64)
        if problem.incumbent is not None
        else np.zeros(problem.num_jobs)
    )
    candidates: List[Migration] = []
    for i, job in enumerate(ids):
        if problem.nworkers[i] > capacities[dst]:
            continue  # a gang the destination can never place
        gain = (p_src - p_dst) * float(problem.nworkers[i]) * float(unmet[i])
        cost = float(bonus[i])
        if gain <= cost or gain <= 0.0:
            continue  # moves are never free: the relaunch must pay for itself
        candidates.append(
            Migration(
                job=job, src=src, dst=dst, gain=gain, cost=cost,
                incumbent=bool(incumbent[i] > 0.0),
            )
        )
    candidates.sort(key=lambda m: (-(m.gain - m.cost), str(m.job)))
    return candidates[: max(0, int(max_moves))]
