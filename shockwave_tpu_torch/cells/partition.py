"""Fleet partitioning: capacity split and cell assignment.

Pure, deterministic helpers — the planner's replay exactness rides on
every decision here being a function of explicit inputs only. The port's
copy of the JAX package's ``shockwave_tpu/cells/partition.py``, line for
line (plain Python, no device work).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def cell_names(num_cells: int) -> List[str]:
    """Stable cell identifiers ("c00", "c01", ...)."""
    return [f"c{i:02d}" for i in range(int(num_cells))]


def partition_capacity(num_gpus: int, num_cells: int) -> List[int]:
    """Split ``num_gpus`` chips over ``num_cells`` cells as evenly as
    possible (remainder to the first cells), every cell >= 1 chip.
    More cells than chips clamps the cell count to the chip count —
    a zero-chip cell has no market to clear."""
    num_gpus = max(1, int(num_gpus))
    num_cells = max(1, min(int(num_cells), num_gpus))
    base, rem = divmod(num_gpus, num_cells)
    return [base + (1 if i < rem else 0) for i in range(num_cells)]


def spread_capacity_delta(
    capacities: List[int], delta: int, floors: Optional[List[int]] = None
) -> List[int]:
    """Apply a fleet-level capacity change (churn re-add / worker
    death) across cells deterministically: grow largest-deficit-first
    toward the even split, shrink largest-first but never below each
    cell's floor (its widest incumbent gang — shrinking past it would
    wedge that job forever). When every cell is at its floor the
    remaining shrink is dropped (the applier never reclaims the last
    chip of a cell for the same reason the single planner clamps to
    >= 1)."""
    out = list(int(c) for c in capacities)
    floors = [max(1, int(f)) for f in (floors or [1] * len(out))]
    step = 1 if delta > 0 else -1
    for _ in range(abs(int(delta))):
        if step > 0:
            # Grow the currently-smallest cell (lowest index on ties).
            i = min(range(len(out)), key=lambda k: (out[k], k))
            out[i] += 1
        else:
            candidates = [
                k for k in range(len(out)) if out[k] - 1 >= floors[k]
            ]
            if not candidates:
                break
            i = min(candidates, key=lambda k: (-out[k], k))
            out[i] -= 1
    return out


# Admission-routing hysteresis, as a fraction of the sticky cell's
# FAIR-SHARE load (fleet-minimum load-per-chip x its capacity): a
# burst of arrivals STICKS to the previously-picked cell until its
# load exceeds its fair share by this fraction (floored at one
# gang-weight unit), instead of round-robining across the fleet on
# per-job load deltas (a pure argmin flips cells on every 1-job tie).
# Stickiness is what bounds the stale-cell set — and therefore the
# per-round replanning cost — under streaming churn, and it is a
# SCALE property: at planet scale 2% of a cell's population absorbs
# whole submission bursts, while tiny fleets (band -> 1 job) keep the
# plain balanced behavior.
LOAD_HYSTERESIS_FRAC = 0.02


def pick_cell(
    scale_factor: int,
    loads: Sequence[float],
    capacities: Sequence[int],
    sticky: Optional[int] = None,
    hysteresis_frac: float = LOAD_HYSTERESIS_FRAC,
) -> int:
    """Sticky least-loaded admission: among cells wide enough for the
    job's gang, keep the previously-picked ``sticky`` cell while its
    load stays within ``hysteresis_frac`` of its fair share at the
    fleet-minimum load-per-chip (floor: one gang-weight unit);
    otherwise the cell with the lowest load-per-chip (ties to the
    lowest index). Falls back to the widest cell when no cell fits —
    the same unschedulable-gang semantics the hetero pool picker
    uses."""
    best, best_ratio = None, None
    for i, cap in enumerate(capacities):
        if cap < scale_factor:
            continue
        ratio = float(loads[i]) / max(float(cap), 1.0)
        if best_ratio is None or (ratio, i) < (best_ratio, best):
            best, best_ratio = i, ratio
    if best is None:
        return max(range(len(capacities)), key=lambda i: (capacities[i], -i))
    if (
        sticky is not None
        and 0 <= sticky < len(capacities)
        and capacities[sticky] >= scale_factor
    ):
        cap_sticky = max(float(capacities[sticky]), 1.0)
        fair_share = best_ratio * cap_sticky
        band = max(1.0, hysteresis_frac * fair_share)
        if float(loads[sticky]) - fair_share <= band:
            return sticky
    return best


def cell_floor(job_gangs: Dict[object, float]) -> int:
    """The capacity floor of a cell: its widest gang (>= 1)."""
    widest = max([1.0] + [float(g) for g in job_gangs.values()])
    return max(1, int(widest))
