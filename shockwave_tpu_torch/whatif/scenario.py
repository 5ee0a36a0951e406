"""Scenario-batched counterfactual EG solves: the what-if fleet.

The port of the JAX package's ``shockwave_tpu/whatif/scenario.py``.
Capacity planning is a set of solves of the same restarted-PDHG market
(``solver/eg_pdhg.py::_pdhg_core``) on perturbed inputs. The JAX package
``vmap``s them over a leading scenario axis (``_solve_scenarios_kernel``
:99, with the unbatched reference ``_solve_scenario_kernel`` :142); here
a batch of S scenarios is one launch of kernel A
(``ops/csrc/eg_pdhg.cu``) with a grid of S blocks, a block a scenario.

Each scenario is an overlay of the one base problem: a 0/1 job mask
(demand mixes), a per-job priority scale (weight knobs), a switch-cost
scale, and its own capacity, ``round_duration``, ``future_rounds`` and
``regularizer``. The lanes are built on the host as float32 products of
the base rows (``active * mask``, ``priorities * pscale``,
``switch_bonus * sscale``: ``solver/eg_pdhg.py::overlay_lanes``), the
JAX package's overlay arithmetic, so:

  * an identity-overlay lane is the one-problem solve
    (``solve_pdhg_relaxed``) of the base problem in every bit, and
  * every lane is :func:`solve_scenario`, the one-lane launch of that
    scenario, in every bit (:func:`audit_lanes` checks it).

The JAX package pads the lanes to a power of two with inert lanes and
splits large bands into CPU-cache-sized chunks; a CUDA launch compiles
nothing and each block stops alone, so the port launches exactly the S
live lanes and splits them only where a global instantiation's state
would not fit the card (``ops/eg_pdhg.py::lane_chunk``; each diagnostics
dict names the chunk). With a mesh (``mesh=``, a
:func:`~shockwave_tpu_torch.parallel.mesh.make_solve_mesh` over a
``"scenarios"`` axis) whose places divide the band, the JAX package's
``shard_map`` of the scenario axis (``_build_scenarios_sharded`` :177):
the lanes go to the places in contiguous blocks, one grid launch a
place on its device, with no collective between them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.cells.batched import lane_band
from shockwave_tpu_torch.solver.eg_level import _EPS, num_slots_for
from shockwave_tpu_torch.solver.eg_pdhg import (
    DEFAULT_INNER_ITERS,
    DEFAULT_MAX_CYCLES,
    DEFAULT_TOL,
    ROWS,
    _STALL_REL,
    _diag_to_host,
    _packed_args,
    overlay_lanes,
    solve_lanes,
    solve_lanes_on_mesh,
)
from shockwave_tpu_torch.solver.eg_problem import EGProblem


@dataclasses.dataclass
class Scenario:
    """One counterfactual: the knobs that differ from the live fleet.

    Every field defaults to the exact identity, so ``Scenario()`` is the
    baseline lane. ``job_mask`` is 0/1 over the base problem's job order:
    0 removes the job from this scenario's market entirely."""

    name: str = "baseline"
    # Fleet size: absolute chips, or a scale on the base capacity
    # (absolute wins when both are set).
    num_gpus: Optional[float] = None
    capacity_scale: Optional[float] = None
    # Demand mix: 0/1 over base job order (None = all jobs).
    job_mask: Optional[np.ndarray] = None
    # Weight knob: scalar, or per-job over base job order.
    priority_scale: Union[float, np.ndarray] = 1.0
    # Preemption-pricing knob: scales the measured relaunch overheads.
    switch_cost_scale: float = 1.0
    # Policy knobs (None = the base problem's value).
    round_duration: Optional[float] = None
    future_rounds: Optional[float] = None
    regularizer: Optional[float] = None
    # Free-form labels carried into reports (grid coordinates etc.).
    tags: Dict = dataclasses.field(default_factory=dict)


class ScenarioBatch:
    """S scenarios over one shared base problem: the packed base row
    ([len(ROWS) + 1, slots] float32) and each scenario's overlay."""

    def __init__(self, problem: EGProblem, scenarios: Sequence[Scenario],
                 s0: Optional[np.ndarray] = None,
                 slots: Optional[int] = None):
        if not scenarios:
            raise ValueError("a ScenarioBatch needs at least one scenario")
        self.problem = problem
        self.scenarios = list(scenarios)
        self.slots = int(slots) if slots else num_slots_for(problem.num_jobs)
        # The launch takes exactly the scenarios; the JAX package's
        # power-of-two band is kept for the reports.
        self.lanes = len(self.scenarios)
        self.band = lane_band(self.lanes)
        self.base = _packed_args(problem, self.slots, s0, DEFAULT_TOL,
                                 _STALL_REL)
        self.overlays = self._pack_overlays(problem)

    def _pack_overlays(self, problem: EGProblem):
        J, slots, L = problem.num_jobs, self.slots, self.lanes
        mask = np.ones((L, slots), np.float32)
        pscale = np.ones((L, slots), np.float32)
        gpus = np.ones(L, np.float32)
        sscale = np.ones(L, np.float32)
        dur = np.full(L, np.float32(problem.round_duration), np.float32)
        rounds = np.full(L, np.float32(problem.future_rounds), np.float32)
        reg = np.full(L, np.float32(problem.regularizer), np.float32)
        base_reg = float(problem.regularizer)
        for i, sc in enumerate(self.scenarios):
            if sc.job_mask is not None:
                jm = np.asarray(sc.job_mask, np.float32)
                if jm.shape != (J,):
                    raise ValueError(f"scenario {sc.name!r}: job_mask shape "
                                     f"{jm.shape} != ({J},)")
                mask[i, :J] = jm
            if sc.num_gpus is not None:
                gpus[i] = np.float32(sc.num_gpus)
            elif sc.capacity_scale is not None:
                gpus[i] = np.float32(float(problem.num_gpus)
                                     * float(sc.capacity_scale))
            else:
                gpus[i] = np.float32(problem.num_gpus)
            ps = sc.priority_scale
            if np.ndim(ps) == 0:
                pscale[i, :] = np.float32(ps)
            else:
                ps = np.asarray(ps, np.float32)
                if ps.shape != (J,):
                    raise ValueError(f"scenario {sc.name!r}: priority_scale "
                                     f"shape {ps.shape} != ({J},)")
                pscale[i, :J] = ps
            # The packed switch_bonus is base_regularizer * cost *
            # incumbent; a regularizer knob re-prices it too, so the ratio
            # folds into the lane's switch scale (exactly 1.0 when neither
            # knob is set).
            scale = float(sc.switch_cost_scale)
            if sc.regularizer is not None and base_reg > 0.0:
                scale *= float(sc.regularizer) / base_reg
            sscale[i] = np.float32(scale)
            if sc.round_duration is not None:
                dur[i] = np.float32(sc.round_duration)
            if sc.future_rounds is not None:
                rounds[i] = np.float32(sc.future_rounds)
            if sc.regularizer is not None:
                reg[i] = np.float32(sc.regularizer)
        return mask, pscale, gpus, sscale, dur, rounds, reg

    def packed(self, tol: float = DEFAULT_TOL, stall_rel: float = _STALL_REL,
               indices: Optional[Sequence[int]] = None) -> np.ndarray:
        """The lanes of ``indices`` (default: every scenario) as packed
        problems ([L, len(ROWS) + 1, slots] float32), what the launch
        reads."""
        base = self.base.copy()
        base[len(ROWS), 4:6] = (tol, stall_rel)
        sel = slice(None) if indices is None else np.asarray(indices, int)
        mask, pscale, gpus, sscale, dur, rounds, reg = (
            a[sel] for a in self.overlays)
        return overlay_lanes(base, mask, pscale, gpus, sscale, dur, rounds,
                             reg)


def _results(batch: ScenarioBatch, out: np.ndarray, chunk: int):
    J, slots = batch.problem.num_jobs, batch.slots
    return ([row[:J].astype(np.float64) for row in out],
            [float(row[slots]) for row in out],
            [{**_diag_to_host(row[slots:]), "lanes": len(out),
              "chunk": chunk} for row in out])


def solve_scenarios(
    batch: ScenarioBatch,
    tol: float = DEFAULT_TOL,
    stall_rel: float = _STALL_REL,
    max_cycles: int = DEFAULT_MAX_CYCLES,
    inner_iters: int = DEFAULT_INNER_ITERS,
    mesh=None,
    device="cuda",
    axis_name: str = "scenarios",
) -> Tuple[List[np.ndarray], List[float], List[dict]]:
    """Solve every scenario's counterfactual market in one launch on
    ``device``, or in one launch a place of ``mesh`` along ``axis_name``
    where its places divide the lane band (else on ``device``, as the
    JAX package falls back to its unsharded program); returns
    per-scenario ``(s [num_jobs] float64, objective, diagnostics)``
    lists."""
    t0 = time.monotonic()
    packed = batch.packed(tol, stall_rel)
    if mesh is not None and batch.band % mesh.devices.size == 0:
        out, chunk = solve_lanes_on_mesh(packed, mesh, axis_name, batch.band,
                                         max_cycles, inner_iters)
    else:
        out, chunk = solve_lanes(packed, max_cycles, inner_iters, device)
    obs.counter("whatif_scenarios_solved_total",
                "counterfactual scenario solves completed by the what-if "
                "fleet").inc(batch.lanes)
    obs.histogram("whatif_batch_solve_seconds",
                  "wall-clock of one batched scenario-fleet solve"
                  ).observe(time.monotonic() - t0)
    return _results(batch, out, chunk)


def solve_scenario(
    batch: ScenarioBatch,
    index: int,
    tol: float = DEFAULT_TOL,
    stall_rel: float = _STALL_REL,
    max_cycles: int = DEFAULT_MAX_CYCLES,
    inner_iters: int = DEFAULT_INNER_ITERS,
    device="cuda",
) -> Tuple[np.ndarray, float, dict]:
    """Standalone solve of one scenario, a one-lane launch of the same
    overlay arithmetic: the reference each batched lane is audited
    against."""
    out, chunk = solve_lanes(batch.packed(tol, stall_rel, [index]),
                             max_cycles, inner_iters, device)
    s, obj, diag = _results(batch, out, chunk)
    return s[0], obj[0], diag[0]


def audit_lanes(
    batch: ScenarioBatch,
    s_list: Sequence[np.ndarray],
    indices: Optional[Sequence[int]] = None,
    **solve_kwargs,
) -> dict:
    """Re-solve scenarios standalone and compare each with its batched
    lane in every bit. Returns ``{"audited", "mismatched",
    "bit_identical"}``; a non-empty ``mismatched`` means the batch changed
    a market's answer, which the contract forbids."""
    indices = list(range(batch.lanes) if indices is None else indices)
    mismatched = []
    for i in indices:
        s_ref, _, _ = solve_scenario(batch, i, **solve_kwargs)
        if not np.array_equal(np.asarray(s_list[i], np.float32),
                              np.asarray(s_ref, np.float32)):
            mismatched.append(int(i))
    return {"audited": len(indices), "mismatched": mismatched,
            "bit_identical": not mismatched}


# ----------------------------------------------------------------------
# Report-side metrics (host, float64: planning semantics, not the
# kernel's float32 arithmetic).
# ----------------------------------------------------------------------
def scenario_metrics(problem: EGProblem, scenario: Scenario,
                     s: np.ndarray) -> dict:
    """Planning metrics of one scenario's relaxed solution ``s``:
    priority-weighted Nash welfare, regularized makespan, worst remaining
    lateness, and a finish-time-fairness proxy (window plus
    contention-inflated lateness over predicted remaining runtime)."""
    s = np.asarray(s, np.float64)
    mask = (np.asarray(scenario.job_mask, np.float64)
            if scenario.job_mask is not None else np.ones(problem.num_jobs))
    dur = float(scenario.round_duration if scenario.round_duration
                is not None else problem.round_duration)
    R = float(scenario.future_rounds if scenario.future_rounds
              is not None else problem.future_rounds)
    gpus = (float(scenario.num_gpus) if scenario.num_gpus is not None
            else float(problem.num_gpus) * float(
                scenario.capacity_scale
                if scenario.capacity_scale is not None else 1.0))
    pscale = np.broadcast_to(np.asarray(scenario.priority_scale, np.float64),
                             (problem.num_jobs,))
    active = mask * (np.asarray(problem.nworkers, np.float64) <= gpus)
    n_active = max(float(active.sum()), 1.0)
    total = np.maximum(np.asarray(problem.total_epochs, np.float64), _EPS)
    epoch_dur = np.maximum(np.asarray(problem.epoch_duration, np.float64),
                           _EPS)
    completed = np.asarray(problem.completed_epochs, np.float64)
    remaining = np.asarray(problem.remaining_runtime, np.float64)
    q = active * np.asarray(problem.priorities, np.float64) * pscale / (
        n_active * R)
    need_sec = np.maximum(np.asarray(problem.total_epochs, np.float64)
                          - completed, 0.0) * epoch_dur
    xcap = need_sec / max(dur, _EPS)
    progress = completed / total + (dur / (epoch_dur * total)) * np.minimum(
        s, xcap)
    welfare = float(np.sum(q * np.log(progress + _EPS)))
    lateness = np.where(active > 0, remaining - dur * s, 0.0)
    floor = float(np.max(np.where(active > 0, remaining - need_sec, 0.0)))
    makespan = max(max(floor, 0.0), float(np.max(lateness, initial=0.0)))
    contention = n_active / max(gpus, 1.0)
    ftf_proxy = np.where(
        active > 0,
        (dur * R + np.maximum(lateness, 0.0) * contention)
        / np.maximum(remaining, 1.0), 0.0)
    return {
        "name": scenario.name,
        "tags": dict(scenario.tags),
        "active_jobs": int(round(active.sum())),
        "scheduled_jobs": int(np.sum((s >= 0.5) & (active > 0))),
        "granted_rounds": float(np.sum(s * active)),
        "nash_welfare": welfare,
        "makespan_s": makespan,
        "worst_lateness_s": float(np.max(np.maximum(lateness, 0.0),
                                         initial=0.0)),
        "worst_ftf_proxy": float(np.max(ftf_proxy, initial=0.0)),
        "capacity": gpus,
    }


def scenario_report(problem: EGProblem, scenarios: Sequence[Scenario],
                    s_list: Sequence[np.ndarray],
                    objectives: Sequence[float], diags: Sequence[dict],
                    baseline_index: int = 0) -> List[dict]:
    """Per-scenario capacity-planning rows with deltas against the
    baseline scenario (by default the first, the identity lane)."""
    rows = []
    base = scenario_metrics(problem, scenarios[baseline_index],
                            s_list[baseline_index])
    for sc, s, o, d in zip(scenarios, s_list, objectives, diags):
        m = scenario_metrics(problem, sc, s)
        m["objective"] = float(o)
        m["converged"] = bool(d["converged"])
        m["cycles"] = int(d["cycles"])
        m["nash_welfare_delta"] = m["nash_welfare"] - base["nash_welfare"]
        m["makespan_delta_s"] = m["makespan_s"] - base["makespan_s"]
        m["worst_ftf_proxy_delta"] = (m["worst_ftf_proxy"]
                                      - base["worst_ftf_proxy"])
        rows.append(m)
    return rows
