"""Batched per-cell PDHG: every stale cell's market in one launch.

The counterpart of the JAX package's ``shockwave_tpu/cells/batched.py``.
Every cell's market is the same restarted-PDHG saddle-point solve
(``solver/eg_pdhg.py::_pdhg_core``); the JAX package ``vmap``s it over a
leading cell axis (``_solve_cells_kernel`` :58), so C cells are one
device program. Here C cells are one launch of kernel A
(``ops/csrc/eg_pdhg.cu``) with a grid of C blocks, one a cell: each block
stops on its own residual and stall test, so the launch lasts as long as
its slowest cell, and each cell's bits are those of its own one-problem
launch (``ops/eg_pdhg.py::pdhg``). On the CPU the lanes run the kernel's
plain version one after another.

The JAX package pads the lane count to a power of two with inert lanes
so that a varying stale set reuses a few compiled programs; a CUDA
launch compiles nothing, so the port launches exactly the live lanes
(:func:`lane_band` stays for the reports that print it). With a mesh
(``mesh=``, a :func:`~shockwave_tpu_torch.parallel.mesh.make_solve_mesh`
over a ``"cells"`` axis) whose places divide the band, the JAX package's
``shard_map`` of the cell axis (``_build_cells_sharded`` :93): the lanes
go to the places in contiguous blocks, one grid launch a place on its
device, with no collective between them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from shockwave_tpu_torch.solver.eg_level import num_slots_for
from shockwave_tpu_torch.solver.eg_pdhg import (
    DEFAULT_INNER_ITERS,
    DEFAULT_MAX_CYCLES,
    DEFAULT_TOL,
    _STALL_REL,
    _default_s0,
    _diag_to_host,
    pack_problems,
    solve_lanes,
    solve_lanes_on_mesh,
)
from shockwave_tpu_torch.solver.eg_problem import EGProblem

def lane_band(num_lanes: int) -> int:
    """Next power-of-two lane count >= num_lanes: the JAX package's
    recompile band, reported beside the port's exact lane count."""
    n = 1
    while n < int(num_lanes):
        n *= 2
    return n


def solve_cells_pdhg(
    problems: Sequence[EGProblem],
    s0s: Optional[Sequence[Optional[np.ndarray]]] = None,
    tol: float = DEFAULT_TOL,
    stall_rel: float = _STALL_REL,
    max_cycles: int = DEFAULT_MAX_CYCLES,
    inner_iters: int = DEFAULT_INNER_ITERS,
    slots: Optional[int] = None,
    mesh=None,
    device="cuda",
    axis_name: str = "cells",
) -> Tuple[List[np.ndarray], List[float], List[dict]]:
    """Solve every cell's relaxed EG market in one launch on ``device``,
    or in one launch a place of ``mesh`` along ``axis_name`` where its
    places divide the cells' lane band (else on ``device``, as the JAX
    package falls back to its unsharded program).

    All problems must share ``round_duration`` / ``future_rounds`` /
    ``regularizer`` (one fleet, one planning config). Returns per-cell
    ``(s [num_jobs] float64, objective, diagnostics)`` lists; each
    diagnostics dict also names the lanes of the launch (``lanes``) and
    the lanes a launch took (``chunk``). A lane's result is the
    one-problem solve's (``solver/eg_pdhg.py::solve_pdhg_relaxed``) on
    the same inputs in every bit, so a cell's market does not change
    meaning by being solved next to its neighbours."""
    if not problems:
        return [], [], []
    ref = problems[0]
    for p in problems[1:]:
        if not (p.round_duration == ref.round_duration
                and p.future_rounds == ref.future_rounds
                and p.regularizer == ref.regularizer):
            raise ValueError("cells must share the fleet planning config")
    if s0s is None:
        s0s = [None] * len(problems)
    s0s = [s0 if s0 is not None else _default_s0(p)
           for p, s0 in zip(problems, s0s)]
    if slots is None:
        slots = num_slots_for(max(p.num_jobs for p in problems))
    packed = pack_problems(problems, s0s, slots, tol, stall_rel)
    band = lane_band(len(problems))
    if mesh is not None and band % mesh.devices.size == 0:
        out, chunk = solve_lanes_on_mesh(packed, mesh, axis_name, band,
                                         max_cycles, inner_iters)
    else:
        out, chunk = solve_lanes(packed, max_cycles, inner_iters, device)
    diags = [{**_diag_to_host(row[slots:]), "lanes": len(problems),
              "chunk": chunk} for row in out]
    return ([out[i, :p.num_jobs].astype(np.float64)
             for i, p in enumerate(problems)],
            [float(row[slots]) for row in out], diags)


def schedule_cell(problem: EGProblem, s: np.ndarray, device,
                  polish: bool = True) -> np.ndarray:
    """Host tail of one cell's solve: the integer rounding, placement and
    reorder every counts-producing backend shares, so a cell's boolean
    plan is what the standalone pdhg backend would emit for the same
    relaxed iterate (``device`` runs the PyTorch greedy where placement
    drops grants and no compiler builds the native one)."""
    from shockwave_tpu_torch.solver.eg_level import counts_to_schedule
    from shockwave_tpu_torch.solver.rounding import (reorder_rounds,
                                                     round_counts)

    counts = round_counts(s, problem.nworkers, problem.num_gpus,
                          problem.future_rounds)
    Y = counts_to_schedule(counts, problem, device, polish=polish)
    return reorder_rounds(Y, problem.priorities, problem.nworkers,
                          problem.num_gpus)
