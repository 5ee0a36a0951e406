"""Kernel A: the restarted PDHG solve as one persistent CUDA launch.

The counterpart of the JAX package's jitted ``_pdhg_core``
(``shockwave_tpu/solver/eg_pdhg.py:121-500``, one device). That loop is
XLA, not Pallas, but eager PyTorch cannot run it: a solve is up to 96
cycles of 40 steps of about 370 dependent tiny ops, with a host test at
every ``lax.cond`` and loop test. Here the whole solve, every global
reduction and every control decision included, is one launch of
``csrc/eg_pdhg.cu``: one thread block per problem (``blockIdx.x`` is the
problem), so a grid of problems (the cells market's and what-if
pricing's lanes) is one launch too.

The wrapper :func:`pdhg` takes packed problems ([P, len(ROWS) + 1,
slots] float32, ``solver/eg_pdhg.py::_packed_args``) and returns one
float32 row per problem: the best ``s`` over the slots, then the
diagnostics (``solver/eg_pdhg.py::DIAG``). On a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs the kernel's plain
version, ``solver/eg_pdhg.py::_pdhg_core``. Each launch adds one to
``LAUNCHES["eg_pdhg"]``.

The kernel is a template of (levels of its bisection tree, per-job state
resident in shared memory or not); :func:`instantiation` picks one from
the slot count. Every instantiation returns the same bits as the
sequential one, ``SEQUENTIAL``: one bisection step a barrier, state in
global memory (``csrc/eg_common.cuh``).
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.ops import _build

# Launches of the kernel since the last reset; the plain version does
# not count.
LAUNCHES = {"eg_pdhg": 0}
# The same launches by instantiation, "<levels>-resident" or
# "<levels>-global".
LAUNCHES_BY_VARIANT: dict = {}
# Per-job rows of the solve's state (csrc/eg_pdhg.cu, Row::ROWS).
STATE_ROWS = 24
# The one-level instantiation with its state in global memory: (levels,
# resident).
SEQUENTIAL = (1, False)
# Levels of the bisection tree by the largest slot count each covers
# (chosen per band on an H100, PERF.md section 6: a tree pays where few
# warps own slots), and the instantiations a default build holds
# (``built`` in csrc/eg_pdhg.cu): these and the sequential one.
LEVELS = ((512, 2), (None, 1))
BUILT = frozenset({SEQUENTIAL, (1, True), (2, True)})
# Shared memory a block may take on an H100, and the kernels' static
# part of it (eg::Shared at 1024 threads).
MAX_SHARED = 232448
STATIC_SHARED = 8448
# Int64 counters a solve writes: barriers, dual projections, budget
# projections and welfare fills bisected.
STATS = 4


def levels_for(slots: int, rows: int, levels: tuple) -> tuple:
    """(levels, resident) for problems of ``slots`` slots with ``rows``
    per-job rows of state: the levels of the first (largest slot count,
    levels) entry of ``levels`` that covers ``slots``, and resident where
    the state fits in shared memory."""
    return (next(n for top, n in levels if top is None or slots <= top),
            4 * rows * slots + STATIC_SHARED <= MAX_SHARED)


def instantiation(slots: int) -> tuple:
    """(levels, resident) of the instantiation for ``slots`` slots."""
    return levels_for(slots, STATE_ROWS, LEVELS)


def reset_launch_counts() -> None:
    LAUNCHES["eg_pdhg"] = 0
    LAUNCHES_BY_VARIANT.clear()


def _check(packed: torch.Tensor) -> None:
    from shockwave_tpu_torch.solver.eg_pdhg import ROWS

    if packed.dim() != 3 or packed.shape[1] != len(ROWS) + 1:
        raise ValueError(f"packed problems must be [P, {len(ROWS) + 1}, "
                         f"slots], got {tuple(packed.shape)}")
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("packed problems must be contiguous float32")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")


def pdhg(packed: torch.Tensor, max_cycles: int, inner_iters: int,
         stats: torch.Tensor = None, variant: tuple = None) -> torch.Tensor:
    """Solve each packed problem; returns [P, slots + len(DIAG)] on the
    inputs' device. ``stats``, where given on a card (int64 [P, STATS]),
    receives each solve's counters; ``variant`` (levels, resident)
    overrides :func:`instantiation`."""
    from shockwave_tpu_torch.solver import eg_pdhg as plain

    _check(packed)
    P, _, slots = packed.shape
    if packed.device.type == "cpu":
        return torch.stack([plain._pdhg_core(p, max_cycles, inner_iters)
                            for p in packed])
    out = torch.empty((P, slots + len(plain.DIAG)), device=packed.device,
                      dtype=torch.float32)
    levels, resident = variant or instantiation(slots)
    lib = _build.library("eg_pdhg", () if (levels, resident) in BUILT
                         else _build.ALL_LEVELS)
    # Per-job state of a global instantiation's solve (L2-resident).
    scratch = None if resident else torch.empty(
        P * lib.eg_pdhg_state_floats(slots), device=packed.device,
        dtype=torch.float32)
    if stats is None:
        stats = torch.empty((P, STATS), device=packed.device,
                            dtype=torch.int64)
    with torch.cuda.device(packed.device):
        code = lib.eg_pdhg(
            packed.data_ptr(), None if scratch is None else
            scratch.data_ptr(), out.data_ptr(), stats.data_ptr(), P, slots,
            int(max_cycles), int(inner_iters), int(levels), int(resident),
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _build.check(code, "eg_pdhg")
    LAUNCHES["eg_pdhg"] += 1
    name = f"{levels}-{'resident' if resident else 'global'}"
    LAUNCHES_BY_VARIANT[name] = LAUNCHES_BY_VARIANT.get(name, 0) + 1
    return out
