"""Kernel B: the relaxed projected-gradient (Adam) solve as one persistent
CUDA launch.

The counterpart of the JAX package's jitted ``solve_relaxed``
(``shockwave_tpu/solver/eg_jax.py:121-205``) with ``_project`` (:46) and
the gradient of ``_objective`` (:75-117). That loop is XLA, not Pallas,
but eager PyTorch cannot run it: 256 Adam steps, each with a 60-step
bisection of the budget projection and a logsumexp gradient, are about
100k dependent tiny ops a solve. Here the whole solve, every global
reduction included, is one launch of ``csrc/eg_relaxed.cu``, one thread
block per problem (``blockIdx.x`` is the problem).

The wrapper :func:`relaxed` takes packed problems ([P, len(ROWS) + 1,
slots] float32, ``solver/eg_relaxed.py::_packed_args``) and returns one
float32 row per problem: the best ``s`` over the slots, its objective
and the steps run. On a CUDA tensor it launches the kernel or raises;
on a CPU tensor it runs the kernel's plain version,
``solver/eg_relaxed.py::solve_relaxed``. Each launch adds one to
``LAUNCHES["eg_relaxed"]``. As kernel A's, the kernel is a template of
(levels, resident), picked from the slot count by :func:`instantiation`;
every instantiation returns the sequential one's bits.
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.ops import _build
from shockwave_tpu_torch.ops.eg_pdhg import SEQUENTIAL, STATS, levels_for

# Launches of the kernel since the last reset; the plain version does
# not count.
LAUNCHES = {"eg_relaxed": 0}
# The same launches by instantiation, "<levels>-resident" or
# "<levels>-global".
LAUNCHES_BY_VARIANT: dict = {}
# Per-job rows of the solve's state (csrc/eg_relaxed.cu, Row::ROWS).
STATE_ROWS = 14
# Levels of the bisection tree by the largest slot count each covers
# (chosen per band on an H100, PERF.md section 6), and the
# instantiations a default build holds (``built`` in csrc/eg_relaxed.cu).
LEVELS = ((512, 2), (16384, 1), (None, 2))
BUILT = frozenset({SEQUENTIAL, (1, True), (2, True), (2, False)})


def instantiation(slots: int) -> tuple:
    """(levels, resident) of the instantiation for ``slots`` slots."""
    return levels_for(slots, STATE_ROWS, LEVELS)


def reset_launch_counts() -> None:
    LAUNCHES["eg_relaxed"] = 0
    LAUNCHES_BY_VARIANT.clear()


def relaxed(packed: torch.Tensor, num_steps: int,
            stats: torch.Tensor = None, variant: tuple = None) -> torch.Tensor:
    """Solve each packed problem; returns [P, slots + len(DIAG)] on the
    inputs' device. ``stats``, where given on a card (int64 [P, STATS]),
    receives each solve's counters (barriers, 0, projections bisected,
    0); ``variant`` (levels, resident) overrides :func:`instantiation`."""
    from shockwave_tpu_torch.solver import eg_relaxed as plain

    if packed.dim() != 3 or packed.shape[1] != len(plain.ROWS) + 1:
        raise ValueError(f"packed problems must be [P, {len(plain.ROWS) + 1}"
                         f", slots], got {tuple(packed.shape)}")
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("packed problems must be contiguous float32")
    P, _, slots = packed.shape
    if packed.device.type == "cpu":
        return torch.stack([plain.solve_relaxed(p, num_steps)
                            for p in packed])
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    out = torch.empty((P, slots + len(plain.DIAG)), device=packed.device,
                      dtype=torch.float32)
    levels, resident = variant or instantiation(slots)
    lib = _build.library("eg_relaxed", () if (levels, resident) in BUILT
                         else _build.ALL_LEVELS)
    # Per-job state of a global instantiation's solve (L2-resident).
    scratch = None if resident else torch.empty(
        P * lib.eg_relaxed_state_floats(slots), device=packed.device,
        dtype=torch.float32)
    if stats is None:
        stats = torch.empty((P, STATS), device=packed.device,
                            dtype=torch.int64)
    with torch.cuda.device(packed.device):
        code = lib.eg_relaxed(
            packed.data_ptr(), None if scratch is None else
            scratch.data_ptr(), out.data_ptr(), stats.data_ptr(), P, slots,
            int(num_steps), int(levels), int(resident),
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _build.check(code, "eg_relaxed")
    LAUNCHES["eg_relaxed"] += 1
    name = f"{levels}-{'resident' if resident else 'global'}"
    LAUNCHES_BY_VARIANT[name] = LAUNCHES_BY_VARIANT.get(name, 0) + 1
    return out
