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
``LAUNCHES["eg_relaxed"]``.
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.ops import _build

# Launches of the kernel since the last reset; the plain version does
# not count.
LAUNCHES = {"eg_relaxed": 0}


def reset_launch_counts() -> None:
    LAUNCHES["eg_relaxed"] = 0


def relaxed(packed: torch.Tensor, num_steps: int,
            barriers: torch.Tensor = None) -> torch.Tensor:
    """Solve each packed problem; returns [P, slots + len(DIAG)] on the
    inputs' device. ``barriers``, where given on a card (int64 [P]),
    receives the block barriers each problem's solve passed."""
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
    lib = _build.library("eg_relaxed")
    # Per-job state of the solve, in global memory (L2-resident).
    scratch = torch.empty(P * lib.eg_relaxed_scratch_floats(slots),
                          device=packed.device, dtype=torch.float32)
    if barriers is None:
        barriers = torch.empty(P, device=packed.device, dtype=torch.int64)
    with torch.cuda.device(packed.device):
        code = lib.eg_relaxed(
            packed.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            barriers.data_ptr(), P, slots, int(num_steps),
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _build.check(code, "eg_relaxed")
    LAUNCHES["eg_relaxed"] += 1
    return out
