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
"""

from __future__ import annotations

import torch

from shockwave_tpu_torch.ops import _build

# Launches of the kernel since the last reset; the plain version does
# not count.
LAUNCHES = {"eg_pdhg": 0}


def reset_launch_counts() -> None:
    LAUNCHES["eg_pdhg"] = 0


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
         barriers: torch.Tensor = None) -> torch.Tensor:
    """Solve each packed problem; returns [P, slots + len(DIAG)] on the
    inputs' device. ``barriers``, where given on a card (int64 [P]),
    receives the block barriers each problem's solve passed."""
    from shockwave_tpu_torch.solver import eg_pdhg as plain

    _check(packed)
    P, _, slots = packed.shape
    if packed.device.type == "cpu":
        return torch.stack([plain._pdhg_core(p, max_cycles, inner_iters)
                            for p in packed])
    out = torch.empty((P, slots + len(plain.DIAG)), device=packed.device,
                      dtype=torch.float32)
    lib = _build.library("eg_pdhg")
    # Per-job state of the solve, in global memory (L2-resident).
    scratch = torch.empty(P * lib.eg_pdhg_scratch_floats(slots),
                          device=packed.device, dtype=torch.float32)
    if barriers is None:
        barriers = torch.empty(P, device=packed.device, dtype=torch.int64)
    with torch.cuda.device(packed.device):
        code = lib.eg_pdhg(
            packed.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            barriers.data_ptr(), P, slots, int(max_cycles),
            int(inner_iters),
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _build.check(code, "eg_pdhg")
    LAUNCHES["eg_pdhg"] += 1
    return out
