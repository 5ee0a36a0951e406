"""The native (C++) host greedy of the EG planning program, bound with
ctypes.

``eg_greedy.cpp`` is this package's own copy of the JAX package's
``shockwave_tpu/native/eg_greedy.cpp``. It is compiled with the system
C++ compiler at first use,

    g++ -O2 -shared -fPIC -std=c++17 eg_greedy.cpp -o _build/eg_greedy-<hash>.so

into ``shockwave_tpu_torch/_build/`` (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads straight away. :func:`available` says whether a compiler is
there; once one is, a failed build raises: the planner never drops the
native rung quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "eg_greedy.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def available() -> bool:
    """Whether the native greedy can run here: built already, or a C++
    compiler is on PATH to build it."""
    return _lib is not None or _compiler() is not None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"eg_greedy-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``eg_greedy.cpp`` unless its library is already built;
    returns the library's path. Raises if there is no compiler or the
    compiler fails."""
    final = library_path()
    if final.exists():
        return final
    compiler = _compiler()
    if compiler is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build "
                           "the native greedy")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run([compiler, *FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(
            f"{compiler} failed for {SRC.name}:\n{run.stdout}{run.stderr}")
    # A concurrent build sees either no library or a whole one.
    os.replace(tmp, final)
    return final


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        d = ctypes.POINTER(ctypes.c_double)
        lib.eg_greedy_solve.restype = None
        lib.eg_greedy_solve.argtypes = [
            ctypes.c_int,  # num_jobs
            ctypes.c_int,  # future_rounds
            d, d, d, d, d, d, d,  # priorities..nworkers, switch_bonus
            ctypes.c_double,  # num_gpus
            d, d,  # log_bases, log_vals
            ctypes.c_int,  # num_bases
            ctypes.c_double,  # round_duration
            ctypes.c_double,  # regularizer
            ctypes.POINTER(ctypes.c_int8),  # Y out
        ]
        _lib = lib
    return _lib


def solve_eg_greedy_native(problem) -> np.ndarray:
    """Boolean schedule Y ([J, R]) of the C++ greedy: the placement-aware
    exact-marginal greedy of the JAX package's ``eg_jax.solve_greedy``."""
    lib = _library()
    J, R = problem.num_jobs, int(problem.future_rounds)

    def arr(x):
        return np.ascontiguousarray(np.asarray(x, dtype=np.float64))

    # Held in locals so the buffers outlive the call.
    fields = [arr(x) for x in (
        problem.priorities, problem.completed_epochs, problem.total_epochs,
        problem.epoch_duration, problem.remaining_runtime, problem.nworkers,
        problem.switch_bonus())]
    bases = arr(problem.log_bases)
    vals = arr(problem.log_base_values())
    Y = np.zeros((J, R), dtype=np.int8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.eg_greedy_solve(
        J, R, *(ptr(a) for a in fields), float(problem.num_gpus),
        ptr(bases), ptr(vals), len(bases), float(problem.round_duration),
        float(problem.regularizer),
        Y.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return Y.astype(np.int64)
