"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v [EXTRA_FLAGS[name]] \
        -o _build/<name>-<hash>.so csrc/<name>.cu

The planning kernels (``eg_pdhg``, ``eg_relaxed``) add ``-fmad=false``:
nvcc contracts a product feeding a sum into one fused multiply-add by
default, and without that each product rounds before its sum, as in
their plain PyTorch versions' eager ops. :func:`build_all` starts one
nvcc for each source at once.

The library lands in ``shockwave_tpu_torch/_build/`` (git-ignored), named
by a hash of every source under ``csrc/`` and the flags, so an edited
source rebuilds and an unchanged one loads straight away. No PyTorch
headers are compiled: a plain C library builds in seconds, where an
extension including torch's headers takes minutes. What nvcc printed
(``-Xptxas -v``: each kernel's registers and spills, and any wgmma that
ptxas serialised) is kept beside the library as ``<name>-<hash>.log``.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
nonzero code, since a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.

A kernel that does not build, load or launch raises :class:`KernelError`.
Callers that step past a failed attempt (the planner's degradation
ladder) re-raise it: a broken kernel must never send the work to the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of every entry point, by source name.
SIGNATURES = {
    "flash_attention": {
        "flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _P],
        "flash_dkv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P],
        "flash_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _F, _I, _P],
    },
    "eg_pdhg": {
        "eg_pdhg": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "eg_pdhg_scratch_floats": [_I],
    },
    "eg_relaxed": {
        "eg_relaxed": [_P, _P, _P, _P, _I, _I, _I, _P],
        "eg_relaxed_scratch_floats": [_I],
    },
}
# Flags of one source on top of NVCC_FLAGS.
EXTRA_FLAGS = {
    "eg_pdhg": ("-fmad=false",),
    "eg_relaxed": ("-fmad=false",),
}

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel of ``csrc/`` failed to build, load or launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(EXTRA_FLAGS.items())).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library of these sources is
    already built; returns its path."""
    final = library_path(name)
    if final.exists():
        return final
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if run.returncode != 0:
        raise KernelError(
            f"nvcc failed for csrc/{name}.cu:\n{run.stdout}{run.stderr}"
        )
    # Rename into place, the log first: a concurrent build sees either no
    # library or a whole one with its log.
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(run.stdout + run.stderr)
    os.replace(tmp_log, final.with_suffix(".log"))
    os.replace(tmp, final)
    return final


def build_all(names) -> dict:
    """Build the libraries of ``names`` at once, one nvcc each; returns
    {name: path}. Raises the first build's error after all have ended."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load {path.name}: {e}") from e
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError(
            f"{what}: CUDA error {code} at launch (cudaGetLastError)"
        )
