"""The CUDA sources of kernels A (``ops/csrc/eg_pdhg.cu``) and B
(``ops/csrc/eg_relaxed.cu``) built with the host's C++ compiler and run on
the CPU, one block of 64 threads as std::threads
(``tests/cuda_host/cuda_runtime.h`` stands in for the CUDA builtins),
against the kernels' plain PyTorch versions on the same packed problems.

This checks the kernels' own control flow, indexing and reductions where
no card is: the block size (64 here, 1024 on the card) changes only the
order of the sums, so the limits are those of two summation orders
(``bench_sim.eg_misses``). Whether the sources compile for sm_90a and
how they run there, ``chip_smoke.py`` checks on the card.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import bench
from shockwave_tpu_torch.tools import bench_sim
from test_torch_solver import port_problem

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "shockwave_tpu_torch" / "ops" / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"
THREADS = 64


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """Both kernels built for the host: the launch syntax (<<<...>>>) is
    dropped from a copy of each source, so its C entry point calls the
    kernel function on the host thread that runs it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed (g++ or c++ on PATH)"
    out = tmp_path_factory.mktemp("eg_host")
    built = {}
    for kind, source in (("pdhg", "eg_pdhg.cu"), ("relaxed", "eg_relaxed.cu")):
        text = re.sub(r"<<<.*?>>>", "", (CSRC / source).read_text(),
                      flags=re.S)
        copy = out / f"{kind}.cpp"
        copy.write_text(text)
        binary = out / kind
        flags = ["-DKERNEL_PDHG"] if kind == "pdhg" else []
        subprocess.run(
            [cxx, "-O2", "-std=c++20", "-pthread", f"-DEG_THREADS={THREADS}",
             f'-DKERNEL_SOURCE="{copy}"', *flags, "-Wno-unknown-pragmas",
             "-I", str(HOST), "-I", str(CSRC), str(HOST / "run_kernel.cpp"),
             "-o", str(binary)],
            check=True, capture_output=True, text=True, timeout=300)
        built[kind] = binary
    return built


def run_host(binary, packed: np.ndarray, tmp_path, *args):
    inp, out = tmp_path / "packed.bin", tmp_path / "out.bin"
    packed.astype(np.float32).tofile(inp)
    rows, slots = packed.shape
    subprocess.run([str(binary), str(inp), str(out), str(rows), str(slots),
                    *map(str, args)], check=True, timeout=600)
    raw = out.read_bytes()
    return (np.frombuffer(raw[:-8], np.float32),
            int(np.frombuffer(raw[-8:], np.int64)[0]))


def problems():
    return [
        bench_sim.seeded_problem(40, seed=0, num_gpus=16),
        bench_sim.parity_problem(64 * 1000 + 500, 64, True),
        port_problem(bench.make_problem(num_jobs=100, future_rounds=20,
                                        num_gpus=64, seed=0)),
    ]


@pytest.mark.parametrize("case", range(3))
def test_kernel_a_on_the_host_matches_its_plain_version(binaries, tmp_path,
                                                        case):
    problem = problems()[case]
    packed = bench_sim.eg_pack("pdhg", problem, "cpu")[0]
    out, barriers = run_host(binaries["pdhg"], packed.numpy(), tmp_path,
                             96, 40)
    ref = bench_sim.eg_plain("pdhg", packed[None]).numpy()
    J, slots = problem.num_jobs, packed.shape[1]
    assert bench_sim.eg_misses(
        problem, out[:J].astype(np.float64), float(out[slots]),
        ref[:J].astype(np.float64), float(ref[slots])) == []
    # Cycles, restarts and the flags equal; the residuals to the limits.
    np.testing.assert_array_equal(out[slots + 1:slots + 4],
                                  ref[slots + 1:slots + 4])
    np.testing.assert_array_equal(out[slots + 6:], ref[slots + 6:])
    # The barrier count is what bench_sim.eg_work reads the work from.
    work = bench_sim.eg_work("pdhg", slots, out, barriers)
    assert barriers == 147 + work["cycles"] * 107 + 30 * work[
        "dual_projections"]


@pytest.mark.parametrize("case", [0, 1])
def test_kernel_b_on_the_host_matches_its_plain_version(binaries, tmp_path,
                                                        case):
    problem = problems()[case]
    packed = bench_sim.eg_pack("relaxed", problem, "cpu")[0]
    out, barriers = run_host(binaries["relaxed"], packed.numpy(), tmp_path,
                             256)
    ref = bench_sim.eg_plain("relaxed", packed[None]).numpy()
    J, slots = problem.num_jobs, packed.shape[1]
    assert bench_sim.eg_misses(
        problem, out[:J].astype(np.float64), float(out[slots]),
        ref[:J].astype(np.float64), float(ref[slots])) == []
    assert out[slots + 1] == 256
    # Per step: the logsumexp's two, the projection's 61, the objective's
    # one; before the loop the set-up, a projection and an objective.
    assert barriers == 1 + 61 + 1 + 256 * 64


def test_kernels_repeat_bit_for_bit_on_the_host(binaries, tmp_path):
    problem = problems()[1]
    for kind, args in (("pdhg", (96, 40)), ("relaxed", (64,))):
        packed = bench_sim.eg_pack(kind, problem, "cpu")[0].numpy()
        first = run_host(binaries[kind], packed, tmp_path, *args)
        second = run_host(binaries[kind], packed, tmp_path, *args)
        assert np.array_equal(first[0], second[0]) and first[1] == second[1]
