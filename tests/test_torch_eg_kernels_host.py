"""The CUDA sources of kernels A (``ops/csrc/eg_pdhg.cu``) and B
(``ops/csrc/eg_relaxed.cu``) built with the host's C++ compiler and run on
the CPU, one block of 64 threads as std::threads
(``tests/cuda_host/cuda_runtime.h`` stands in for the CUDA builtins),
against the kernels' plain PyTorch versions on the same packed problems.

This checks the kernels' own control flow, indexing and reductions where
no card is: the block size (64 here, 1024 on the card) changes only the
order of the sums, so the limits are those of two summation orders
(``bench_sim.eg_misses``). Each kernel is a template of (levels of its
bisection tree, state resident in shared memory or not), and every
instantiation must return the sequential one's bits (one bisection step
a barrier, the full butterfly reducer, state in global memory) and pass
the barriers its code counts (``bench_sim.eg_barriers``). Whether the
sources compile for sm_90a and how they run there, ``chip_smoke.py``
checks on the card.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import bench
from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed
from shockwave_tpu_torch.solver import eg_pdhg as eg_pdhg_solver
from shockwave_tpu_torch.tools import bench_sim
from test_torch_solver import port_problem

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "shockwave_tpu_torch" / "ops" / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"
THREADS = 64
# A block wider than the 64 slots of the smaller problems: its last two
# warps own no slot, as most warps of a card's block do at 64-512 slots.
IDLE_THREADS = 128


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """Both kernels built for the host, as a default build (the wrappers'
    instantiations and the sequential one) under their names, with every
    instantiation (-DEG_ALL_LEVELS) under "<kind>_all", and so at
    IDLE_THREADS threads under "<kind>_<IDLE_THREADS>": the launch
    syntax (<<<...>>>) is dropped from a copy of each source, so its C
    entry point calls the kernel function on the fiber that runs it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed (g++ or c++ on PATH)"
    out = tmp_path_factory.mktemp("eg_host")
    jobs = {}
    for kind, source in (("pdhg", "eg_pdhg.cu"), ("relaxed", "eg_relaxed.cu")):
        text = re.sub(r"<<<.*?>>>", "", (CSRC / source).read_text(),
                      flags=re.S)
        copy = out / f"{kind}.cpp"
        copy.write_text(text)
        for name, threads, defines in (
                (kind, THREADS, []),
                (f"{kind}_all", THREADS, ["-DEG_ALL_LEVELS"]),
                (f"{kind}_{IDLE_THREADS}", IDLE_THREADS, ["-DEG_ALL_LEVELS"])):
            flags = ["-DKERNEL_PDHG"] if kind == "pdhg" else []
            jobs[name] = subprocess.Popen(
                [cxx, "-O2", "-std=c++20", f"-DEG_THREADS={threads}",
                 f'-DKERNEL_SOURCE="{copy}"', *flags, *defines,
                 "-Wno-unknown-pragmas", "-I", str(HOST), "-I", str(CSRC),
                 str(HOST / "run_kernel.cpp"), "-o", str(out / name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, job in jobs.items():
        log, _ = job.communicate(timeout=300)
        assert job.returncode == 0, f"{name}: {log}"
        built[name] = out / name
    return built


# Every instantiation but the sequential one, (levels, resident).
VARIANTS = [(L, r) for r in (False, True) for L in range(1, 6)
            if (L, r) != eg_pdhg.SEQUENTIAL]
# Kernel A's arguments (max cycles, inner iterations), and kernel B's
# steps in the bitwise checks (the plain-version checks run all 256).
ARGS = {"pdhg": (96, 40), "relaxed": (64,)}


def run_host(binary, packed: np.ndarray, tmp_path, variant, *args):
    """The solve of ``packed`` by the host build of the ``variant``
    (levels, resident) instantiation: (output row, stats row) of one
    problem ([rows, slots]), or (output rows, stats rows) of a launch of
    P problems ([P, rows, slots]), run block by block."""
    inp, out = tmp_path / "packed.bin", tmp_path / "out.bin"
    packed.astype(np.float32).tofile(inp)
    lanes = packed.shape[0] if packed.ndim == 3 else None
    rows, slots = packed.shape[-2:]
    levels, resident = variant
    subprocess.run([str(binary), str(inp), str(out), str(rows), str(slots),
                    str(levels), str(int(resident)), *map(str, args)],
                   check=True, timeout=600)
    raw = out.read_bytes()
    cut = len(raw) - 8 * eg_pdhg.STATS * (lanes or 1)
    rows_out = np.frombuffer(raw[:cut], np.float32)
    stats = np.frombuffer(raw[cut:], np.int64)
    if lanes is None:
        return rows_out, stats
    return rows_out.reshape(lanes, -1), stats.reshape(lanes, -1)


def module_of(kind: str):
    return eg_pdhg if kind == "pdhg" else eg_relaxed


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
    variant = eg_pdhg.instantiation(packed.shape[1])
    out, stats = run_host(binaries["pdhg"], packed.numpy(), tmp_path,
                          variant, 96, 40)
    ref = bench_sim.eg_plain("pdhg", packed[None]).numpy()
    J, slots = problem.num_jobs, packed.shape[1]
    assert bench_sim.eg_misses(
        problem, out[:J].astype(np.float64), float(out[slots]),
        ref[:J].astype(np.float64), float(ref[slots])) == []
    # Cycles, restarts and the flags equal; the residuals to the limits.
    np.testing.assert_array_equal(out[slots + 1:slots + 4],
                                  ref[slots + 1:slots + 4])
    np.testing.assert_array_equal(out[slots + 6:], ref[slots + 6:])
    # The wrapper's instantiation keeps the state in shared memory up to
    # 2048 slots, and passes the barriers its code counts.
    assert variant[1]
    counts = bench_sim.eg_counts("pdhg", slots, out, stats)
    assert stats[0] == bench_sim.eg_barriers("pdhg", counts, variant[0],
                                             False)


@pytest.mark.parametrize("case", [0, 1])
def test_kernel_b_on_the_host_matches_its_plain_version(binaries, tmp_path,
                                                        case):
    problem = problems()[case]
    packed = bench_sim.eg_pack("relaxed", problem, "cpu")[0]
    variant = eg_relaxed.instantiation(packed.shape[1])
    out, stats = run_host(binaries["relaxed"], packed.numpy(), tmp_path,
                          variant, 256)
    ref = bench_sim.eg_plain("relaxed", packed[None]).numpy()
    J, slots = problem.num_jobs, packed.shape[1]
    assert bench_sim.eg_misses(
        problem, out[:J].astype(np.float64), float(out[slots]),
        ref[:J].astype(np.float64), float(ref[slots])) == []
    assert out[slots + 1] == 256
    # Per step: the logsumexp's sum, the projection's first reduction and
    # ceil(60 / L) tree rounds when it bisects, the objective's one; before
    # the loop the set-up, a projection and an objective.
    assert variant[1]
    counts = bench_sim.eg_counts("relaxed", slots, out, stats)
    rounds = -(-60 // variant[0])
    assert stats[0] == 3 + 3 * 256 + rounds * counts["projections"]
    assert stats[0] == bench_sim.eg_barriers("relaxed", counts, variant[0],
                                             False)


def test_kernels_repeat_bit_for_bit_on_the_host(binaries, tmp_path):
    problem = problems()[1]
    for kind, args in ARGS.items():
        packed = bench_sim.eg_pack(kind, problem, "cpu")[0].numpy()
        variant = module_of(kind).instantiation(packed.shape[1])
        first = run_host(binaries[kind], packed, tmp_path, variant, *args)
        second = run_host(binaries[kind], packed, tmp_path, variant, *args)
        assert np.array_equal(first[0].view(np.int32),
                              second[0].view(np.int32))
        assert np.array_equal(first[1], second[1])


@pytest.mark.parametrize("variant", [(2, True), eg_pdhg.SEQUENTIAL],
                         ids=["2-resident", "1-global"])
def test_kernel_a_lanes_of_one_launch_equal_their_own_launches(
        binaries, tmp_path, variant):
    """The lane grid: a launch of P problems (the cells market's and the
    what-if fleet's) reads lane b's rows and writes its output and stats
    rows at block b, state in shared memory or at block b's place in the
    scratch, so every lane returns its own one-problem launch's bits and
    counters; a lane's neighbours do not change them."""
    lanes = [bench_sim.eg_pack("pdhg", p, "cpu")[0].numpy()
             for p in (bench_sim.seeded_problem(40, seed=0, num_gpus=16),
                       bench_sim.parity_problem(64 * 1000 + 500, 64, True),
                       bench_sim.seeded_problem(64, seed=3, num_gpus=8))]
    grid, grid_stats = run_host(binaries["pdhg"], np.stack(lanes), tmp_path,
                                variant, *ARGS["pdhg"])
    assert grid.shape == (3, 64 + len(eg_pdhg_solver.DIAG))
    for b, packed in enumerate(lanes):
        out, stats = run_host(binaries["pdhg"], packed, tmp_path, variant,
                              *ARGS["pdhg"])
        assert np.array_equal(grid[b].view(np.int32), out.view(np.int32))
        assert np.array_equal(grid_stats[b], stats)
    reversed_grid, _ = run_host(binaries["pdhg"], np.stack(lanes[::-1]),
                                tmp_path, variant, *ARGS["pdhg"])
    assert np.array_equal(reversed_grid[::-1].view(np.int32),
                          grid.view(np.int32))


@pytest.fixture(scope="module")
def sequential(binaries, tmp_path_factory):
    """The sequential instantiation's (output, stats) on each problem, by
    kernel: the yardstick of every other instantiation."""
    tmp = tmp_path_factory.mktemp("eg_sequential")
    return {kind: [run_host(binaries[kind],
                            bench_sim.eg_pack(kind, p, "cpu")[0].numpy(), tmp,
                            eg_pdhg.SEQUENTIAL, *args)
                   for p in problems()]
            for kind, args in ARGS.items()}


def test_the_sequential_instantiation_passes_the_sequential_barriers(
        sequential):
    """One barrier a bisection step, every bisection run, the logsumexp's
    max reduced each step: 147 + 107 c + 30 d for kernel A and 63 + 64 n
    for kernel B."""
    for kind, runs in sequential.items():
        for problem, (out, stats) in zip(problems(), runs):
            slots = bench_sim.eg_pack(kind, problem, "cpu").shape[2]
            counts = bench_sim.eg_counts(kind, slots, out, stats)
            if kind == "pdhg":
                assert counts["projections"] == counts["cycles"] + 1
                assert counts["fills"] == 1
                expected = 147 + 107 * counts["cycles"] + 30 * counts[
                    "dual_projections"]
            else:
                assert counts["projections"] == ARGS[kind][0] + 1
                expected = 63 + 64 * ARGS[kind][0]
            assert stats[0] == expected
            assert stats[0] == bench_sim.eg_barriers(kind, counts, 1, True)


@pytest.mark.parametrize("kind", ["pdhg", "relaxed"])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: (
    f"{v[0]}-{'resident' if v[1] else 'global'}"))
def test_every_instantiation_returns_the_sequential_bits(
        binaries, sequential, tmp_path, kind, variant):
    """Each bisection tree, the halving reducer, the skipped bisections,
    kernel B's logsumexp max from the objective and the state in shared
    memory leave every output bit as the sequential instantiation's, and
    the barriers are those the code counts."""
    levels = variant[0]
    for problem, (ref, ref_stats) in zip(problems(), sequential[kind]):
        packed = bench_sim.eg_pack(kind, problem, "cpu")[0].numpy()
        out, stats = run_host(binaries[f"{kind}_all"], packed, tmp_path,
                              variant, *ARGS[kind])
        assert np.array_equal(out.view(np.int32), ref.view(np.int32))
        slots = packed.shape[1]
        counts = bench_sim.eg_counts(kind, slots, out, stats)
        assert stats[0] == bench_sim.eg_barriers(kind, counts, levels, False)
        assert stats[0] < ref_stats[0]
        # The same dual projections; budget projections and fills only
        # where their answer needs them.
        assert stats[1] == ref_stats[1]
        assert stats[2] <= ref_stats[2] and stats[3] <= ref_stats[3]


@pytest.mark.parametrize("kind", ["pdhg", "relaxed"])
def test_warps_that_own_no_slot_skip_their_combining_bit_for_bit(
        binaries, tmp_path, kind):
    """At 128 threads and 64 slots two warps hold only the identities:
    outside the sequential structure they skip the combining inside the
    warp, and every output bit stays the sequential one's."""
    binary = binaries[f"{kind}_{IDLE_THREADS}"]
    for problem in problems()[:2]:
        packed = bench_sim.eg_pack(kind, problem, "cpu")[0].numpy()
        assert packed.shape[1] == 64
        ref, _ = run_host(binary, packed, tmp_path, eg_pdhg.SEQUENTIAL,
                          *ARGS[kind])
        for variant in ((1, True), (2, False), (3, True), (5, True)):
            out, _ = run_host(binary, packed, tmp_path, variant, *ARGS[kind])
            assert np.array_equal(out.view(np.int32), ref.view(np.int32))


def test_five_levels_pass_at_most_35_plus_59c_plus_6d_barriers(
        binaries, tmp_path):
    """Kernel A's five-level tree with its state in shared memory: 60 / 30
    / 80 bisection steps in 12 / 6 / 16 barriers, the skipped bisections
    counted out."""
    for problem in problems():
        packed = bench_sim.eg_pack("pdhg", problem, "cpu")[0].numpy()
        out, stats = run_host(binaries["pdhg_all"], packed, tmp_path,
                              (5, True), *ARGS["pdhg"])
        counts = bench_sim.eg_counts("pdhg", packed.shape[1], out, stats)
        assert stats[0] <= 35 + 59 * counts["cycles"] + 6 * counts[
            "dual_projections"]


@pytest.mark.parametrize("kind", ["pdhg", "relaxed"])
def test_a_default_build_holds_the_wrappers_instantiations(
        binaries, tmp_path, kind):
    """A default build launches the wrapper's instantiations and the
    sequential one (``BUILT``, run by the other tests) and refuses every
    other; the wrapper takes those from the -DEG_ALL_LEVELS build."""
    module = module_of(kind)
    assert eg_pdhg.SEQUENTIAL in module.BUILT
    packed = bench_sim.eg_pack(kind, problems()[1], "cpu")[0].numpy()
    for variant in VARIANTS:
        if variant in module.BUILT:
            continue
        with pytest.raises(subprocess.CalledProcessError) as e:
            run_host(binaries[kind], packed, tmp_path, variant, *ARGS[kind])
        assert e.value.returncode == 4


def test_wrappers_keep_state_in_shared_memory_up_to_2048_slots():
    """The row counts are the sources' (enum Row); the state fits in an
    H100 block's shared memory up to 2048 slots for both kernels; every
    slot count takes an instantiation of a default build."""
    for kind, module in (("pdhg", eg_pdhg), ("relaxed", eg_relaxed)):
        text = (CSRC / f"eg_{kind}.cu").read_text()
        body = re.search(r"enum Row \{(.*?)\};", text, flags=re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        names = [n.strip() for n in body.split(",") if n.strip()]
        assert names[-1] == "ROWS" and len(names) - 1 == module.STATE_ROWS
        for slots in (64, 100, 256, 512, 1024, 2048, 3000, 4096, 16384,
                      65536, 1 << 18):
            levels, resident = module.instantiation(slots)
            assert (levels, resident) in module.BUILT
            if slots & (slots - 1) == 0:  # the slot counts problems take
                assert resident == (slots <= 2048)


def test_ptxas_usage_reads_each_instantiations_report(tmp_path):
    """bench_sim.ptxas_usage (chip_smoke.py's and the level sweep's reader)
    names each planning kernel's instantiation in nvcc's -Xptxas -v report
    and reads its registers, stack, spills and static shared memory (the
    report is kept beside the library)."""
    entry = ("ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__f49"
             "f38d7_13_eg_relaxed_cu_ea3713ef14relaxed_kernelILi{L}ELb{R}EEEv"
             "PKfPfS3_Pxii' for 'sm_90a'\n"
             "ptxas info    : Function properties for _ZN...\n"
             "    {stack} bytes stack frame, {spill} bytes spill stores, 4 "
             "bytes spill loads\n"
             "ptxas info    : Used {reg} registers, used 1 barriers, "
             "{stack} bytes cumulative stack size, 8448 bytes smem\n")
    probe = ("ptxas info    : Compiling entry function '_ZN2eg13barrier_probe"
             "ILi3EEEvPfi' for 'sm_90a'\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
             "loads\nptxas info    : Used 18 registers, used 1 barriers, "
             "8448 bytes smem\n")
    (tmp_path / "eg_relaxed-x.log").write_text(
        entry.format(L=1, R=1, stack=32, spill=20, reg=64) + probe
        + entry.format(L=2, R=0, stack=48, spill=0, reg=63))
    usage = bench_sim.ptxas_usage(tmp_path / "eg_relaxed-x.so")
    assert usage == {
        "relaxed_kernel<1, true>": {"REG": 64, "STACK": 32, "SPILL": 20,
                                    "SMEM": 8448},
        "barrier_probe<3>": {"REG": 18, "STACK": 0, "SPILL": 0, "SMEM": 8448},
        "relaxed_kernel<2, false>": {"REG": 63, "STACK": 48, "SPILL": 0,
                                     "SMEM": 8448},
    }
