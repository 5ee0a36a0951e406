"""Drive, check and time the port's simulation path.

    python -m shockwave_tpu_torch.tools.bench_sim            # on the card
    python -m shockwave_tpu_torch.tools.bench_sim --device cpu
    python -m shockwave_tpu_torch.tools.bench_sim --first-order  # card only
    python -m shockwave_tpu_torch.tools.bench_sim --first-order --levels

``chip_smoke.py`` and the tests use the helpers here: the trace runs and
the constants they are held to (``run_trace``, ``check_run``, ``GOLDEN``,
``TIER_2048``), the seeded planning problems (``seeded_problem`` for
timing, ``parity_problems`` for the checks), the check of the level
solve on a device against the port's own CPU solve
(``check_device_counts``), the per-solve timing of the level solve
and the native greedy (``time_solves``, ``crossover``), and the
first-order kernels (A, the PDHG solve; B, the relaxed PGD solve): each
kernel against its plain version (``check_eg_kernels``) and timed with
its plain version, its block barriers and its bounds per job band
(``time_eg_kernels``).

As a tool it runs the 2048-job tier under ``shockwave_tpu`` and makes
``solve_report`` of the planning problems it built: the device's counts
against the CPU's on those and on the seeded problems, then the level
solve and the native greedy timed per slot band on seeded problems
(``BANDS``: 64 to 1024 jobs on 256 GPUs, 20 rounds) and on a sample of
the run's problems across their job counts (``TRACE_SAMPLE``). It prints
each reading and, as its last line, one JSON object with them, the
crossover of each set (the fewest jobs from which the level solve is the
faster on every larger problem) and the card's name and power limit.
With ``--first-order`` it instead checks kernels A and B against their
plain versions and their sequential instantiations on the seeded problems
of ``EG_CHECK_BANDS`` and times the wrapper's instantiation and the
sequential one in turns per band of ``EG_TIME_BANDS``
(``time_eg_kernels``); with ``--levels`` as well, it times every
instantiation per band (``sweep_levels``), the data the wrapper's levels
are chosen from.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
TRACES = ROOT / "traces"
GOLDEN_TRACE = TRACES / "small_12_dynamic.trace"
TRACE_2048 = TRACES / "generated_2048_dynamic.trace"
# The JAX package's golden metrics of the 12-job trace on 8 GPUs with
# 120 s rounds (tests/test_golden.py:36-41).
GOLDEN = {
    "shockwave_tpu_level": dict(makespan=13456.422, avg_jct=5658.689,
                                worst_ftf=2.029),
    "shockwave_native": dict(makespan=12976.464, avg_jct=5745.960,
                             worst_ftf=2.029),
}
# The JAX package's metrics of the same run under its first-order
# backends (its scripts/simulate.py -p <policy> -c v100=8
# --time_per_iteration 120 on the trace, on the CPU).
GOLDEN_FIRST_ORDER = {
    "shockwave_tpu_pdhg": dict(makespan=13456.424, avg_jct=5789.595,
                               worst_ftf=2.029),
    "shockwave_tpu_relaxed": dict(makespan=13456.413, avg_jct=5800.501,
                                  worst_ftf=2.029),
}
# The JAX package's run of the 2048-job trace on 256 GPUs with 120 s
# rounds under shockwave_tpu, the production dispatch, on the CPU:
# 497 rounds, 65 level and 349 native solves.
TIER_2048 = dict(makespan=59578.486, avg_jct=12981.718, worst_ftf=1.410,
                 rounds=497)
# The same run under shockwave_tpu_pdhg (the JAX package on the CPU, 424
# PDHG solves; the port's plain PDHG on the CPU gives the same digits).
TIER_2048_PDHG = dict(makespan=58678.337, avg_jct=13412.053, worst_ftf=1.399,
                      rounds=489)
TOLERANCE = 1e-3
# A device's level-solve objective against the CPU's: the sum over jobs
# is taken in another order, so its last bits may differ.
OBJECTIVE_RTOL = 1e-6
ROUND_S = 120.0
BANDS = (64, 128, 256, 384, 512, 768, 1024)
# Seeded parity problems per slot band, with and without a switch bonus
# (204 in all; tests/test_torch_solver.py holds them to the JAX package).
PARITY_PER_BAND = {64: 30, 128: 25, 256: 20, 512: 15, 1024: 12}
LOG_BASES = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0])
# Planning problems of a trace run timed for the crossover.
TRACE_SAMPLE = 12
ITERS = 20
NATIVE_ITERS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def run_trace(trace, policy: str, num_gpus: int, device,
              capture: list = None, plans: list = None,
              config: dict = None) -> dict:
    """Simulate ``trace`` on ``num_gpus`` v100s with 120 s rounds under
    ``policy`` with the planner's device solves on ``device``, as
    tests/test_golden.py drives the JAX package (``config`` adds planner
    keys, e.g. ``plan_deadline_s``). Returns the metrics, the rounds, the
    solves by backend (with their summed wall seconds), the level solves
    by the device their tensors lay on, the launches of the PDHG and
    relaxed kernels, the planner's solve records and the run's wall
    time. ``capture``, where given, receives every planning problem the
    planner solves, and ``plans`` (round, schedule) of every solve. The
    kernels' launches come by instantiation too (``variants``)."""
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data import load_or_synthesize_profiles, parse_trace
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.solver import eg_level

    start = time.perf_counter()
    jobs, arrivals = parse_trace(str(trace))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(str(trace), jobs, oracle,
                                           cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = {"num_gpus": num_gpus, "time_per_iteration": ROUND_S,
              "future_rounds": 20, "lambda": 5.0, "k": 10.0, **(config or {})}
    sched = Scheduler(get_policy(policy, device=device),
                      throughputs=oracle, seed=0, time_per_iteration=ROUND_S,
                      profiles=profiles, shockwave_config=config)
    if capture is not None or plans is not None:
        planner = sched._shockwave
        solve = planner._solve

        def capturing(problem):
            if capture is not None:
                capture.append(problem)
            Y, used = solve(problem)
            if plans is not None:
                plans.append((planner.round_index, Y.copy()))
            return Y, used

        planner._solve = capturing
    eg_level.SOLVES.clear()
    eg_pdhg.reset_launch_counts()
    eg_relaxed.reset_launch_counts()
    makespan = sched.simulate({"v100": num_gpus}, arrivals, jobs)
    device_solves = dict(eg_level.SOLVES)
    launches = {**eg_pdhg.LAUNCHES, **eg_relaxed.LAUNCHES}
    variants = {"eg_pdhg": dict(eg_pdhg.LAUNCHES_BY_VARIANT),
                "eg_relaxed": dict(eg_relaxed.LAUNCHES_BY_VARIANT)}
    ftf, _ = sched.get_finish_time_fairness()
    backends: dict = {}
    solve_s: dict = {}
    for record in sched._shockwave.solve_records:
        name = record["backend"]
        backends[name] = backends.get(name, 0) + 1
        solve_s[name] = solve_s.get(name, 0.0) + record["seconds"]
    return dict(policy=policy, makespan=makespan,
                avg_jct=sched.get_average_jct(), worst_ftf=max(ftf),
                rounds=sched._num_completed_rounds, solves=backends,
                solve_s=solve_s, device_solves=device_solves,
                launches=launches, variants=variants,
                records=list(sched._shockwave.solve_records),
                wall_s=time.perf_counter() - start)


def check_run(result: dict, expected: dict) -> list:
    """The metrics (and rounds, where given) that miss ``expected`` by more
    than ``TOLERANCE``."""
    return [f"{k} {result[k]} vs {v}" for k, v in expected.items()
            if abs(result[k] - v) > TOLERANCE]


def seeded_problem(num_jobs: int, seed: int = 0, num_gpus: int = 256,
                   future_rounds: int = 20):
    """A planning problem shaped as the planner builds them: 1-8-wide
    gangs, epochs and durations spread as the traces spread them,
    priorities FTF**5, 120 s rounds, regularizer 10."""
    from shockwave_tpu_torch.solver.eg_problem import EGProblem

    rng = np.random.default_rng(seed)
    J = num_jobs
    total = rng.integers(1, 150, J).astype(np.float64)
    completed = np.floor(total * rng.uniform(0.0, 0.9, J))
    epoch_dur = rng.uniform(20.0, 2000.0, J)
    return EGProblem(
        priorities=rng.uniform(0.3, 2.5, J) ** 5,
        completed_epochs=completed,
        total_epochs=total,
        epoch_duration=epoch_dur,
        remaining_runtime=(total - completed) * epoch_dur
        * rng.uniform(0.8, 1.2, J),
        nworkers=rng.choice([1, 2, 4, 8], J, p=[0.55, 0.25, 0.12, 0.08]
                            ).astype(np.float64),
        num_gpus=num_gpus,
        round_duration=120.0,
        future_rounds=future_rounds,
        regularizer=10.0,
        log_bases=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0]),
    )


def parity_problem(seed: int, band: int, bonus: bool):
    """A planning problem of ``band`` slots: 1-8-wide gangs, some wider
    than the cluster, some jobs with nothing left to run, priorities
    spread as FTF**5 spreads them, and (with ``bonus``) incumbents with a
    relaunch overhead."""
    from shockwave_tpu_torch.solver.eg_problem import EGProblem

    rng = np.random.default_rng(seed)
    J = int(rng.integers(band // 2 + 1, band + 1)) if band > 64 else int(
        rng.integers(1, 65))
    num_gpus = int(rng.choice([6, 8, 16, 64, 256]))
    nworkers = rng.choice([1, 2, 4, 8, 3], J, p=[0.5, 0.2, 0.15, 0.1, 0.05])
    wide = rng.random(J) < 0.03
    nworkers = np.where(wide, 2 * num_gpus, nworkers).astype(np.float64)
    total = rng.integers(1, 150, J).astype(np.float64)
    completed = np.floor(total * rng.uniform(0.0, 1.0, J))
    epoch_dur = rng.uniform(20.0, 2000.0, J)
    remaining = (total - completed) * epoch_dur * rng.uniform(0.8, 1.2, J)
    done = rng.random(J) < 0.05
    completed = np.where(done, total, completed)
    remaining = np.where(done, 0.0, remaining)
    switch_cost = incumbent = None
    if bonus:
        switch_cost = np.where(rng.random(J) < 0.5,
                               rng.uniform(5.0, 300.0, J), 0.0)
        incumbent = (rng.random(J) < 0.4).astype(np.float64)
        # At least one incumbent with an overhead: a nonzero bonus.
        switch_cost[0], incumbent[0] = 60.0, 1.0
    return EGProblem(
        priorities=rng.uniform(0.3, 2.5, J) ** 5,
        completed_epochs=completed,
        total_epochs=total,
        epoch_duration=epoch_dur,
        remaining_runtime=remaining,
        nworkers=nworkers,
        num_gpus=num_gpus,
        round_duration=float(rng.choice([120.0, 360.0])),
        future_rounds=20,
        regularizer=float(rng.choice([10.0, 1.0, 1e-3])),
        log_bases=LOG_BASES,
        switch_cost=switch_cost,
        incumbent=incumbent,
    )


def parity_problems(band: int = None, bonus: bool = None,
                    count: int = None) -> list:
    """The seeded parity problems of ``band`` with or without a switch
    bonus (the first ``count`` of them), or, called with no band, all
    204 of every band."""
    if band is None:
        return [p for b in PARITY_PER_BAND for with_bonus in (False, True)
                for p in parity_problems(b, with_bonus)]
    base = 1000 * band + (500 if bonus else 0)
    return [parity_problem(base + i, band, bonus)
            for i in range(count or PARITY_PER_BAND[band])]


def check_device_counts(problems, device) -> list:
    """The level solve on ``device`` against the port's CPU solve of the
    same problems (tests/test_torch_solver.py holds the CPU solve to the
    JAX package): counts equal, objectives within ``OBJECTIVE_RTOL``.
    Returns one line for each problem that misses."""
    from shockwave_tpu_torch.solver.eg_level import solve_level_counts

    cpu = torch.device("cpu")
    bad = []
    for i, problem in enumerate(problems):
        counts, obj = solve_level_counts(problem, device)
        ref_counts, ref_obj = solve_level_counts(problem, cpu)
        where = f"problem {i} ({problem.num_jobs} jobs)"
        if not np.array_equal(counts, ref_counts):
            bad.append(f"{where}: {int(np.sum(counts != ref_counts))} "
                       f"counts differ")
        elif obj != ref_obj and not (
                abs(obj - ref_obj) <= OBJECTIVE_RTOL * abs(ref_obj)):
            bad.append(f"{where}: objective {obj!r} vs {ref_obj!r}")
    return bad


def sample_by_jobs(problems, count: int = TRACE_SAMPLE) -> list:
    """``count`` of ``problems`` spread evenly over their distinct job
    counts, smallest to largest, one problem per job count."""
    by_jobs = {}
    for problem in problems:
        by_jobs.setdefault(problem.num_jobs, problem)
    jobs = sorted(by_jobs)
    count = min(count, len(jobs))
    picks = sorted({jobs[round(i * (len(jobs) - 1) / max(count - 1, 1))]
                    for i in range(count)})
    return [by_jobs[j] for j in picks]


def crossover(rows) -> int:
    """The fewest jobs from which the level solve beats the native
    greedy on every row with at least that many jobs; None where it
    loses on the largest."""
    start = None
    for row in sorted(rows, key=lambda r: r["jobs"]):
        if row["level_ms"] < row["native_ms"]:
            start = row["jobs"] if start is None else start
        else:
            start = None
    return start


def _median_s(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return statistics.median(times)


def device_profile(problem, device) -> dict:
    """One level solve under torch.profiler: the kernels it launched,
    its copies, and the device's busy time (the kernels' and copies'
    self time, ms). None for the counts when the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    from shockwave_tpu_torch.solver.eg_level import solve_level_counts

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_level_counts(problem, device)
    kernels = copies = 0
    busy_us = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += evt.device_time_total
        if evt.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
    if kernels + copies == 0:
        return dict(launches=None, copies=None, busy_ms=None)
    return dict(launches=kernels, copies=copies, busy_ms=busy_us / 1e3)


def time_solves(problem, device) -> dict:
    """ms per solve on ``problem``, each the median of ``ITERS`` (the
    native greedy's of ``NATIVE_ITERS``) after a warm-up: the level solve's device head (pad, copy, solve, fetch:
    host clock around work that ends in the fetch) and host tail
    (polish, placement, reorder), and the native greedy (with its
    reorder). On a card, also the profiler's launches and busy time."""
    from shockwave_tpu_torch import native
    from shockwave_tpu_torch.solver.eg_level import (
        counts_to_schedule,
        solve_level_counts,
    )
    from shockwave_tpu_torch.solver.rounding import reorder_rounds

    device = torch.device(device)
    counts, _ = solve_level_counts(problem, device)

    def tail():
        Y = counts_to_schedule(counts, problem)
        return reorder_rounds(Y, problem.priorities, problem.nworkers,
                              problem.num_gpus)

    def greedy():
        Y = native.solve_eg_greedy_native(problem)
        return reorder_rounds(Y, problem.priorities, problem.nworkers,
                              problem.num_gpus)

    tail()
    greedy()
    row = dict(jobs=problem.num_jobs, num_gpus=problem.num_gpus,
               future_rounds=problem.future_rounds,
               device_ms=1e3 * _median_s(
                   lambda: solve_level_counts(problem, device), ITERS),
               host_tail_ms=1e3 * _median_s(tail, ITERS),
               native_ms=1e3 * _median_s(greedy, NATIVE_ITERS))
    row["level_ms"] = row["device_ms"] + row["host_tail_ms"]
    if device.type == "cuda":
        row.update(device_profile(problem, device))
    return row


def solve_report(device, problems) -> tuple:
    """The level solve on ``device`` checked against the CPU's on the
    parity problems, a seeded problem of every band of ``BANDS`` and
    ``problems`` (a trace run's); then, if none missed, both backends
    timed on the seeded problems and on a sample of ``problems``, with
    each set's crossover. Returns (the misses, the readings)."""
    seeded = [seeded_problem(jobs) for jobs in BANDS]
    checked = parity_problems() + seeded + list(problems)
    bad = check_device_counts(checked, device)
    if bad:
        return bad, {}
    print(f"level solve on {device} equals the CPU's on {len(checked)} "
          f"problems ({len(problems)} of them the trace run's)", flush=True)
    report = {"checked": len(checked)}
    for name, sample in (("seeded", seeded),
                         ("trace", sample_by_jobs(problems))):
        print(f"level solve and native greedy, {name} problems (median of "
              f"{ITERS}, native of {NATIVE_ITERS}):", flush=True)
        rows = []
        for problem in sample:
            rows.append(time_solves(problem, device))
            print("  " + describe(rows[-1]), flush=True)
        report[name] = dict(rows=rows,
                            level_faster_from_jobs=crossover(rows))
        start = crossover(rows)
        print(f"  level solve faster on every problem from {start} jobs"
              if start else "  level solve slower on the largest problem",
              flush=True)
    return [], report


# -- the first-order kernels: A (eg_pdhg) and B (eg_relaxed) -------------

# Seeded problems (256 GPUs, 20 rounds) the kernels are checked on, and the
# bands they are timed at; the plain versions are timed up to
# EG_PLAIN_MAX_JOBS (one run each: seconds of eager launches).
EG_CHECK_BANDS = (64, 256, 1024, 4096)
EG_TIME_BANDS = (256, 1024, 4096, 16384, 65536)
# Bands the level sweep times every instantiation at: each slot count a
# problem can take up to 2048 (the warps that own slots change with it),
# then the timing bands.
EG_SWEEP_BANDS = (64, 128, 256, 512, 1024, 2048, 4096, 16384, 65536)
EG_PLAIN_MAX_JOBS = 4096
EG_ITERS = 5
# Limits of two summation orders of the same arithmetic: the JAX
# package's own, for its sharded against its single-device PDHG
# (tests/test_pdhg.py:377-398).
S_TOL, OBJ_TOL, ROUNDED_TOL = 5e-3, 1e-3, 2e-3
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
F32_PEAK = 67e12
HBM_BYTES = 3.35e12
# Float32 values of per-job state one pass over the jobs touches, and
# the operations it does a job, counted from csrc/eg_pdhg.cu and
# csrc/eg_relaxed.cu (a transcendental counts as one operation); the
# "_iter" entries are one step of a block-wide bisection.
PDHG_FLOATS = dict(step=13, acc=6, move=4, dual_iter=1, dual=2,
                   proj_iter=3, proj=14, obj=7, cycle=20, fill_iter=9,
                   fill=12)
PDHG_OPS = dict(step=312, acc=2, move=4, dual_iter=3, dual=2, proj_iter=6,
                proj=12, obj=8, cycle=10, fill_iter=17, fill=40)
RELAXED_FLOATS = dict(step=37, proj_iter=3)
RELAXED_OPS = dict(step=65, proj_iter=6)
# Steps of the block-wide bisections (csrc/eg_common.cuh, eg_pdhg.cu).
PROJ_STEPS, DUAL_STEPS, FILL_STEPS = 60, 30, 80
# Empty fused reductions the barrier probe times.
PROBE_ITERS = 20000


def eg_pack(kind: str, problem, device) -> torch.Tensor:
    """``problem`` packed for kernel A ("pdhg": demand-point warm start,
    the reference's default tolerances) or B ("relaxed"), one copy to
    ``device``: [1, rows, slots]."""
    from shockwave_tpu_torch.solver import eg_level, eg_pdhg, eg_relaxed

    slots = eg_level.num_slots_for(problem.num_jobs)
    if kind == "pdhg":
        host = eg_pdhg._packed_args(problem, slots, None, eg_pdhg.DEFAULT_TOL,
                                    eg_pdhg._STALL_REL)
    else:
        host = eg_relaxed._packed_args(problem, slots)
    return torch.from_numpy(host).to(device)[None]


def eg_solve(kind: str, packed, stats=None, variant=None) -> torch.Tensor:
    """The kernel's wrapper on ``packed`` (the plain version on the CPU),
    at the reference's defaults; returns the output row. ``stats``
    receives the solve's counters, ``variant`` picks the instantiation."""
    from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed
    from shockwave_tpu_torch.solver import eg_pdhg as pdhg_solver

    if kind == "pdhg":
        return eg_pdhg.pdhg(packed, pdhg_solver.DEFAULT_MAX_CYCLES,
                            pdhg_solver.DEFAULT_INNER_ITERS, stats,
                            variant)[0]
    return eg_relaxed.relaxed(packed, 256, stats, variant)[0]


def instantiation(kind: str, slots: int) -> tuple:
    """(levels, resident) the wrapper picks for ``slots`` slots."""
    from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed

    return (eg_pdhg if kind == "pdhg" else eg_relaxed).instantiation(slots)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two float32 tensors hold the same bits."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def eg_plain(kind: str, packed) -> torch.Tensor:
    """The kernel's plain version on ``packed``'s device."""
    from shockwave_tpu_torch.solver import eg_pdhg, eg_relaxed

    if kind == "pdhg":
        return eg_pdhg._pdhg_core(packed[0], eg_pdhg.DEFAULT_MAX_CYCLES,
                                  eg_pdhg.DEFAULT_INNER_ITERS)
    return eg_relaxed.solve_relaxed(packed[0], 256)


def rounded_objective(problem, s) -> float:
    """The objective of ``s``'s rounded counts, each laid in the first
    rounds of the window."""
    from shockwave_tpu_torch.solver.rounding import round_counts

    counts = round_counts(s, problem.nworkers, problem.num_gpus,
                          problem.future_rounds)
    R = problem.future_rounds
    return problem.objective_value(
        (np.arange(R)[None, :] < counts[:, None]).astype(float))


def eg_misses(problem, s, obj, ref_s, ref_obj) -> list:
    """Where a solve misses its reference by the limits of two summation
    orders: ``s`` within rtol = atol = S_TOL, the objective within
    OBJ_TOL (1 + |obj|) and the rounded objective within ROUNDED_TOL
    (1 + |o|)."""
    bad = []
    if not np.allclose(s, ref_s, rtol=S_TOL, atol=S_TOL):
        bad.append(f"s off by {np.max(np.abs(s - ref_s)):.3g}")
    if abs(obj - ref_obj) > OBJ_TOL * (1.0 + abs(ref_obj)):
        bad.append(f"objective {obj!r} vs {ref_obj!r}")
    o, ref_o = rounded_objective(problem, s), rounded_objective(problem,
                                                                ref_s)
    if abs(o - ref_o) > ROUNDED_TOL * (1.0 + abs(ref_o)):
        bad.append(f"rounded objective {o!r} vs {ref_o!r}")
    return bad


def check_eg_kernels(problems, device) -> tuple:
    """Kernels A and B on ``device`` against their plain versions on the
    same device and inputs (``eg_misses``), each kernel run twice and
    bitwise equal, and bitwise equal to the sequential instantiation
    (one bisection step a barrier, state in global memory). Returns (the
    misses, the largest |s| error of each kernel)."""
    from shockwave_tpu_torch.ops.eg_pdhg import SEQUENTIAL

    bad, max_err = [], {"pdhg": 0.0, "relaxed": 0.0}
    for i, problem in enumerate(problems):
        for kind in ("pdhg", "relaxed"):
            packed = eg_pack(kind, problem, device)
            out = eg_solve(kind, packed)
            again = eg_solve(kind, packed)
            sequential = eg_solve(kind, packed, variant=SEQUENTIAL)
            plain = eg_plain(kind, packed)
            where = f"{kind} problem {i} ({problem.num_jobs} jobs)"
            if not same_bits(out, again):
                bad.append(f"{where}: two runs differ")
            if not same_bits(out, sequential):
                bad.append(f"{where}: instantiation "
                           f"{instantiation(kind, packed.shape[2])} differs "
                           f"from the sequential one")
            J, slots = problem.num_jobs, packed.shape[2]
            got, ref = out.cpu().numpy(), plain.cpu().numpy()
            s, ref_s = got[:J].astype(np.float64), ref[:J].astype(np.float64)
            max_err[kind] = max(max_err[kind], float(np.max(np.abs(s - ref_s))))
            bad += [f"{where}: {m}" for m in eg_misses(
                problem, s, float(got[slots]), ref_s, float(ref[slots]))]
    return bad, max_err


def l2_rate(device) -> float:
    """Bytes/s a warm copy between two 8 MiB float32 tensors moves (read
    and write together stay in the 50 MB L2): the L2-resident rate the
    state bound uses. A copy kernel's rate, so at most the L2's own."""
    x = torch.ones(1 << 21, device=device)
    y = torch.empty_like(x)
    for _ in range(3):
        y.copy_(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(100):
        y.copy_(x)
    end.record()
    torch.cuda.synchronize()
    return 100 * 2 * x.numel() * 4 / (start.elapsed_time(end) / 1e3)


def eg_counts(kind: str, slots: int, row, stats) -> dict:
    """What a solve ran, from its output row and its stats row: the PDHG
    solve's cycles and the dual projections, budget projections and
    fills whose bisection ran; the relaxed solve's steps and projections
    bisected."""
    stats = [int(x) for x in stats]
    if kind == "pdhg":
        return dict(cycles=int(row[slots + 1]), dual_projections=stats[1],
                    projections=stats[2], fills=stats[3])
    return dict(steps=int(row[slots + 1]), projections=stats[2])


def _rounds(steps: int, levels: int) -> int:
    """Tree rounds (barriers) of a bisection of ``steps`` steps."""
    return -(-steps // levels)


def eg_barriers(kind: str, counts: dict, levels: int,
                sequential: bool) -> int:
    """Block barriers the code passes for ``counts`` (``eg_counts``) at
    ``levels`` levels a bisection barrier (csrc/eg_pdhg.cu,
    csrc/eg_relaxed.cu): each bisection of n steps ceil(n / levels)."""
    def rounds(steps):
        return _rounds(steps, levels)

    if kind == "pdhg":
        return (7 + 47 * counts["cycles"]
                + rounds(PROJ_STEPS) * counts["projections"]
                + rounds(DUAL_STEPS) * counts["dual_projections"]
                + rounds(FILL_STEPS) * counts["fills"])
    n = counts["steps"]
    # The sequential structure reduces the logsumexp's max each step.
    return (3 + 3 * n + (n if sequential else 0)
            + rounds(PROJ_STEPS) * counts["projections"])


def tree_rounds(kind: str, counts: dict, levels: int) -> int:
    """The barriers of ``eg_barriers`` that are bisection-tree rounds."""
    tree = _rounds(PROJ_STEPS, levels) * counts["projections"]
    if kind == "pdhg":
        tree += (_rounds(DUAL_STEPS, levels) * counts["dual_projections"]
                 + _rounds(FILL_STEPS, levels) * counts["fills"])
    return tree


def eg_work(kind: str, slots: int, counts: dict) -> dict:
    """Per-job state touched and operations done by one solve of ``slots``
    job slots that ran ``counts`` (``eg_counts``), one bisection step at a
    time, and the bound they give: inputs and outputs once over HBM, or
    the operations over the float32 peak."""
    if kind == "pdhg":
        c, inner = counts["cycles"], 40
        steps = c * (inner + 2)

        def total(k):
            return (steps * k["step"] + c * inner * k["acc"]
                    + 2 * c * k["move"]
                    + counts["dual_projections"] * (
                        DUAL_STEPS * k["dual_iter"] + k["dual"])
                    + (c + 1) * (k["proj"] + k["obj"])
                    + counts["projections"] * PROJ_STEPS * k["proj_iter"]
                    + c * k["cycle"]
                    + counts["fills"] * FILL_STEPS * k["fill_iter"]
                    + k["fill"])

        floats, ops = total(PDHG_FLOATS), total(PDHG_OPS)
        io = (10 * slots + slots + 8) * 4
    else:
        def total(k):
            return (counts["steps"] * k["step"] + counts["projections"]
                    * PROJ_STEPS * k["proj_iter"])

        floats, ops = total(RELAXED_FLOATS), total(RELAXED_OPS)
        io = (9 * slots + slots + 2) * 4
    state_bytes = 4.0 * floats * slots
    t_io, t_ops = io / HBM_BYTES, ops * slots / F32_PEAK
    return dict(state_bytes=state_bytes,
                state_hbm_ms=1e3 * state_bytes / HBM_BYTES,
                bound_ms=1e3 * max(t_io, t_ops),
                bound_by="operations" if t_ops >= t_io else "bytes")


def barrier_us(device, values: int, warps: int = 32,
               iters: int = PROBE_ITERS) -> float:
    """us per block barrier of ``iters`` empty fused reductions of
    ``values`` values among ``warps`` warps of a 1024-thread block (kernel
    A's library's probe; CUDA events after a warm-up)."""
    from shockwave_tpu_torch.ops import _build

    lib = _build.library("eg_pdhg")
    out = torch.empty(1, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.eg_barrier_probe(out.data_ptr(), values, warps, 100,
                                      stream), "eg_barrier_probe")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _build.check(lib.eg_barrier_probe(out.data_ptr(), values, warps, iters,
                                      stream), "eg_barrier_probe")
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / iters


def active_warps(slots: int) -> int:
    """Warps of a 1024-thread block that own slots (eg::active_warps): the
    warps a non-sequential instantiation's reductions run on."""
    return min(32, -(-slots // 32))


def floor_ms(kind: str, counts: dict, barriers: int, levels: int,
             probe: dict, warps: int) -> float:
    """The barriers' own time: each tree round at the probe's time for
    2^levels - 1 values, every other barrier at its time for one, both
    among ``warps`` warps (``probe`` maps (values, warps) to us)."""
    tree = tree_rounds(kind, counts, levels) if levels > 1 else 0
    return 1e-3 * ((barriers - tree) * probe[(1, warps)]
                   + tree * probe[((1 << levels) - 1, warps)])


def _event_ms(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_eg_kernels(device, bands=EG_TIME_BANDS) -> list:
    """Kernels A and B on a seeded problem of each band, the wrapper's
    instantiation and the sequential one (one bisection step a barrier,
    state in global memory) timed in turns: each one's ms (CUDA events
    around each launch, median of EG_ITERS after a warm-up), block
    barriers and barrier floor (barriers at the probe's us each), whether
    the two agree in every bit, the plain version's ms (host clock, one
    run, up to EG_PLAIN_MAX_JOBS jobs), and the bounds: the contract's
    (inputs and outputs once over HBM, or the operations over the float32
    peak) and the per-job state each pass touches, over HBM and over the
    measured L2-resident rate."""
    from shockwave_tpu_torch.ops.eg_pdhg import SEQUENTIAL
    from shockwave_tpu_torch.solver.eg_level import num_slots_for

    l2 = l2_rate(device)
    # The probe at each (values, warps) a timed solve reduces over: the
    # sequential instantiation over all 32 warps, the wrapper's over the
    # warps that own slots.
    needs = {(1, 32)}
    for jobs in bands:
        slots = num_slots_for(jobs)
        for kind in ("pdhg", "relaxed"):
            levels = instantiation(kind, slots)[0]
            needs |= {(1, active_warps(slots)),
                      ((1 << levels) - 1, active_warps(slots))}
    probe = {need: barrier_us(device, *need) for need in sorted(needs)}
    print("  barrier probe (us per empty fused reduction of N values among "
          "W warps): " + ", ".join(f"N={v} W={w}: {us:.4f}" for (v, w), us
                                   in sorted(probe.items())), flush=True)
    rows = []
    for jobs in bands:
        problem = seeded_problem(jobs)
        for kind in ("pdhg", "relaxed"):
            packed = eg_pack(kind, problem, device)
            slots = packed.shape[2]
            variant = instantiation(kind, slots)
            runs = {}
            for name, v in (("after", variant), ("before", SEQUENTIAL)):
                stats = torch.zeros((1, 4), dtype=torch.int64, device=device)
                out = eg_solve(kind, packed, stats, v)
                runs[name] = dict(out=out, stats=stats[0].cpu().numpy(),
                                  times=[])
            for it in range(EG_ITERS):
                order = (("after", variant), ("before", SEQUENTIAL))
                for name, v in order if it % 2 == 0 else order[::-1]:
                    runs[name]["times"].append(_event_ms(
                        lambda: eg_solve(kind, packed, variant=v)))
            row = dict(kernel=kind, jobs=jobs, slots=slots,
                       levels=variant[0], resident=variant[1],
                       identical=same_bits(runs["after"]["out"],
                                           runs["before"]["out"]))
            for name, levels in (("after", variant[0]), ("before", 1)):
                r = runs[name]
                counts = eg_counts(kind, slots, r["out"].cpu().numpy(),
                                   r["stats"])
                n_bar = int(r["stats"][0])
                suffix = "" if name == "after" else "_before"
                row["ms" + suffix] = statistics.median(r["times"])
                row["barriers" + suffix] = n_bar
                row["barriers_formula" + suffix] = eg_barriers(
                    kind, counts, levels, name == "before")
                row["floor_ms" + suffix] = floor_ms(
                    kind, counts, n_bar, levels, probe,
                    active_warps(slots) if name == "after" else 32)
                row["us_per_barrier" + suffix] = 1e3 * row["ms" + suffix] / n_bar
                if name == "after":
                    row.update(counts)
                    row.update(eg_work(kind, slots, counts))
            row["state_l2_ms"] = 1e3 * row["state_bytes"] / l2
            row["plain_ms"] = None
            if jobs <= EG_PLAIN_MAX_JOBS:
                torch.cuda.synchronize()
                start_s = time.perf_counter()
                eg_plain(kind, packed)
                torch.cuda.synchronize()
                row["plain_ms"] = 1e3 * (time.perf_counter() - start_s)
            row["l2_rate"] = l2
            row["probe_us"] = {f"{v}x{w}": us
                               for (v, w), us in probe.items()}
            rows.append(row)
            print("  " + describe_eg(row), flush=True)
    return rows


def ptxas_usage(path) -> dict:
    """Registers, stack, spill bytes and shared memory of each kernel of
    the library, by its instantiation's name (``pdhg_kernel<1, true>``),
    from nvcc's ``-Xptxas -v`` report kept beside it."""
    text = path.with_suffix(".log").read_text()
    usage = {}
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores.*?Used (\d+) registers(.*?)\n", text,
            re.S):
        k = re.search(r"(pdhg_kernel|relaxed_kernel|barrier_probe)ILi(\d+)E"
                      r"(?:Lb([01])E)?", m.group(1))
        if k is None:
            continue
        name = k.group(1) + "<" + k.group(2) + (
            "" if k.group(3) is None else
            ", " + ("true" if k.group(3) == "1" else "false")) + ">"
        smem = re.search(r"(\d+) bytes smem", m.group(5))
        usage[name] = {"REG": int(m.group(4)), "STACK": int(m.group(2)),
                       "SPILL": int(m.group(3)),
                       "SMEM": int(smem.group(1)) if smem else 0}
    return usage


def sweep_levels(device, bands=EG_SWEEP_BANDS) -> list:
    """Every instantiation of kernels A and B (built together first, with
    the build's time and each one's registers and spills printed) on a
    seeded problem of each band (resident ones where the state fits):
    median ms of EG_ITERS in turns, and whether each agrees with the
    sequential one in every bit. The data the wrapper's levels per band
    are chosen from."""
    from shockwave_tpu_torch.ops import _build, eg_pdhg, eg_relaxed
    from shockwave_tpu_torch.ops.eg_pdhg import MAX_SHARED, STATIC_SHARED

    start = time.perf_counter()
    libs = _build.build_all(["eg_pdhg", "eg_relaxed"], _build.ALL_LEVELS)
    print(f"  every instantiation built in "
          f"{time.perf_counter() - start:.1f} s (one nvcc a source, "
          f"together)", flush=True)
    for name, path in libs.items():
        for kernel, u in ptxas_usage(path).items():
            print(f"  {kernel}: {u['REG']} registers, {u['STACK']} B stack, "
                  f"{u['SPILL']} B spill stores (ptxas -v)", flush=True)
    rows = []
    for jobs in bands:
        problem = seeded_problem(jobs)
        for kind, module in (("pdhg", eg_pdhg), ("relaxed", eg_relaxed)):
            packed = eg_pack(kind, problem, device)
            slots = packed.shape[2]
            fits = (4 * module.STATE_ROWS * slots + STATIC_SHARED
                    <= MAX_SHARED)
            variants = [(L, r) for r in ((False, True) if fits else (False,))
                        for L in range(1, 6)]
            ref = eg_solve(kind, packed, variant=eg_pdhg.SEQUENTIAL)
            times = {v: [] for v in variants}
            same = {v: same_bits(eg_solve(kind, packed, variant=v), ref)
                    for v in variants}
            for it in range(EG_ITERS):
                for v in variants if it % 2 == 0 else variants[::-1]:
                    times[v].append(_event_ms(
                        lambda: eg_solve(kind, packed, variant=v)))
            for v in variants:
                rows.append(dict(kernel=kind, jobs=jobs, slots=slots,
                                 levels=v[0], resident=v[1],
                                 ms=statistics.median(times[v]),
                                 identical=same[v]))
                print(f"  {kind} {jobs} jobs, {v[0]} levels, "
                      f"{'resident' if v[1] else 'global'}: "
                      f"{rows[-1]['ms']:.4f} ms, "
                      f"{'same bits' if same[v] else 'DIFFERENT BITS'}",
                      flush=True)
    return rows


def describe_eg(row: dict) -> str:
    what = (f"{row['cycles']} cycles, {row['dual_projections']} dual, "
            f"{row['projections']} budget and {row['fills']} fill "
            f"bisections" if row["kernel"] == "pdhg"
            else f"{row['steps']} steps, {row['projections']} projections "
            f"bisected")
    plain = ("not timed above {} jobs".format(EG_PLAIN_MAX_JOBS)
             if row["plain_ms"] is None else f"{row['plain_ms']:.1f} ms")
    where = "shared" if row["resident"] else "global"
    return (f"{row['kernel']} {row['jobs']} jobs ({row['levels']} levels, "
            f"state in {where} memory): {row['ms']:.4f} ms against "
            f"{row['ms_before']:.4f} sequential, "
            f"{'same bits' if row['identical'] else 'DIFFERENT BITS'}; "
            f"{what}; {row['barriers']} barriers against "
            f"{row['barriers_before']} ({row['us_per_barrier']:.3f} against "
            f"{row['us_per_barrier_before']:.3f} us each); floor "
            f"{row['floor_ms']:.4f} against {row['floor_ms_before']:.4f} ms; "
            f"bound "
            f"{row['bound_ms']:.5f} ms by {row['bound_by']}; state "
            f"{row['state_bytes'] / 1e6:.2f} MB: {row['state_hbm_ms']:.4f} "
            f"ms at HBM, {row['state_l2_ms']:.4f} ms at L2 "
            f"({row['l2_rate'] / 1e12:.2f} TB/s measured); plain "
            f"{plain}")


def describe(row: dict) -> str:
    if "busy_ms" not in row:
        busy = "not on a card"
    elif row["busy_ms"] is None:
        busy = "profiler saw no device activity"
    else:
        busy = (f"{row['launches']} kernel launches and {row['copies']} "
                f"copies, device busy {row['busy_ms']:.3f} ms")
    return (f"{row['jobs']} jobs x {row['num_gpus']} GPUs x "
            f"{row['future_rounds']} rounds: level solve "
            f"{row['device_ms']:.3f} ms device head + "
            f"{row['host_tail_ms']:.3f} ms host tail = "
            f"{row['level_ms']:.3f} ms ({busy}); native greedy "
            f"{row['native_ms']:.3f} ms")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--first-order", action="store_true",
                        help="check and time kernels A and B (a card only)")
    parser.add_argument("--levels", action="store_true",
                        help="with --first-order, time every instantiation "
                             "of kernels A and B per band instead")
    args = parser.parse_args(argv)
    from shockwave_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    if args.first_order:
        if device.type != "cuda":
            raise SystemExit("--first-order times kernels: it needs a card")
        if args.levels:
            out = dict(card=card, levels=sweep_levels(device))
            print(json.dumps(out))
            return out
        bad, max_err = check_eg_kernels(
            [seeded_problem(jobs) for jobs in EG_CHECK_BANDS], device)
        if bad:
            raise SystemExit("first-order kernels: " + "; ".join(bad))
        out = dict(card=card, max_abs_err=max_err,
                   timings=time_eg_kernels(device))
        print(json.dumps(out))
        return out
    problems = []
    run_trace(TRACE_2048, "shockwave_tpu", 256, device, capture=problems)
    bad, report = solve_report(device, problems)
    if bad:
        raise SystemExit(f"level solve on {device} misses the CPU's: "
                         + "; ".join(bad))
    out = dict(card=card, device=str(device), **report)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
