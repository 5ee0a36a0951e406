"""Drive, check and time the port's simulation path.

    python -m shockwave_tpu_torch.tools.bench_sim            # on the card
    python -m shockwave_tpu_torch.tools.bench_sim --device cpu
    python -m shockwave_tpu_torch.tools.bench_sim --first-order  # card only
    python -m shockwave_tpu_torch.tools.bench_sim --first-order --levels
    python -m shockwave_tpu_torch.tools.bench_sim --milp-baseline

``chip_smoke.py`` and the tests use the helpers here: the trace runs and
the constants they are held to (``run_trace``, ``check_run``, ``GOLDEN``,
``TIER_2048``; the cells market: ``GOLDEN_CELLS``, ``TIER_2048_CELLS``,
``TIER_2048_CELLS_H100``;
Gavel's policies: ``GOLDEN_GAVEL``, ``FIGURE9``,
``HETERO``, ``TIER_2048_MMF``), the seeded planning problems (``seeded_problem`` for
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
are chosen from. With ``--milp-baseline`` it times the exact MILP on the
host (the reference's formulation, scipy's HiGHS) at bench.py's stress
shape (1000 jobs x 256 GPUs x 50 rounds, seed 0) with a 120 s and a 15 s
time limit against the card's production solve (level) and kernel A on
the stress seeds, and prints the ratios of wall seconds and the
objective gaps beside the card's name and power limit and the host's CPU
(``milp_baseline``; ``milp_window`` is chip_smoke.py's smaller check).
The policy library's pins (``GOLDEN_LIBRARY``, ``ALLOX_SINGLE``,
``GOLDEN_SLO``, ``PACKED_220``; ``library_runs``) are the JAX package's
runs of the rest of Gavel's library and of the MILP.
"""

from __future__ import annotations

import argparse
import contextlib
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
# Its first 250 rounds, which chip_smoke.py phase 8 runs
# (run_trace(..., max_rounds=TIER_2048_CUT["rounds"])): the JAX package on
# the CPU (tests/tier_cut_reference.py --policy shockwave_tpu; 191 native
# and 39 level solves, 1070 jobs completed, the metrics over those). The
# port on the CPU gives the same digits.
TIER_2048_CUT = dict(makespan=29879.815, avg_jct=2586.795, worst_ftf=0.867,
                     rounds=250)
# The same run under shockwave_tpu_pdhg (the JAX package on the CPU, 424
# PDHG solves; the port's plain PDHG on the CPU gives the same digits).
TIER_2048_PDHG = dict(makespan=58678.337, avg_jct=13412.053, worst_ftf=1.399,
                      rounds=489)
# Its first 80 rounds (run_trace(..., max_rounds=80)), which chip_smoke.py
# phase 9 runs: the JAX package on the CPU (tests/tier_cut_reference.py;
# 60 PDHG solves, 279 jobs completed; the metrics cover those jobs). The
# port's plain PDHG on the CPU gives the same digits. Its 8 windows still
# reach 328 jobs and the greedy's 16-grant steps. (The earlier cut, its
# first 160 rounds: 19079.815 / 2589.265 / 0.727, 140 solves.)
TIER_2048_PDHG_CUT = dict(makespan=9479.815, avg_jct=2794.657,
                          worst_ftf=1.51, rounds=80)
# The JAX package's run of the 12-job trace on 8 GPUs, 120 s rounds, under
# shockwave_tpu_pdhg with --cells 2 (its scripts/simulate.py on the CPU):
# 16 coordinated replans, each one batched solve of the stale cells.
GOLDEN_CELLS = dict(makespan=10816.712, avg_jct=4949.683, worst_ftf=1.241,
                    rounds=91)
# The 2048-job trace on 256 GPUs, 120 s rounds, under shockwave_tpu_pdhg
# with --cells 4 (the JAX package's scripts/simulate.py on the CPU): the
# reference's own churn configuration of four cells at 256 GPUs
# (scripts/ci/cells_smoke.py:63-71).
TIER_2048_CELLS = dict(makespan=57838.503, avg_jct=14939.915,
                       worst_ftf=1.812, rounds=482)
# The same command on an H100 (kernel A's lanes; chip_smoke.py phase 12,
# NVIDIA H100 80GB HBM3, 700.00 W). Kernel A is bitwise repeatable, so a
# card run gives these digits again. They differ from TIER_2048_CELLS, as
# the port's plain version on the CPU (58018.422 / 15009.305 / 1.812 in
# 484 rounds) does: both follow the JAX package's decisions through round
# 292 and leave them at round 293, after lanes that sit on degenerate
# optima (the objective equal in float32, s apart by up to 3.6: the
# welfare fill's `delta > 0` decided by the last bits of float32 sums,
# which XLA forms in its own order and with fused multiply-adds), where a
# capacity move goes the other way.
TIER_2048_CELLS_H100 = dict(makespan=57298.422, avg_jct=14989.403,
                            worst_ftf=1.812, rounds=478)
# The cells tier's command line (chip_smoke.py phase 12; the JAX package's
# scripts/simulate.py takes the same).
TIER_2048_CELLS_ARGS = ["-t", str(TRACE_2048), "-p", "shockwave_tpu_pdhg",
                        "-c", "v100=256", "--time_per_iteration", "120",
                        "--cells", "4"]
# Its first 260 rounds, which chip_smoke.py phase 12 runs (the CLI's
# --max_rounds; round 253 holds the most incomplete jobs of the whole
# run, the state phases 12 and 15 take): the JAX package's
# scripts/simulate.py on the CPU (tests/tier_cut_reference.py --cells;
# 1022 jobs completed, the metrics over those). Both follow the JAX
# package's decisions up to round 292, so the card's cut is held to it.
TIER_2048_CELLS_CUT = dict(makespan=31079.981, avg_jct=2985.279,
                           worst_ftf=1.042, rounds=260)
# The JAX package's golden metrics of Gavel's baselines on the 12-job
# trace (tests/test_golden.py:23-27).
GOLDEN_GAVEL = {
    "fifo": dict(makespan=12376.656, avg_jct=5691.573, worst_ftf=3.416),
    "max_min_fairness": dict(makespan=12976.601, avg_jct=5178.854,
                             worst_ftf=2.116),
}
TRACE_220 = TRACES / "generated_220_dynamic.trace"
# Figure 9: the JAX package's runs of the 220-job trace on (policy, GPUs)
# v100s, 4 a server, 120 s rounds, as its
# scripts/replicate/scale_experiments.py::run_cell drives them (the
# Shockwave runs with that script's planner config), on the CPU.
FIGURE9 = {
    ("max_min_fairness", 64): dict(makespan=29110.469, avg_jct=10463.705,
                                   worst_ftf=3.985, rounds=243),
    ("shockwave_tpu", 64): dict(makespan=24437.287, avg_jct=9272.551,
                                worst_ftf=1.401, rounds=205),
    ("finish_time_fairness", 64): dict(makespan=27022.987, avg_jct=13115.244,
                                       worst_ftf=5.3, rounds=226),
    ("max_min_fairness_water_filling", 64): dict(
        makespan=29110.469, avg_jct=10464.253, worst_ftf=3.985, rounds=243),
    ("max_min_fairness", 128): dict(makespan=21070.528, avg_jct=5796.349,
                                    worst_ftf=3.048, rounds=176),
    ("shockwave_tpu", 128): dict(makespan=19870.545, avg_jct=4903.215,
                                 worst_ftf=1.121, rounds=166),
    ("max_min_fairness", 256): dict(makespan=19870.528, avg_jct=5199.637,
                                    worst_ftf=4.329, rounds=166),
    ("shockwave_tpu", 256): dict(makespan=18430.545, avg_jct=4280.201,
                                 worst_ftf=1.412, rounds=154),
}
# The same trace on a heterogeneous cluster, 4 GPUs a server.
HETERO_CLUSTER = {"v100": 16, "p100": 16, "k80": 16}
HETERO = {
    "fifo": dict(makespan=107799.769, avg_jct=28028.425, worst_ftf=11.21,
                 rounds=899),
    "fifo_perf": dict(makespan=66580.632, avg_jct=27019.349,
                      worst_ftf=12.326, rounds=555),
    "max_min_fairness": dict(makespan=57822.204, avg_jct=24280.867,
                             worst_ftf=7.299, rounds=482),
    "max_min_fairness_perf": dict(makespan=53733.008, avg_jct=23722.098,
                                  worst_ftf=6.995, rounds=448),
    "finish_time_fairness_perf": dict(makespan=52710.731, avg_jct=23598.975,
                                      worst_ftf=7.356, rounds=440),
    "max_sum_throughput_perf": dict(makespan=55834.224, avg_jct=23639.123,
                                    worst_ftf=8.725, rounds=466),
    "min_total_duration_perf": dict(makespan=49982.105, avg_jct=45535.770,
                                    worst_ftf=15.822, rounds=421),
}
# The 2048-job trace on 256 GPUs, 1 a server, 120 s rounds, under
# max_min_fairness (the JAX package on the CPU): the Gavel side of
# TIER_2048.
TIER_2048_MMF = dict(makespan=63420.983, avg_jct=13266.974, worst_ftf=2.28,
                     rounds=529)
# The JAX package's runs of the 12-job trace on 8 GPUs under the rest of
# its policy library (tests/gavel_reference.py, scipy 1.17.0, on the
# CPU): the packed policies with the scheduler's pair throughputs,
# Gandiva, the cost-normalized throughput sums, and ``shockwave``, the
# exact MILP, whose 32 HiGHS calls there each end optimal within the gap
# (so the program, not the wall clock, decides the run). The trace's SLO
# column is -1: the SLO policy has no deadline here (GOLDEN_SLO has).
GOLDEN_LIBRARY = {
    "gandiva": dict(makespan=13482.807, avg_jct=4954.756,
                    worst_ftf=2.28, rounds=113),
    "fifo_packed": dict(makespan=12376.656, avg_jct=5611.989,
                        worst_ftf=3.416, rounds=104),
    "max_min_fairness_packed": dict(makespan=12776.850, avg_jct=5046.776,
                                    worst_ftf=1.964, rounds=107),
    "finish_time_fairness_packed": dict(makespan=13148.475,
                                        avg_jct=5104.543, worst_ftf=1.766,
                                        rounds=110),
    "min_total_duration_packed": dict(makespan=12558.162, avg_jct=5114.030,
                                      worst_ftf=2.279, rounds=105),
    "max_min_fairness_water_filling_packed": dict(
        makespan=12776.962, avg_jct=4884.123, worst_ftf=1.964, rounds=107),
    "max_sum_throughput_normalized_by_cost_perf": dict(
        makespan=13576.547, avg_jct=5146.140, worst_ftf=2.499, rounds=114),
    "max_sum_throughput_normalized_by_cost_perf_SLOs": dict(
        makespan=13576.547, avg_jct=5146.140, worst_ftf=2.499, rounds=114),
    "max_sum_throughput_normalized_by_cost_packed_SLOs": dict(
        makespan=15173.386, avg_jct=5419.092, worst_ftf=1.917, rounds=128),
    "shockwave": dict(makespan=13456.400, avg_jct=5942.317, worst_ftf=4.304,
                      rounds=113),
}
# AlloX takes single-GPU jobs only (the JAX package raises on the golden
# trace): its run of the trace's 8 single-GPU jobs on the 8 GPUs.
ALLOX_SINGLE = dict(makespan=12376.330, avg_jct=4440.035, worst_ftf=2.355,
                    rounds=104)
# The SLO programs on the golden trace with every job's SLO at
# SLO_FACTOR x its isolated duration, with the deadlines they miss.
SLO_FACTOR = 1.2
GOLDEN_SLO = {
    "max_sum_throughput_normalized_by_cost_perf_SLOs": dict(
        makespan=12616.675, avg_jct=5255.235, worst_ftf=2.991, rounds=106,
        slo_violations=6),
    "max_sum_throughput_normalized_by_cost_packed_SLOs": dict(
        makespan=12634.517, avg_jct=5391.185, worst_ftf=2.226, rounds=106,
        slo_violations=8),
}
# The 220-job trace on 64 v100s, 4 a server (as FIGURE9 drives it), under
# two policies that pair jobs.
PACKED_220 = {
    "gandiva": dict(makespan=29004.181, avg_jct=9810.374, worst_ftf=3.915,
                    rounds=242),
    "max_min_fairness_packed": dict(makespan=29802.212, avg_jct=10025.923,
                                    worst_ftf=3.156, rounds=249),
}
# scipy's HiGHS returns one vertex of a degenerate LP (max-min with every
# throughput 1 has many optima), and the HiGHS of another scipy may
# return another, which both packages then follow. The Gavel pins above
# are the JAX package's runs under scipy 1.17.0. SCIPY_PINS holds, for
# another scipy version, the cells whose JAX-package run under that
# version differs (tests/gavel_reference.py on a host that has it), with
# their metrics there.
SCIPY_PINS = {
    # Under scipy 1.18.1 (the H100 host's) the throughput-agnostic max-min
    # LP on the three-type cluster takes another vertex in some round, and
    # the MILP's HiGHS stops at another plan within its gap (its 32 calls
    # all optimal within the gap there too).
    "1.18.1": {("HETERO", "max_min_fairness"): dict(
        makespan=59072.568, avg_jct=24121.340, worst_ftf=6.633, rounds=493),
        ("GOLDEN_LIBRARY", "shockwave"): dict(
        makespan=13456.412, avg_jct=5647.776, worst_ftf=2.029, rounds=113)},
}
TRACE_120 = TRACES / "generated_120_dynamic.trace"
# The rest of the Shockwave planner: the JAX package's runs on the CPU
# (tests/planner_reference.py, each driven as run_trace drives the
# port's; none calls HiGHS, so they hold under any scipy). Checkpoints:
# the 220-job trace on 64 v100s, 4 a server, under shockwave_tpu_pdhg,
# unbroken, saving once 110 jobs were admitted, and resumed from that
# file. Speculation: the same trace under shockwave_tpu --speculate, and
# the golden trace under shockwave_tpu_pdhg --cells 2 --speculate, with
# their hit / repair / miss counts. Pool sets: the JAX package's own A/B
# (scripts/analysis/hetero_pools_ab.py:52-63, the 120-job trace on
# v100:8 p100:4 k80:4 under shockwave_tpu) and the 220-job trace on
# HETERO_CLUSTER under shockwave_tpu_pdhg, both with hetero_pools. The
# greedy fallback: the golden trace under shockwave_tpu_level with the
# native greedy unavailable, on 5 GPUs: on 8 the placement never drops a
# grant, so the fallback is never reached; on 5 it runs 3 times.
PLANNER = {
    "checkpoint_unbroken": dict(makespan=23999.914, avg_jct=9403.489,
                                worst_ftf=1.420, rounds=200),
    "checkpoint_save": dict(makespan=23999.914, avg_jct=9403.489,
                            worst_ftf=1.420, rounds=200),
    "checkpoint_resume": dict(makespan=23999.914, avg_jct=9403.489,
                              worst_ftf=1.420, rounds=200),
    "speculate_220": dict(makespan=24437.287, avg_jct=9272.551,
                          worst_ftf=1.401, rounds=205,
                          spec_stats={"hit": 93, "repair": 0, "miss": 4}),
    "speculate_golden_cells": dict(
        makespan=10816.712, avg_jct=4949.683, worst_ftf=1.241, rounds=91,
        spec_stats={"hit": 75, "repair": 1, "miss": 5}),
    # The committed reading of the JAX package's A/B
    # (results/hetero/shockwave_pools.json: 68484.917 / 38284.849 / 3.080
    # in 571 rounds) is not what the JAX package gives now on the CPU;
    # this is.
    "pools_120": dict(makespan=68355.028, avg_jct=38896.749,
                      worst_ftf=3.164, rounds=571),
    "pools_220_pdhg": dict(makespan=63114.063, avg_jct=33396.615,
                           worst_ftf=5.716, rounds=526),
    "greedy_fallback_golden": dict(makespan=12976.735, avg_jct=7873.211,
                                   worst_ftf=1.541, rounds=109),
}
# The pipelining smoke trace (data/generate.py::smoke_trace_jobs: 6 jobs,
# 2 epochs; scripts/ci/pipelining_smoke.py's) on 4 v100s, 6 future
# rounds, lambda 2, k 1e-3, under (policy, seconds between arrivals) with
# --speculate: the JAX package's makespan and hit / repair / miss counts
# on the CPU. With every job at t0 the serial run's makespan is the same.
SPECULATE_SMOKE = {
    ("shockwave_tpu", 0.0): dict(
        makespan=328.040, spec_stats={"hit": 3, "repair": 0, "miss": 0}),
    ("shockwave_tpu_pdhg", 0.0): dict(
        makespan=328.040, spec_stats={"hit": 3, "repair": 0, "miss": 0}),
    ("shockwave_tpu", 60.0): dict(
        makespan=879.048, spec_stats={"hit": 4, "repair": 1, "miss": 3}),
}
# The simulator's remaining features (tests/sim_features_reference.py
# captures the JAX package's runs on the CPU; sim_feature_runs lists them).
# Churn: the 220-job trace on 64 v100s, 4 a server, under
# shockwave_tpu_pdhg (kernel A) and max_min_fairness, with the seeded
# churn plan of CHURN_PLAN (horizon: the unbroken pdhg run's makespan,
# PLANNER["checkpoint_unbroken"]; two solver faults, since each
# solver_slowdown sleeps 0.05 x the round, and two scheduler kills).
CHURN_PLAN = dict(seed=0, horizon_s=24000.0, num_workers=64,
                  target_events=200, solver_faults=2, scheduler_faults=2)
CHURN_POLICIES = ("shockwave_tpu_pdhg", "max_min_fairness")
# Online estimation: the JAX package's estimator sweep
# (results/estimator_sweep.json: the golden trace on 8 v100s under
# max_min_fairness_packed, profiling percentage x reference models) and
# the 220-job trace on 64 v100s at p = 0.5, r = 8.
ESTIMATOR_SWEEP = tuple((p, r) for p in (0.2, 0.5, 0.8) for r in (4, 8))
# Pricing: the committed decision log's round 91 with tests/test_whatif.py's
# CLI burst, and the --cells 4 tier's state at its most incomplete jobs
# (chip_smoke.py phase 12's snapshot) with a burst of 8 CLI-default jobs
# and a batch of PRICING_BATCH bursts (pricing_bursts).
PRICING_LOG_ROUND = 91
PRICING_LOG_BURST = dict(jobs=4, scale=2, duration=4000.0)
PRICING_TIER_BURST = dict(jobs=8)
PRICING_BATCH = 16
# The pins (tests/sim_features_reference.py; results/sim_features/
# jax_reference.json.gz is the JAX package's capture). The churn cells
# are the JAX package's runs, which the port's CPU run equals in every
# printed digit. The estimation cells are the port's own CPU runs: its
# ALS starts from a torch.Generator seeded 0, not from PRNGKey(0)
# normals, and some cosine matches are near-ties that float32 noise
# flips (ROADMAP.md, queue 3); results/estimator_sweep.json holds the JAX
# package's. Each is held within TOLERANCE in its rounds, with its
# counts equal and its worker ids, matches and (on the host's policies)
# round log equal to the digest.
SIM_FEATURES = {
    "churn_shockwave_tpu_pdhg": dict(
        makespan=29710.566, avg_jct=9557.801, worst_ftf=4.270,
        rounds=248),
    "churn_max_min_fairness": dict(
        makespan=29830.484, avg_jct=10969.328, worst_ftf=4.185,
        rounds=249),
    "estimate_p0.2_r4": dict(
        makespan=12930.392, avg_jct=5353.732, worst_ftf=2.051,
        rounds=108),
    "estimate_p0.2_r8": dict(
        makespan=12674.896, avg_jct=5289.625, worst_ftf=2.022,
        rounds=106),
    "estimate_p0.5_r4": dict(
        makespan=12777.227, avg_jct=4842.360, worst_ftf=1.903,
        rounds=107),
    "estimate_p0.5_r8": dict(
        makespan=12780.604, avg_jct=5315.948, worst_ftf=2.087,
        rounds=107),
    "estimate_p0.8_r4": dict(
        makespan=12812.611, avg_jct=4817.519, worst_ftf=1.959,
        rounds=107),
    "estimate_p0.8_r8": dict(
        makespan=12638.946, avg_jct=4819.454, worst_ftf=2.109,
        rounds=106),
    "estimate_220": dict(
        makespan=30458.104, avg_jct=10206.728, worst_ftf=2.985,
        rounds=254),
}
SIM_FEATURE_COUNTS = {
    "churn_shockwave_tpu_pdhg": dict(
        admitted=220, lost_jobs=[190], dropped_jobs=[],
        faults=dict(planned_events=200, applied=200, recovered=200,
                    unrecovered=[], pending_cluster=0,
                    pending_solver=0, pending_rpc=0)),
    "churn_max_min_fairness": dict(
        admitted=220, lost_jobs=[], dropped_jobs=[190],
        faults=dict(planned_events=200, applied=198, recovered=198,
                    unrecovered=[], pending_cluster=0,
                    pending_solver=2, pending_rpc=0)),
    "estimate_p0.2_r4": dict(
        admitted=12, lost_jobs=[], dropped_jobs=[2],
        faults=None),
    "estimate_p0.2_r8": dict(
        admitted=12, lost_jobs=[], dropped_jobs=[2],
        faults=None),
    "estimate_p0.5_r4": dict(
        admitted=12, lost_jobs=[], dropped_jobs=[],
        faults=None),
    "estimate_p0.5_r8": dict(
        admitted=12, lost_jobs=[], dropped_jobs=[2],
        faults=None),
    "estimate_p0.8_r4": dict(
        admitted=12, lost_jobs=[], dropped_jobs=[],
        faults=None),
    "estimate_p0.8_r8": dict(
        admitted=12, lost_jobs=[], dropped_jobs=[],
        faults=None),
    "estimate_220": dict(
        admitted=220, lost_jobs=[], dropped_jobs=[],
        faults=None),
}
SIM_FEATURE_DIGESTS = {
    "churn_shockwave_tpu_pdhg": dict(
        worker_ids="95f916ca36688d17", matches=None,
        round_log=None),
    "churn_max_min_fairness": dict(
        worker_ids="95f916ca36688d17", matches=None,
        round_log="8b2c550b7ca2e405"),
    "estimate_p0.2_r4": dict(
        worker_ids="809d533fc370950a", matches="f3bc323d22b1f8df",
        round_log="cc0417def753e028"),
    "estimate_p0.2_r8": dict(
        worker_ids="809d533fc370950a", matches="2e6ab3ad95bbff9d",
        round_log="9488e3cd6ad2894d"),
    "estimate_p0.5_r4": dict(
        worker_ids="809d533fc370950a", matches="1255b4dbe4e294a6",
        round_log="8558b990543f6e7a"),
    "estimate_p0.5_r8": dict(
        worker_ids="809d533fc370950a", matches="e933470dd16ba2b2",
        round_log="84caa852b4ebf4c4"),
    "estimate_p0.8_r4": dict(
        worker_ids="809d533fc370950a", matches="557915fe3061172e",
        round_log="ba7617863091b377"),
    "estimate_p0.8_r8": dict(
        worker_ids="809d533fc370950a", matches="41c5ae76c4e36d5d",
        round_log="400cd5e849d7f2c2"),
    "estimate_220": dict(
        worker_ids="ccf91e2b960f5146", matches="e0dbbeb6e9f33a5a",
        round_log="4fe990734d612624"),
}
# The card's own runs of the estimation cells where its ALS (cuBLAS and
# cuSOLVER's summation orders) flips a near-tie match against the CPU's
# (chip_smoke.py phase 15 on an NVIDIA H100 80GB HBM3 at 700 W, which
# checks that every flip is a near-tie). Counts and worker ids are the
# CPU pins'.
SIM_FEATURES_H100 = {
    "estimate_p0.8_r8": (
        dict(makespan=12638.946, avg_jct=4819.454, worst_ftf=2.109,
             rounds=106),
        dict(matches="38ee20fcc1bb93bb")),
    "estimate_220": (
        dict(makespan=29606.397, avg_jct=10259.244, worst_ftf=2.985,
             rounds=247),
        dict(matches="87465485a2559c4b", round_log="96fee5c4c4e6f01b")),
}
# An ALS completion on the card against the CPU's from the same start
# may pick another reference type only where the two types' cosine
# distances lie within this of each other.
NEAR_TIE = 2e-5
# The flight-recorder fixture run (results/flight_recorder/README.md:
# the 12-job trace on 2 chips, 60 s rounds, seed 0, shockwave_tpu_level,
# every plane on) of the JAX package on the CPU today, from
# ``python tests/telemetry_reference.py capture``: its metrics, its
# calibration summary and market gauges, and the alerts of the watchdog
# rules whose inputs are deterministic ([rule, round, value, threshold]
# in firing order). The committed fixture predates the current
# calibration scoring (4044 forecasts scored there, MAPE 0.993) and the
# market plane (ROADMAP.md, queue 3).
TELEMETRY_FIXTURE = {
    "run": dict(makespan=24950.018, avg_jct=20161.220, worst_ftf=2.336,
                rounds=419),
    "calibration": {"scored": 2971.0, "mape": 1.157551913570325,
                    "coverage": 0.41635812857623694,
                    "bias_seconds": 181.62532841027942},
    "market": {"market_price": 0.0,
               "market_fairness_drift": 0.3283514043178429,
               "market_tenant_spend_total": 37.0},
    "alerts": [["price_spike", 20, 56852.443475, 0.0],
               ["fairness_drift", 22, 0.610976, 0.25],
               ["price_spike", 24, 61137.339877, 0.0],
               ["fairness_drift", 24, 0.723838, 0.25],
               ["price_spike", 35, 3228824.337565, 183412.01963],
               ["fairness_drift", 40, 0.886459, 0.25],
               ["price_spike", 60, 739481.671279, 0.0],
               ["fairness_drift", 99, 0.971666, 0.25],
               ["price_spike", 143, 131.386372, 0.0],
               ["worst_ftf", 224, 2.336237, 2.0],
               ["calibration_mape", 224, 0.756811, 0.5],
               ["calibration_mape", 379, 2.423919, 0.5],
               ["price_spike", 385, 2.427677, 0.0],
               ["price_spike", 387, 3.107596, 0.0]],
}
# The committed fixture's counters and gauges that are current (held
# equal on the card) and the families of planning wall time (compared by
# sample count).
TELEMETRY_HELD = (
    "scheduler_rounds_total", "scheduler_jobs_admitted_total",
    "scheduler_jobs_completed_total", "scheduler_preemptions_total",
    "scheduler_lease_extensions_total", "scheduler_queue_depth",
    "scheduler_round_duration_seconds", "scheduler_scheduled_jobs",
    "run_makespan_seconds", "run_avg_jct_seconds", "run_utilization",
    "run_worst_ftf", "run_unfair_fraction_pct")

# Metric families timed on the wall clock, or read from the watchdog's
# wall-clock rule (solver_time): compared by label set and sample count
# only. The rule's own alert series is left out of every comparison.
WALL_FAMILIES = frozenset((
    "shockwave_plan_exposed_seconds", "shockwave_plan_phase_seconds",
    "shockwave_solve_seconds", "solver_backend_phase_seconds",
    "solver_backend_seconds", "effective_planning_overhead",
    "shockwave_plan_hidden_seconds", "scheduler_health",
))
WALL_RULE = {"rule": "solver_time"}
# Watchdog rules whose inputs are deterministic; solver_time reads wall
# seconds and is reported, not held.
DETERMINISTIC_RULES = frozenset((
    "worst_ftf", "calibration_mape", "straggler", "lease_churn",
    "solver_degraded", "worker_death", "price_spike", "fairness_drift",
    "admission_backlog", "cell_failure",
))


def metric_differences(a: dict, b: dict, families=None) -> list:
    """Where two metrics snapshots differ: every deterministic series by
    value, count, sum, min, max and buckets (exact), the wall-clock
    families by label set and count. ``families`` restricts the check."""
    ma, mb = a["metrics"], b["metrics"]
    names = sorted(set(ma) | set(mb)) if families is None else families
    bad = []
    for name in names:
        if name not in ma or name not in mb:
            bad.append(f"{name}: only in one")
            continue
        sa = {json.dumps(s["labels"], sort_keys=True): s
              for s in ma[name]["series"] if s["labels"] != WALL_RULE}
        sb = {json.dumps(s["labels"], sort_keys=True): s
              for s in mb[name]["series"] if s["labels"] != WALL_RULE}
        if set(sa) != set(sb):
            bad.append(f"{name}: label sets {sorted(set(sa) ^ set(sb))}")
            continue
        for key, x in sa.items():
            y = sb[key]
            fields = (("count",) if name in WALL_FAMILIES else
                      ("value", "count", "sum", "min", "max", "buckets"))
            for f in fields:
                if x.get(f) != y.get(f):
                    bad.append(f"{name}{key} {f}: {x.get(f)} != {y.get(f)}")
    return bad


def health_alerts(trace_path, deterministic=True) -> list:
    """The watchdog's alerts in firing order, from a trace's ``health``
    instants (the deterministic rules', or every rule's names)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    alerts = [e["args"] for e in events if e.get("name") == "health"]
    if deterministic:
        return [a for a in alerts if a["rule"] in DETERMINISTIC_RULES]
    return [a["rule"] for a in alerts]


def fixture_pins(metrics_path, trace_path) -> dict:
    """A fixture run's readings in the form of ``TELEMETRY_FIXTURE``: its
    calibration summary, market gauges and deterministic alerts."""
    with open(metrics_path) as f:
        metrics = json.load(f)["metrics"]

    def value(name):
        return metrics[name]["series"][0]["value"]

    return {
        "calibration": {k: value(f"predictor_calibration_{k}") for k in (
            "scored", "mape", "coverage", "bias_seconds")},
        "market": {k: value(k) for k in (
            "market_price", "market_fairness_drift",
            "market_tenant_spend_total")},
        "alerts": [[a["rule"], a["round"], a["value"], a["threshold"]]
                   for a in health_alerts(trace_path)],
    }


# The JAX package's pricing decisions (PricingDecision.as_record): round
# PRICING_LOG_ROUND of the committed log with PRICING_LOG_BURST; the tier
# state at its most incomplete jobs (round 253, before the round 293 where
# the tier's summation orders part, so every package holds the same
# state) with PRICING_TIER_BURST and, as one batch, pricing_bursts.
PRICING = {
    "log": dict(action="accept", reason="priced",
                welfare_delta=1.4771e-05, burst_welfare=-0.172693882),
    "tier": dict(round=253, jobs=1053, num_jobs=1053),
    "tier_single": dict(action="accept", reason="priced",
                        welfare_delta=-0.00036844,
                        burst_welfare=-0.003660552),
    "tier_batch": [
        dict(action="accept", reason="priced",
             welfare_delta=-6.5392e-05, burst_welfare=-0.000446961),
        dict(action="accept", reason="priced",
             welfare_delta=-9.8424e-05, burst_welfare=-0.000958775),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000133281, burst_welfare=-0.001592853),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000196053, burst_welfare=-0.001837202),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000233796, burst_welfare=-0.002606656),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000275406, burst_welfare=-0.002865461),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000320146, burst_welfare=-0.003339884),
        dict(action="accept", reason="priced",
             welfare_delta=-0.00036844, burst_welfare=-0.003660552),
        dict(action="accept", reason="priced",
             welfare_delta=-4.8906e-05, burst_welfare=-0.000545606),
        dict(action="accept", reason="priced",
             welfare_delta=-9.8424e-05, burst_welfare=-0.001045627),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000166711, burst_welfare=-0.001338342),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000187755, burst_welfare=-0.001968355),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000233796, burst_welfare=-0.00248595),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000266617, burst_welfare=-0.00306182),
        dict(action="accept", reason="priced",
             welfare_delta=-0.000294809, burst_welfare=-0.003871302),
        dict(action="accept", reason="priced",
             welfare_delta=-0.00036844, burst_welfare=-0.003660552),
    ],
}
POOLS_120_CLUSTER = {"v100": 8, "p100": 4, "k80": 4}
CHECKPOINT_THRESHOLD = 110
GREEDY_FALLBACK_GPUS = 5
_GAVEL_PINS = {"GOLDEN_GAVEL": GOLDEN_GAVEL, "FIGURE9": FIGURE9,
               "HETERO": HETERO, "GOLDEN_LIBRARY": GOLDEN_LIBRARY,
               "GOLDEN_SLO": GOLDEN_SLO, "PACKED_220": PACKED_220}
# Tables of a single cell (their key is None).
_SINGLE_PINS = {"TIER_2048_MMF": TIER_2048_MMF, "ALLOX_SINGLE": ALLOX_SINGLE}
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
# The depth chip_smoke.py's phase 8(d) times at (its readings at the
# tool's depth above are PERF.md's): the medians of SMOKE_ITERS (the
# native greedy's of SMOKE_NATIVE_ITERS) on SMOKE_TRACE_SAMPLE problems.
SMOKE_ITERS = 3
SMOKE_NATIVE_ITERS = 1
SMOKE_TRACE_SAMPLE = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def run_trace(trace, policy: str, num_gpus: int, device,
              capture: list = None, plans: list = None,
              config: dict = None, cluster: dict = None,
              gpus_per_server: int = None, round_s: float = ROUND_S,
              seed: int = 0, scale_factor: int = None,
              slo: float = None, checkpoint_threshold: int = None,
              checkpoint_file: str = None, no_native: bool = False,
              fault_plan=None, profiling_percentage: float = 1.0,
              num_reference_models: int = None,
              max_rounds: int = None) -> dict:
    """Simulate ``trace`` on ``num_gpus`` v100s with 120 s rounds under
    ``policy`` with the planner's device solves on ``device``, as
    tests/test_golden.py drives the JAX package (``config`` adds planner
    keys, e.g. ``plan_deadline_s``). ``cluster`` ({worker type: count})
    replaces the v100s (``num_gpus`` is then the Shockwave planner's
    pool), ``gpus_per_server`` GPUs make a server (1 if not given), and
    ``round_s`` and ``seed`` set the round and the scheduler's and the
    policies' seed. ``scale_factor``, where given, keeps only the trace's
    jobs of that scale factor, and ``slo`` gives every job that SLO (its
    deadline: ``slo`` x its isolated duration from its arrival).
    ``checkpoint_threshold`` and ``checkpoint_file`` go to
    ``Scheduler.simulate``, and ``no_native`` reports the native greedy
    unavailable for the run, so the PyTorch greedy is the fallback.
    ``fault_plan`` (a ``runtime/faults.py`` plan, or ``"churn"`` for
    ``churn_plan``) is armed for the run and disarmed after it;
    ``profiling_percentage`` and ``num_reference_models`` turn on online
    throughput estimation under a packed policy, its completion on
    ``device``. ``max_rounds`` ends the run after that many rounds (its
    metrics then cover the jobs completed by then).
    Returns the metrics (makespan, average JCT, worst FTF, unfair
    fraction, utilization), the rounds, the policy's allocation calls and
    their seconds (Gavel policies), the solves by backend (with their
    summed wall seconds), the level solves by the device their tensors
    lay on, the launches of the PDHG and relaxed kernels, the planner's
    solve records, the MILP's solves by HiGHS status (``shockwave``: 0
    optimal within the gap, 1 stopped at the time limit) and the run's
    wall time, the speculation's hit / repair / miss counts and exposed
    planning seconds, the PyTorch greedy's solves by device and the
    solves by pool and backend under a pool set, and the simulator's
    features: the injector's summary and each fault's recovery record
    (``faults``, ``recoveries``), the live worker ids, the jobs that did
    not complete, the estimator's reference-job matches, the total cost,
    the lease-extension percentage and the round log. ``capture``, where given,
    receives every planning problem the planner solves, and ``plans``
    (round, schedule) of every solve. The kernels' launches come by
    instantiation too (``variants``)."""
    from unittest import mock

    from shockwave_tpu_torch import native
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data import load_or_synthesize_profiles
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.ops import eg_pdhg, eg_relaxed
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.runtime import faults
    from shockwave_tpu_torch.solver import eg_greedy, eg_level

    start = time.perf_counter()
    if fault_plan == "churn":
        fault_plan = churn_plan(faults)
    injector = faults.configure(fault_plan) if fault_plan else None
    cluster = cluster or {"v100": num_gpus}
    jobs, arrivals = trace_jobs(trace, scale_factor)
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(trace), jobs, oracle, worker_type=next(iter(cluster)),
        cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
        if slo is not None:
            job.SLO = slo
    if policy.startswith("shockwave"):
        config = {"num_gpus": num_gpus, "time_per_iteration": round_s,
                  "future_rounds": 20, "lambda": 5.0, "k": 10.0,
                  **(config or {})}
    try:
        sched = Scheduler(get_policy(policy, device=device, seed=seed),
                          throughputs=oracle, seed=seed,
                          time_per_iteration=round_s, profiles=profiles,
                          shockwave_config=config,
                          profiling_percentage=profiling_percentage,
                          num_reference_models=num_reference_models,
                          device=device)
    except BaseException:
        if injector is not None:
            faults.reset()
        raise
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
    eg_greedy.SOLVES.clear()
    eg_pdhg.reset_launch_counts()
    eg_relaxed.reset_launch_counts()
    per_server = None
    if gpus_per_server is not None:
        per_server = {wt: gpus_per_server for wt in cluster}
    try:
        with (mock.patch.object(native, "available", lambda: False)
              if no_native else contextlib.nullcontext()):
            makespan = sched.simulate(
                dict(cluster), arrivals, jobs,
                num_gpus_per_server=per_server,
                checkpoint_threshold=checkpoint_threshold,
                checkpoint_file=checkpoint_file, max_rounds=max_rounds)
    finally:
        if injector is not None:
            faults.reset()
    device_solves = dict(eg_level.SOLVES)
    launches = {**eg_pdhg.LAUNCHES, **eg_relaxed.LAUNCHES}
    variants = {"eg_pdhg": dict(eg_pdhg.LAUNCHES_BY_VARIANT),
                "eg_relaxed": dict(eg_relaxed.LAUNCHES_BY_VARIANT)}
    ftf, unfair = sched.get_finish_time_fairness()
    records = sched._shockwave.solve_records if sched._shockwave else []
    milp_statuses = {}
    for status in getattr(sched._shockwave, "milp_statuses", ()):
        milp_statuses[status] = milp_statuses.get(status, 0) + 1
    backends: dict = {}
    solve_s: dict = {}
    by_pool: dict = {}
    for record in records:
        name = record["backend"]
        backends[name] = backends.get(name, 0) + 1
        solve_s[name] = solve_s.get(name, 0.0) + record["seconds"]
        if "pool" in record:
            key = f"{record['pool']}:{name}"
            by_pool[key] = by_pool.get(key, 0) + 1
    return dict(policy=policy, makespan=makespan,
                avg_jct=sched.get_average_jct(), worst_ftf=max(ftf),
                unfair_fraction=unfair,
                utilization=sched.get_cluster_utilization(),
                slo_violations=sched.get_num_SLO_violations(),
                rounds=sched._num_completed_rounds,
                allocations=sched.num_allocations,
                allocation_s=sched.allocation_s, solves=backends,
                solve_s=solve_s, device_solves=device_solves,
                launches=launches, variants=variants, records=list(records),
                milp_statuses=milp_statuses, solves_by_pool=by_pool,
                greedy_solves=dict(eg_greedy.SOLVES),
                spec_stats=getattr(sched._shockwave, "spec_stats", None),
                exposed_plan_s=sum(getattr(sched._shockwave,
                                           "exposed_plan_times", ())),
                **sim_features(sched, injector),
                wall_s=time.perf_counter() - start)


def sim_features(sched, injector) -> dict:
    """What the simulator's features left on a finished run (a scheduler
    of either package, its injector or None): the injector's summary and
    its recovery records by event id, the live worker ids, the jobs
    admitted, the admitted jobs that neither completed nor were dropped
    (``lost_jobs``), the jobs dropped after repeated failed micro-tasks,
    the estimator's reference-job matches, the total cost, the
    lease-extension percentage and the round log."""
    matches = getattr(sched, "_reference_job_map", None)
    ended = {j.integer: t for j, t in sched._job_completion_times.items()}
    return dict(
        faults=injector.summary() if injector is not None else None,
        recoveries=({int(k): dict(v) for k, v in injector.recovered.items()}
                    if injector is not None else None),
        worker_ids=list(sched._worker_ids),
        admitted=sched._job_id_counter,
        lost_jobs=[j for j in range(sched._job_id_counter)
                   if j not in ended],
        dropped_jobs=sorted(j for j, t in ended.items() if t is None),
        matches=({int(j.integer): list(ref) for j, ref in matches.items()}
                 if matches is not None else None),
        total_cost=sched.get_total_cost(),
        lease_extensions=sched.get_num_lease_extensions(),
        round_log=list(sched._round_log))


def trace_jobs(trace, scale_factor: int = None) -> tuple:
    """The trace's jobs and arrival times, only those of ``scale_factor``
    where it is given."""
    from shockwave_tpu_torch.data import parse_trace

    jobs, arrivals = parse_trace(str(trace))
    if scale_factor is None:
        return jobs, arrivals
    kept = [(j, a) for j, a in zip(jobs, arrivals)
            if j.scale_factor == scale_factor]
    return [j for j, _ in kept], [a for _, a in kept]


def pinned(table: str, key, scipy_version: str) -> dict:
    """The JAX package's metrics of a Gavel or library cell under
    ``scipy_version``: ``table`` names a table of cells (``key`` the
    cell's key there) or of one cell (``key`` None)."""
    override = SCIPY_PINS.get(scipy_version, {}).get((table, key))
    if override is not None:
        return override
    if table in _SINGLE_PINS:
        return _SINGLE_PINS[table]
    return _GAVEL_PINS[table][key]


def library_runs() -> list:
    """(table, key, run arguments, keyword arguments) of every pinned cell
    of the rest of the policy library; ``run_trace`` and
    tests/gavel_reference.py's ``ref_run`` take both."""
    runs = [("GOLDEN_LIBRARY", policy, (GOLDEN_TRACE, policy, 8), {})
            for policy in GOLDEN_LIBRARY]
    runs.append(("ALLOX_SINGLE", None, (GOLDEN_TRACE, "allox", 8),
                 {"scale_factor": 1}))
    runs += [("GOLDEN_SLO", policy, (GOLDEN_TRACE, policy, 8),
              {"slo": SLO_FACTOR}) for policy in GOLDEN_SLO]
    runs += [("PACKED_220", policy, (TRACE_220, policy, 64),
              {"gpus_per_server": 4}) for policy in PACKED_220]
    return runs


def greedy_test_problem(seed: int, J: int = 8, R: int = 5,
                        num_gpus: int = 4, switch_cost: bool = False):
    """The seeded problems the JAX package holds its greedies to: a copy
    of tests/test_shockwave_solver.py::random_problem on
    ``np.random.default_rng(seed)``, and with ``switch_cost`` of
    ``TestSwitchingCost.switchy_problem`` (incumbents with relaunch
    costs), as the port's EGProblem."""
    from shockwave_tpu_torch.solver.eg_problem import EGProblem

    rng = np.random.default_rng(seed)
    total = rng.integers(2, 10, J).astype(float)
    completed = np.floor(total * rng.uniform(0, 0.9, J))
    epoch_dur = rng.uniform(30, 300, J)
    remaining = (total - completed) * epoch_dur * rng.uniform(0.8, 1.2, J)
    priorities = rng.uniform(0.5, 4.0, J)
    nworkers = rng.integers(1, 3, J).astype(float)
    fields = dict(
        priorities=priorities, completed_epochs=completed,
        total_epochs=total, epoch_duration=epoch_dur,
        remaining_runtime=remaining, nworkers=nworkers, num_gpus=num_gpus,
        round_duration=100.0, future_rounds=R, regularizer=1e-4,
        log_bases=LOG_BASES)
    if switch_cost:
        incumbent = (rng.random(J) < 0.5).astype(np.float64)
        if not incumbent.any():
            incumbent[int(rng.integers(J))] = 1.0
        fields.update(switch_cost=rng.uniform(200.0, 3000.0, J) * incumbent,
                      incumbent=incumbent)
    return EGProblem(**fields)


def greedy_problems() -> list:
    """(name, problem) of the greedy's checks: tests/test_native_solver.py's
    (J=8, R=5, 4 GPUs, seeds 0-5; the switch-cost ones, seeds 0-3) and its
    large instance (J=200, R=20, 64 GPUs)."""
    problems = [(f"native seed {seed}", greedy_test_problem(seed))
                for seed in range(6)]
    problems += [(f"switch-cost seed {seed}",
                  greedy_test_problem(seed, switch_cost=True))
                 for seed in range(4)]
    problems.append(("J=200 R=20 64 GPUs",
                     greedy_test_problem(0, J=200, R=20, num_gpus=64)))
    return problems


# The JAX package's bar between its greedy's objective and the native
# greedy's (tests/test_native_solver.py:25-28), at 2% of the objective.
GREEDY_OBJECTIVE_GAP = 0.02


def check_greedy(problems, device) -> tuple:
    """The PyTorch greedy on ``device`` against the port's CPU greedy (held
    to the JAX package's by the tests) on each (name, problem): the
    schedules equal (else the count of differing cells, and the
    objectives within 1e-5 relative), the schedule feasible, the native
    greedy's objective at least the greedy's less GREEDY_OBJECTIVE_GAP
    (the JAX package's bar) and the greedy's at least the native's less
    the same. Above 4096 grants the greedy grants 16 cells a step on
    stale marginals (the reference's ``grant_batch_for``), and on some
    2048-tier windows its plan falls further below the native one (the
    JAX package's on the same windows too); there the single-grant
    greedy, the native greedy's twin, must meet the bar instead. Each
    solve's seconds beside the native greedy's. Returns (failures,
    rows)."""
    from shockwave_tpu_torch import native
    from shockwave_tpu_torch.solver.eg_greedy import (grant_batch_for,
                                                      num_grants_for,
                                                      solve_eg_greedy)
    from shockwave_tpu_torch.solver.eg_level import num_slots_for

    def gap(obj):
        return GREEDY_OBJECTIVE_GAP * max(1.0, abs(obj))

    bad, rows = [], []
    if problems:
        solve_eg_greedy(problems[0][1], device)  # warm-up
    for name, problem in problems:
        start = time.perf_counter()
        Y = solve_eg_greedy(problem, device)
        card_s = time.perf_counter() - start
        Y_cpu = solve_eg_greedy(problem, "cpu")
        start = time.perf_counter()
        Y_native = native.solve_eg_greedy_native(problem)
        native_s = time.perf_counter() - start
        obj = problem.objective_value(Y)
        obj_cpu = problem.objective_value(Y_cpu)
        obj_native = problem.objective_value(Y_native)
        differ = int(np.sum(Y != Y_cpu))
        batch = grant_batch_for(num_grants_for(
            problem, num_slots_for(problem.num_jobs)))
        row = dict(problem=name, jobs=problem.num_jobs,
                   grants=int(problem.num_gpus) * problem.future_rounds,
                   grant_batch=batch, differ=differ, objective=obj,
                   objective_cpu=obj_cpu, objective_native=obj_native,
                   greedy_s=card_s, native_s=native_s)
        rows.append(row)
        if differ and abs(obj - obj_cpu) > 1e-5 * max(1.0, abs(obj_cpu)):
            bad.append(f"{name}: {differ} cells differ from the CPU's, "
                       f"objective {obj} vs {obj_cpu}")
        if np.any(problem.nworkers @ Y > problem.num_gpus + 1e-9):
            bad.append(f"{name}: a round over capacity")
        if obj_native < obj - gap(obj):
            bad.append(f"{name}: the native greedy's objective {obj_native} "
                       f"below the greedy's {obj} by more than 2%")
        if obj >= obj_native - gap(obj_native):
            continue
        if batch == 1:
            bad.append(f"{name}: objective {obj} below the native greedy's "
                       f"{obj_native} by more than 2%")
            continue
        Y_single = solve_eg_greedy(problem, device, grant_batch=1)
        row["objective_single_grant"] = obj_single = (
            problem.objective_value(Y_single))
        if obj_single < obj_native - gap(obj_native):
            bad.append(f"{name}: the single-grant greedy's objective "
                       f"{obj_single} below the native greedy's "
                       f"{obj_native} by more than 2%")
    return bad, rows


def run_smoke_trace(policy: str, speculate: bool, arrival_gap: float,
                    device) -> dict:
    """The pipelining smoke trace as ``SPECULATE_SMOKE`` pins it, the
    planner's device solves on ``device``: the metrics, each round's
    assignment (job -> workers), the reconcile counts, the exposed
    planning seconds and the solve records."""
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.data.generate import smoke_trace_jobs
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.policies import get_policy

    jobs, arrivals = smoke_trace_jobs(6, 2, arrival_gap)
    oracle = generate_oracle()
    sched = Scheduler(
        get_policy(policy, device=device), throughputs=oracle, seed=0,
        time_per_iteration=ROUND_S,
        profiles=synthesize_profiles(jobs, oracle),
        shockwave_config={"num_gpus": 4, "time_per_iteration": ROUND_S,
                          "future_rounds": 6, "lambda": 2.0, "k": 1e-3,
                          "speculate": speculate})
    rounds = []
    dispatch = sched._schedule_jobs_on_workers

    def logged():
        assignments = dispatch()
        rounds.append({str(j): list(w) for j, w in assignments.items()})
        return assignments

    sched._schedule_jobs_on_workers = logged
    makespan = sched.simulate({"v100": 4}, arrivals, jobs)
    planner = sched._shockwave
    return dict(makespan=makespan, rounds=rounds,
                spec_stats=dict(planner.spec_stats),
                exposed_plan_s=sum(planner.exposed_plan_times),
                records=list(planner.solve_records))


def planner_runs() -> list:
    """(key of ``PLANNER``, run arguments, keyword arguments) of every
    pinned planner cell, in the order they must run (a resume reads the
    file the save wrote; ``checkpoint_file`` is a name to put in a
    directory of the caller's); ``run_trace`` and
    tests/planner_reference.py's ``ref_run`` take both."""
    ckpt = (TRACE_220, "shockwave_tpu_pdhg", 64)
    return [
        ("checkpoint_unbroken", ckpt, {"gpus_per_server": 4}),
        ("checkpoint_save", ckpt, {
            "gpus_per_server": 4,
            "checkpoint_threshold": CHECKPOINT_THRESHOLD,
            "checkpoint_file": "pdhg_220.ckpt"}),
        ("checkpoint_resume", ckpt, {
            "gpus_per_server": 4, "checkpoint_file": "pdhg_220.ckpt"}),
        ("speculate_220", (TRACE_220, "shockwave_tpu", 64), {
            "gpus_per_server": 4, "config": {"speculate": True}}),
        ("speculate_golden_cells", (GOLDEN_TRACE, "shockwave_tpu_pdhg", 8),
         {"config": {"cells": 2, "speculate": True}}),
        ("pools_120", (TRACE_120, "shockwave_tpu",
                       sum(POOLS_120_CLUSTER.values())), {
            "cluster": POOLS_120_CLUSTER,
            "config": {"hetero_pools": True}}),
        ("pools_220_pdhg", (TRACE_220, "shockwave_tpu_pdhg",
                            sum(HETERO_CLUSTER.values())), {
            "cluster": HETERO_CLUSTER, "gpus_per_server": 4,
            "config": {"hetero_pools": True}}),
        ("greedy_fallback_golden",
         (GOLDEN_TRACE, "shockwave_tpu_level", GREEDY_FALLBACK_GPUS),
         {"no_native": True}),
    ]


def sim_feature_runs() -> list:
    """(key, run arguments, keyword arguments) of every cell of the
    simulator's features; ``fault_plan="churn"`` stands for
    ``churn_plan`` of the runner's own package. ``run_trace`` and
    tests/sim_features_reference.py's ``ref_run`` take both."""
    runs = [(f"churn_{policy}", (TRACE_220, policy, 64),
             {"gpus_per_server": 4, "fault_plan": "churn"})
            for policy in CHURN_POLICIES]
    runs += [(f"estimate_p{p}_r{r}",
              (GOLDEN_TRACE, "max_min_fairness_packed", 8),
              {"profiling_percentage": p, "num_reference_models": r})
             for p, r in ESTIMATOR_SWEEP]
    runs.append(("estimate_220", (TRACE_220, "max_min_fairness_packed", 64),
                 {"gpus_per_server": 4, "profiling_percentage": 0.5,
                  "num_reference_models": 8}))
    return runs


def churn_plan(faults_module):
    """``CHURN_PLAN`` drawn by ``faults_module`` (either package's
    ``runtime/faults.py``)."""
    return faults_module.generate_churn_plan(**CHURN_PLAN)


def pricing_bursts(job_cls) -> list:
    """The ``PRICING_BATCH`` bursts of the lane-amortized pricing check:
    1 to 8 jobs, a scale factor of 2 every third, demands of 0.5 to 2.5
    hours or, every fourth, the whole window."""
    from shockwave_tpu_torch.tools.whatif import burst_jobs

    return [burst_jobs(job_cls, 1 + k % 8, scale=2 if k % 3 == 2 else 1,
                       duration=None if k % 4 == 3 else 1800.0 * (1 + k % 5))
            for k in range(PRICING_BATCH)]


def digest(obj) -> str:
    """The first 16 hex digits of the SHA-256 of ``obj``'s sorted-key JSON
    (after a JSON round trip, so that int and str keys hash alike)."""
    import hashlib

    text = json.dumps(json.loads(json.dumps(obj)), sort_keys=True)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


def check_features(result: dict, key: str, card: str = None) -> list:
    """A run of ``sim_feature_runs`` cell ``key`` against its pins: the
    metrics (``check_run``), the counts and the digests; on an H100
    (``card``, its name) the card's own pins where it has them."""
    metrics, digests = SIM_FEATURES[key], SIM_FEATURE_DIGESTS[key]
    if card and card.startswith("NVIDIA H100") and key in SIM_FEATURES_H100:
        metrics, card_digests = SIM_FEATURES_H100[key]
        digests = {**digests, **card_digests}
    bad = check_run(result, metrics)
    bad += [f"{k} {result[k]} vs {v}"
            for k, v in SIM_FEATURE_COUNTS[key].items() if result[k] != v]
    for k, v in digests.items():
        if v is not None and digest(result[k]) != v:
            bad.append(f"{k} digest {digest(result[k])} vs {v}")
    return bad


def recoveries_without_hashes(recoveries) -> dict:
    """Recovery records without the HA round trip's verdict: each package
    hashes its own field set, and the JAX package's hash also covers the
    iteration order of four sets, which a restore can change
    (tests/test_torch_faults.py::
    test_the_reference_inexact_round_trips_differ_only_in_set_order)."""
    if recoveries is None:
        return None
    return {int(k): {f: ("journal_state_restored"
                         if f == "how" and v.startswith("journal") else v)
                     for f, v in r.items()
                     if f not in ("state_sha", "roundtrip_exact")}
            for k, r in recoveries.items()}


def decision_misses(got: dict, ref: dict) -> list:
    """A pricing decision (``PricingDecision.as_record``) against the JAX
    package's: the action and reason equal, the welfare delta and the
    burst's welfare within kernel A's limit, 1e-3 (1 + |reference|)."""
    bad = [f"{k} {got[k]!r} vs {ref[k]!r}" for k in ("action", "reason")
           if got[k] != ref[k]]
    for k in ("welfare_delta", "burst_welfare"):
        if (got[k] is None) != (ref[k] is None) or (
                ref[k] is not None
                and abs(got[k] - ref[k]) > 1e-3 * (1.0 + abs(ref[k]))):
            bad.append(f"{k} {got[k]!r} vs {ref[k]!r}")
    return bad


def round_log_misses(log: list, ref: list, tol: float = 0.0) -> list:
    """Where a round log differs from ``ref`` record for record: equal
    keys and strings, numbers within ``tol`` (0: equal)."""
    def same(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and not isinstance(a, bool) and not isinstance(b, bool):
            return abs(a - b) <= tol
        return a == b

    bad = [f"record {i}: {a} vs {b}" for i, (a, b) in enumerate(zip(log, ref))
           if not same(a, b)]
    if len(log) != len(ref):
        bad.append(f"{len(log)} records vs {len(ref)}")
    return bad


def check_run(result: dict, expected: dict) -> list:
    """The metrics (and rounds, where given) that miss ``expected`` by more
    than ``TOLERANCE``, and the counts (a dict, e.g. ``spec_stats``) that
    differ from it."""
    return [f"{k} {result[k]} vs {v}" for k, v in expected.items()
            if (result[k] != v if isinstance(v, dict)
                else abs(result[k] - v) > TOLERANCE)]


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


def stress_problem(num_jobs: int, future_rounds: int, num_gpus: int,
                   seed: int = 0, regularizer: float = 10.0):
    """The JAX package's bench stress problem (``bench.py::make_problem``,
    the same numpy draws): epochs 5-60, a fifth of the jobs incumbents
    with a 35-90 s relaunch overhead, gangs of 1, 2 or 4, 120 s rounds."""
    from shockwave_tpu_torch.solver.eg_problem import EGProblem

    rng = np.random.default_rng(seed)
    total = rng.integers(5, 60, num_jobs).astype(float)
    completed = np.floor(total * rng.uniform(0, 0.8, num_jobs))
    epoch_dur = rng.uniform(60, 2000, num_jobs)
    incumbent = (rng.random(num_jobs) < 0.2).astype(np.float64)
    switch_cost = rng.uniform(35.0, 90.0, num_jobs) * incumbent
    return EGProblem(
        priorities=rng.uniform(0.5, 30.0, num_jobs),
        completed_epochs=completed,
        total_epochs=total,
        epoch_duration=epoch_dur,
        remaining_runtime=(total - completed) * epoch_dur,
        nworkers=rng.choice([1, 1, 1, 2, 2, 4], num_jobs).astype(float),
        num_gpus=num_gpus,
        round_duration=120.0,
        future_rounds=future_rounds,
        regularizer=regularizer,
        log_bases=LOG_BASES.copy(),
        switch_cost=switch_cost,
        incumbent=incumbent,
    )


def split_cells(problem, num_cells: int):
    """``problem`` split row-wise into ``num_cells`` cells, round robin,
    capacity split evenly (the JAX package's
    ``bench_cells_scale.quality_ab``): (cell problems, row indices)."""
    import dataclasses

    from shockwave_tpu_torch.cells import partition

    caps = partition.partition_capacity(problem.num_gpus, num_cells)
    cells, indices = [], []
    for c in range(num_cells):
        idx = np.arange(c, problem.num_jobs, num_cells)
        fields = {f: getattr(problem, f)[idx] for f in (
            "priorities", "completed_epochs", "total_epochs",
            "epoch_duration", "remaining_runtime", "nworkers",
            "switch_cost", "incumbent")}
        cells.append(dataclasses.replace(problem, num_gpus=caps[c], **fields))
        indices.append(idx)
    return cells, indices


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


def device_profile(problem, device, solve=None) -> dict:
    """One level solve (or ``solve()``, where given) under torch.profiler:
    the kernels it launched, its copies, and the device's busy time (the
    kernels' and copies' self time, ms). None for the counts when the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from shockwave_tpu_torch.solver.eg_level import solve_level_counts

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if solve is None:
            solve_level_counts(problem, device)
        else:
            solve()
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


def time_solves(problem, device, iters: int = ITERS,
                native_iters: int = NATIVE_ITERS) -> dict:
    """ms per solve on ``problem``, each the median of ``iters`` (the
    native greedy's of ``native_iters``) after a warm-up: the level solve's device head (pad, copy, solve, fetch:
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
        Y = counts_to_schedule(counts, problem, device)
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
                   lambda: solve_level_counts(problem, device), iters),
               host_tail_ms=1e3 * _median_s(tail, iters),
               native_ms=1e3 * _median_s(greedy, native_iters))
    row["level_ms"] = row["device_ms"] + row["host_tail_ms"]
    if device.type == "cuda":
        row.update(device_profile(problem, device))
    return row


def solve_report(device, problems, iters: int = ITERS,
                 native_iters: int = NATIVE_ITERS,
                 sample: int = TRACE_SAMPLE) -> tuple:
    """The level solve on ``device`` checked against the CPU's on the
    parity problems, a seeded problem of every band of ``BANDS`` and
    ``problems`` (a trace run's); then, if none missed, both backends
    timed (medians of ``iters``, the native greedy's of
    ``native_iters``) on the seeded problems and on ``sample`` of
    ``problems``, with each set's crossover. Returns (the misses, the
    readings)."""
    seeded = [seeded_problem(jobs) for jobs in BANDS]
    checked = parity_problems() + seeded + list(problems)
    started = time.time()
    bad = check_device_counts(checked, device)
    if bad:
        return bad, {}
    print(f"level solve on {device} equals the CPU's on {len(checked)} "
          f"problems ({len(problems)} of them the trace run's)", flush=True)
    report = {"checked": len(checked), "check_s": time.time() - started}
    started = time.time()
    for name, picked in (("seeded", seeded),
                         ("trace", sample_by_jobs(problems, sample))):
        print(f"level solve and native greedy, {name} problems (median of "
              f"{iters}, native of {native_iters}):", flush=True)
        rows = []
        for problem in picked:
            rows.append(time_solves(problem, device, iters, native_iters))
            print("  " + describe(rows[-1]), flush=True)
        report[name] = dict(rows=rows,
                            level_faster_from_jobs=crossover(rows))
        start = crossover(rows)
        print(f"  level solve faster on every problem from {start} jobs"
              if start else "  level solve slower on the largest problem",
              flush=True)
    report["timing_s"] = time.time() - started
    return [], report


# -- the first-order kernels: A (eg_pdhg) and B (eg_relaxed) -------------

# Seeded problems (256 GPUs, 20 rounds) the kernels are checked on, and the
# bands they are timed at; the plain versions are timed up to
# EG_PLAIN_MAX_JOBS (one run each: seconds of eager launches).
EG_CHECK_BANDS = (64, 256, 1024, 4096)
EG_TIME_BANDS = (256, 1024, 4096, 16384, 65536)
# The band chip_smoke.py's phase 9(d) times (the other bands' readings
# are PERF.md's): the largest that the main path's resident
# instantiations take and the plain version is timed at.
SMOKE_EG_TIME_BANDS = (1024,)
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
# Float32 summation's slack on the GPU-rounds a solve's ``s`` may use
# (the plain versions overshoot the budget by at most 2e-7 of it on the
# tier's windows and the seeded problems, on the CPU).
BUDGET_RTOL = 1e-5
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


def eg_misses(problem, s, obj, ref_s, ref_obj, check_s=True) -> list:
    """Where a solve misses its reference by the limits of two summation
    orders: ``s`` within rtol = atol = S_TOL (unless ``check_s`` is
    false), the objective within OBJ_TOL (1 + |obj|) and the rounded
    objective within ROUNDED_TOL (1 + |o|); and where ``s`` is not
    feasible: outside [0, future_rounds], or its GPU-rounds past the
    budget by more than BUDGET_RTOL of it."""
    bad = []
    if check_s and not np.allclose(s, ref_s, rtol=S_TOL, atol=S_TOL):
        bad.append(f"s off by {np.max(np.abs(s - ref_s)):.3g}")
    R = problem.future_rounds
    if s.min() < 0.0 or s.max() > R:
        bad.append(f"s outside [0, {R}]: [{s.min()!r}, {s.max()!r}]")
    used = float(np.dot(np.asarray(problem.nworkers, np.float64), s))
    budget = float(problem.num_gpus * R)
    if used > budget * (1.0 + BUDGET_RTOL):
        bad.append(f"s uses {used!r} GPU-rounds of {budget!r}")
    if abs(obj - ref_obj) > OBJ_TOL * (1.0 + abs(ref_obj)):
        bad.append(f"objective {obj!r} vs {ref_obj!r}")
    o, ref_o = rounded_objective(problem, s), rounded_objective(problem,
                                                                ref_s)
    if abs(o - ref_o) > ROUNDED_TOL * (1.0 + abs(ref_o)):
        bad.append(f"rounded objective {o!r} vs {ref_o!r}")
    return bad


def start_moved(kind: str, packed) -> list:
    """The plain version on ``packed`` with its start moved one float32
    step up and then down (kernel A's warm start ``s0`` on every active
    job, kernel B's ``s_init``): the two output rows."""
    from shockwave_tpu_torch.solver import eg_pdhg, eg_relaxed

    if kind == "pdhg":
        row, cols = len(eg_pdhg.ROWS) - 1, slice(None)
    else:
        col = eg_relaxed.SCALARS.index("s_init")
        row, cols = len(eg_relaxed.ROWS), slice(col, col + 1)
    rows = []
    for toward in (float("inf"), float("-inf")):
        moved = packed.clone()
        start = moved[0, row, cols]
        nudged = torch.nextafter(start, torch.full_like(start, toward))
        if kind == "pdhg":
            nudged = torch.where(moved[0, 0] > 0, nudged, start)
        moved[0, row, cols] = nudged
        rows.append(eg_plain(kind, moved))
    return rows


def check_eg_kernels(problems, device, undetermined=None) -> tuple:
    """Kernels A and B on ``device`` against their plain versions on the
    same device and inputs (``eg_misses``), each kernel run twice and
    bitwise equal, and bitwise equal to the sequential instantiation
    (one bisection step a barrier, state in global memory). ``s`` is held
    where float32 determines it: where the kernel's misses the plain
    version's and the plain version's own run with its start moved one
    float32 step (``start_moved``) misses as well, the optimum is a face
    along which rounding moves capacity between jobs, and the miss goes
    to the list ``undetermined`` (the kernel, the problem, the kernel's
    |s| error and the plain version's own spread each way) instead; the
    objective, the rounded objective and feasibility are held on every
    problem. Returns (the misses, the largest |s| error of each kernel
    where ``s`` is determined)."""
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
            err = float(np.max(np.abs(s - ref_s)))
            determined = np.allclose(s, ref_s, rtol=S_TOL, atol=S_TOL)
            if not determined:
                spread = [row.cpu().numpy()[:J].astype(np.float64)
                          for row in start_moved(kind, packed)]
                determined = all(np.allclose(m, ref_s, rtol=S_TOL,
                                             atol=S_TOL) for m in spread)
                if not determined and undetermined is not None:
                    undetermined.append(dict(
                        kernel=kind, problem=i, jobs=J, s_err=err,
                        plain_spread=[float(np.max(np.abs(m - ref_s)))
                                      for m in spread]))
            if determined:
                max_err[kind] = max(max_err[kind], err)
            bad += [f"{where}: {m}" for m in eg_misses(
                problem, s, float(got[slots]), ref_s, float(ref[slots]),
                check_s=determined)]
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
    the operations over the float32 peak (``io_bytes`` and ``ops`` are
    the two sides)."""
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
    return dict(state_bytes=state_bytes, io_bytes=io, ops=ops * slots,
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


def time_lane_grid(packed: torch.Tensor, iters: int = 3) -> dict:
    """Kernel A on ``packed`` lanes ([P, rows, slots] on a card) as one
    launch of P blocks against the same lanes launched one by one: the
    grid's ms (CUDA events, median of ``iters`` after a warm-up), the sum
    of each lane's one-lane launch (one run each), the cycles of the
    slowest lane, and the bound of the grid's work: the lanes' inputs and
    outputs over HBM or their operations over the float32 peak, whichever
    is larger. Fails unless each lane of the grid equals its one-lane
    launch in every bit."""
    from shockwave_tpu_torch.ops import eg_pdhg
    from shockwave_tpu_torch.solver import eg_pdhg as pdhg_solver

    args = (pdhg_solver.DEFAULT_MAX_CYCLES, pdhg_solver.DEFAULT_INNER_ITERS)
    P, _, slots = packed.shape
    stats = torch.zeros((P, 4), dtype=torch.int64, device=packed.device)
    grid = eg_pdhg.pdhg(packed, *args, stats=stats)
    times = [_event_ms(lambda: eg_pdhg.pdhg(packed, *args))
             for _ in range(iters)]
    alone, one_ms = [], 0.0
    for b in range(P):
        lane = packed[b:b + 1]
        one_ms += _event_ms(lambda: alone.append(eg_pdhg.pdhg(lane, *args)))
    differ = [b for b in range(P) if not same_bits(grid[b], alone[b][0])]
    io = ops = 0.0
    rows, stats = grid.cpu().numpy(), stats.cpu().numpy()
    for row, st in zip(rows, stats):
        work = eg_work("pdhg", slots, eg_counts("pdhg", slots, row, st))
        io, ops = io + work["io_bytes"], ops + work["ops"]
    t_io, t_ops = io / HBM_BYTES, ops / F32_PEAK
    return dict(lanes=P, slots=slots, ms=statistics.median(times),
                one_by_one_ms=one_ms, differ=differ,
                max_cycles=int(rows[:, slots + 1].max()),
                bound_ms=1e3 * max(t_io, t_ops),
                bound_by="operations" if t_ops >= t_io else "bytes")


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


# The exact MILP against the card (``--milp-baseline`` and chip_smoke.py
# phase 13). bench.py's stress shape and seeds (``make_problem``, RUNS):
# 1000 jobs x 256 GPUs x 50 rounds, seeds 0-4, the MILP on seed 0.
MILP_STRESS = dict(num_jobs=1000, future_rounds=50, num_gpus=256)
MILP_STRESS_SEEDS = tuple(range(5))
# The reference formulation's time limits there: near-complete, and the
# 15 s budget the reference pays a round (bench.py:646-665).
MILP_TIME_LIMITS = (120.0, 15.0)
# A seeded problem both formulations solve to their gap in well under
# 15 s on a host: bench.py's generator at the shape of a planning window
# of the 220-job trace on 64 GPUs (200 jobs, 20 rounds).
MILP_WINDOW = dict(num_jobs=200, future_rounds=20, num_gpus=64, seed=0)


def host_cpu() -> str:
    """The host's CPU model (``lscpu``'s vendor and model name, else
    ``/proc/cpuinfo``'s model name, else the machine type) and its logical
    CPUs."""
    import os
    import platform

    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        for line in out.splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    model = " ".join(v for v in (fields.get("Vendor ID"),
                                 fields.get("Model name")) if v)
    if model and fields.get("CPU family"):
        model += (f", family {fields['CPU family']} model "
                  f"{fields.get('Model')}")
    if not model:
        try:
            for line in Path("/proc/cpuinfo").read_text().splitlines():
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
        except OSError:
            pass
    return f"{model or platform.machine()} ({os.cpu_count()} logical CPUs)"


def milp_solve(problem, formulation: str, time_limit: float) -> dict:
    """One MILP solve on the host: ``formulation`` "tightened"
    (``solve_eg_milp``) or "reference" (the reference's encoding), its
    wall seconds, HiGHS's status and its plan's objective (None when
    HiGHS ended with no incumbent)."""
    from shockwave_tpu_torch.solver import eg_milp

    solve = (eg_milp.solve_eg_milp if formulation == "tightened"
             else eg_milp.solve_eg_milp_reference_formulation)
    statuses = []
    start = time.perf_counter()
    try:
        Y = solve(problem, rel_gap=1e-3, time_limit=time_limit,
                  statuses=statuses)
    except RuntimeError:
        Y = None
    seconds = time.perf_counter() - start
    if Y is not None:
        problem.audit_schedule(Y)
    return dict(formulation=formulation, time_limit=time_limit,
                seconds=seconds, status=statuses[0],
                objective=None if Y is None else problem.objective_value(Y))


def card_solve(problem, backend: str, device) -> dict:
    """The planner's ``level`` (the production solve above the native
    threshold) or ``pdhg`` (kernel A) solve of ``problem`` on ``device``,
    end to end (copy, solve, fetch, the host's rounding and placement):
    the median wall seconds of 3 after a warm-up, the plan audited and
    its objective."""
    from shockwave_tpu_torch.solver.eg_level import solve_eg_level
    from shockwave_tpu_torch.solver.eg_pdhg import solve_eg_pdhg

    def solve():
        if backend == "level":
            return solve_eg_level(problem, device)
        return solve_eg_pdhg(problem, device=device)

    Y = solve()
    times = []
    for _ in range(3):
        start = time.perf_counter()
        Y = solve()
        times.append(time.perf_counter() - start)
    problem.audit_schedule(Y)
    return dict(backend=backend, seconds=statistics.median(times),
                objective=problem.objective_value(Y))


def objective_gap(card_obj: float, milp_obj) -> float:
    """How far the card's plan is above the MILP's, relative to the
    card's objective (negative: the MILP's plan is the better)."""
    if milp_obj is None:
        return None
    return (card_obj - milp_obj) / abs(card_obj)


def milp_window(device) -> dict:
    """``MILP_WINDOW``: both formulations on the host within 15 s against
    the card's level solve and kernel A on the same problem, with the
    objective gaps; every plan audited (``audit_schedule`` raises)."""
    problem = stress_problem(**MILP_WINDOW)
    milp = [milp_solve(problem, f, 15.0) for f in ("tightened", "reference")]
    card = [card_solve(problem, b, device) for b in ("level", "pdhg")]
    for c in card:
        c["gap"] = {m["formulation"]: objective_gap(c["objective"],
                                                    m["objective"])
                    for m in milp}
    return dict(problem=dict(MILP_WINDOW), milp=milp, card=card)


def milp_baseline(device) -> dict:
    """The north star on ``device``: the reference-formulation MILP at
    bench.py's stress shape (seed 0) with each of ``MILP_TIME_LIMITS``
    against the card's production solve (level: the work, 1.28e7, is
    above the native threshold) and kernel A (pdhg), each timed end to
    end over the stress seeds (median) with seed 0's objective; the ratio
    of wall seconds and the objective gap at equal time."""
    problems = [stress_problem(seed=s, **MILP_STRESS)
                for s in MILP_STRESS_SEEDS]
    card = []
    for backend in ("level", "pdhg"):
        runs = [card_solve(p, backend, device) for p in problems]
        card.append(dict(backend=backend,
                         seconds=statistics.median(r["seconds"] for r in runs),
                         seconds_all=[r["seconds"] for r in runs],
                         objective=runs[0]["objective"]))
    milp = [milp_solve(problems[0], "reference", t) for t in MILP_TIME_LIMITS]
    for c in card:
        c["vs_milp"] = {str(m["time_limit"]): dict(
            ratio=m["seconds"] / c["seconds"],
            gap=objective_gap(c["objective"], m["objective"]))
            for m in milp}
    return dict(shape=dict(MILP_STRESS), seeds=list(MILP_STRESS_SEEDS),
                milp=milp, card=card)


def describe_milp(row: dict) -> str:
    obj = ("no incumbent" if row["objective"] is None
           else f"objective {row['objective']:.4f}")
    return (f"MILP ({row['formulation']} formulation, time limit "
            f"{row['time_limit']:.0f} s): {row['seconds']:.3f} s on the "
            f"host, HiGHS status {row['status']}, {obj}")


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
    parser.add_argument("--milp-baseline", action="store_true",
                        help="the exact MILP on the host against the "
                             "card's solves at bench.py's stress shape")
    args = parser.parse_args(argv)
    from shockwave_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    if args.milp_baseline:
        import scipy

        where = f"[{card}; host {host_cpu()}; scipy {scipy.__version__}]"
        out = milp_baseline(device)
        for m in out["milp"]:
            print(f"{describe_milp(m)} {where}", flush=True)
        for c in out["card"]:
            print(f"{c['backend']} on {device}: {c['seconds']:.4f} s median "
                  f"over seeds {out['seeds']} "
                  f"({', '.join(f'{t:.4f}' for t in c['seconds_all'])}), "
                  f"objective {c['objective']:.4f} on seed 0; "
                  + "; ".join(
                      f"against the {limit} s MILP {v['ratio']:.1f}x, gap "
                      + ("n/a" if v["gap"] is None
                         else f"{100 * v['gap']:.4f}%")
                      for limit, v in c["vs_milp"].items())
                  + f" {where}", flush=True)
        out.update(card=card, host=host_cpu(), scipy=scipy.__version__)
        print(json.dumps(out))
        return out
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
