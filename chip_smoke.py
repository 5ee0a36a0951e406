#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``shockwave_tpu_torch/ops/csrc`` into
   ``shockwave_tpu_torch/_build/`` (one nvcc for each source, started
   together, ~13 s), prints the flash kernels' registers, stack and
   shared memory (``cuobjdump -res-usage``) and the planning kernels'
   registers and spills (``-Xptxas -v``)
   and fails unless the SASS (``cuobjdump -sass``) of every bf16 forward,
   dK/dV and dQ instantiation, causal and non-causal, holds wgmma
   (``HGMMA``) and TMA loads (``UTMALDG``), or if ptxas reported
   serialising any wgmma (the build log, ``-Xptxas -v``).
3. Holds each kernel (flash forward, dK/dV, dQ) against its plain PyTorch
   version on the card: at the training shape (B=8, S=2048, H=8, D=128,
   bf16, causal) on inputs from seeds 1 and 0, at two GQA-plus-window
   shapes in bf16 (B=2, S=512, H=4, Hkv=2, D=64, window=200; B=1,
   S=1024, H=4, Hkv=1, D=128, window=333), which reach the kernels'
   window-straddle and skip code, and at the first of those in float32,
   under the per-element (with its one-flip term) and Frobenius limits
   of ``flash_attention.KERNEL_TOLERANCE``; then shows that those limits
   reject planted faults (a skipped tile of the width each kernel walks,
   misweighted rows) at the training shape. The inputs, the check and the
   timing are ``shockwave_tpu_torch/tools/bench_flash.py``'s.
4. Times each kernel, its plain version and PyTorch's
   scaled_dot_product_attention with CUDA events, beside the kernel's
   bound on an H100 SXM, and the backward pair (dK/dV + dQ) beside SDPA's
   backward, which computes dq, dk and dv in one call.
5. Checks a small model on the card: the flash path against the dense
   path on the same weights.
6. Drives the main path: ``shockwave_tpu_torch.models.train.main`` at the
   110M tier (vocab 8192, d_model 1024, 8 heads of 128, 8 layers, seq
   2048, batch 8, bf16, flash, AdamW) for 5 steps with a checkpoint, then
   resumes from it for 2 more. The launch counters must show 8 launches
   of every causal kernel per step (one per layer) and none non-causal.
7. Drives the ring slice (``run_ring``): (a) each kernel against its
   plain version under ``KERNEL_TOLERANCE`` at the shapes the ring gives
   it: causal in bf16 at the 110M tier's ring-hop shape (B=8, Sq=Sk=512,
   H=8, D=128, each shard's hop 0), and non-causal in bf16 at that shape
   and at a GQA shape with Sk != Sq (B=2, Sq=512, Sk=1024, H=4, Hkv=2,
   D=64), and in float32 at the latter, with the planted faults rejected
   at the hop shape; (b) ``ring_attention`` (flash body, a
   4-shard seq mesh of the one card) against ``flash_attention`` in
   float32 (B=2, S=1024, H=4, Hkv=2, D=64), output and q/k/v gradients
   within rtol 1e-3, atol 1e-4; (c) the 110M tier with
   ``attention="ring"`` on a (1, 1, 4, 1) mesh of the card through
   ``train.build_family`` against the flash model on the same seed-0
   weights and batches: on the first batch its loss within 2e-5 and every
   parameter's gradient within 0.08 (relative Frobenius) of the flash
   model's, limits that four planted hop faults (the last live hop
   dropped or weighted twice, in every layer or the last) must each fail;
   then 5 steps, each loss within 5e-5 of the flash run's (item 6), with
   32 causal and 48 non-causal launches of each kernel per step (8 layers
   x (4 shards + 6 live hops)); then ``train.main --attention ring --seq_parallel 1`` for
   2 steps; (d) the non-causal kernels timed at the hop shape beside
   their bound and SDPA with ``is_causal=False``, and the ring step's
   steps/s and peak memory beside the flash step's.
8. Drives the second main path, trace-driven simulation under the
   Shockwave planner with its level-set solve on the card
   (``shockwave_tpu_torch/tools/bench_sim.py``): (a) the committed 12-job
   trace on 8 GPUs under ``shockwave_tpu_level`` and ``shockwave_native``,
   each within 1e-3 of the JAX package's golden (tests/test_golden.py),
   every level solve of the first run on the card (16); (b) the 2048-job
   trace on 256 GPUs with 120 s rounds under ``shockwave_tpu``, the
   production dispatch, for its first 250 rounds, within 1e-3 of the JAX
   package's run of the same rounds on the CPU (``bench_sim.
   TIER_2048_CUT``), with at least one level solve on the card; (c) the
   level solve on the
   card against the port's CPU solve (which the tests hold to the JAX
   package), counts equal and objectives within 1e-6, on the 204 seeded
   parity problems (slot bands 64 to 1024, with and without a switch
   bonus), on a seeded problem of every timing band and on every planning
   problem the 2048-job run built; (d) per slot band (64 to 1024 jobs on
   256 GPUs, 20 rounds, seeded) and on 4 of the 2048-job run's own
   problems across their job counts, the level solve's time, device head
   and host tail, the median of 3 after a warm-up (the native greedy's
   one run; ``bench_sim.SMOKE_ITERS``; the tool's deeper readings are
   PERF.md's), its kernel launches
   and the device's busy time under torch.profiler, and the native
   greedy's time on the same problem, with the crossover of each set.
   (e) The sharded level solve (``solver/eg_sharded.py``, the job slots
   over a one-process solve mesh that holds card 0 in 1, 2, 4 and 8
   places, each shard sorting only its own cells): on one parity problem
   of each slot band and the tie-heavy problem of
   tests/test_sharded_solver.py, and at 8 places on the 16384-job,
   50-round, 4096-GPU stress problem (``bench_sim.stress_problem``, the
   JAX package's ``bench.make_problem(seed=0)``); fails unless its counts
   equal the one-card level solve's in every bit and its objective is
   within ``SHARDED_OBJ_RTOL``. Then the golden trace under
   ``shockwave_tpu_sharded`` (the mesh of every visible card); fails
   unless its metrics and every plan equal the level run's of (a) and
   every solve took the sharded backend on the card. Prints, and does
   not hold, the sharded solve's ms and kernel launches at 8 places
   against the one-card solve's at 4096 and 16384 jobs. It prints one
   JSON line ``{"simulation": {...}}`` of these readings.
9. Drives the planner's first-order backends, kernels A (restarted PDHG,
   ``csrc/eg_pdhg.cu``) and B (relaxed PGD, ``csrc/eg_relaxed.cu``), each
   one launch a solve (``shockwave_tpu_torch/tools/bench_sim.py``): (a) the
   2048-job trace on 256 GPUs under ``shockwave_tpu_pdhg`` for its first
   ``bench_sim.TIER_2048_PDHG_CUT["rounds"]`` rounds (the whole run's 489
   rounds took 130-274 s on NVIDIA H100 80GB HBM3 hosts at 700.00 W, 98%
   of it the host tail; PERF.md), every plan audited
   (``EGProblem.audit_schedule``), with its makespan, average JCT and
   solves, their device head apart from their host tail, within 1e-3 of
   the JAX package's run of the same rounds on the CPU
   (``tests/tier_cut_reference.py``); on 8 of its windows spread over
   their job counts the pdhg plan's objective at least the level
   backend's less 1e-3 of it (the JAX package's bar,
   tests/test_pdhg.py:47-58); the 12-job trace under
   ``shockwave_tpu_pdhg`` and ``shockwave_tpu_relaxed`` within 1e-3 of the
   JAX package's metrics, every launch of the tier and of both golden
   runs taking an instantiation with its per-job state in shared memory;
   (b) each kernel against its plain version on the card on seeded
   problems of 64, 256, 1024 and 4096 jobs (256 GPUs, 20 rounds) and on
   those 8 windows: ``s`` within rtol = atol = 5e-3 where float32
   determines it (where the plain version's own run with its start one
   float32 step away misses that limit too, ``s`` follows the rounding
   along a face of optima and is listed, not held;
   ``bench_sim.check_eg_kernels``), the objective within 1e-3 (1 +
   |obj|), the rounded counts' objective within 2e-3 (1 + |o|), ``s``
   feasible (in [0, rounds], its GPU-rounds within 1e-5 of the budget),
   two runs bitwise equal, and equal in every bit to the kernel's
   sequential instantiation (one bisection step a barrier, state in
   global memory); (c) the degradation ladder: the 12-job trace under
   ``shockwave_tpu`` with a planning deadline and one injected
   ``solver_timeout``, whose record must show the pdhg rung ``ok``; (d)
   at 1024 jobs (``bench_sim.SMOKE_EG_TIME_BANDS``; the readings at 256
   and 4096 to 65536 are PERF.md's) the wrapper's instantiation and the
   sequential
   one timed in turns, each with its block barriers and its floor (the
   barriers at a probe kernel's us per empty reduction), the two equal
   in every bit, with the plain version's time (up to 4096 jobs) and the
   bounds. It prints one JSON line ``{"first_order": ...}``.
10. Prints one JSON line ``{"kernels": [...]}`` (a row for each kernel
   and mode) and, last, ``{"ok": true, "device": {...}}``. Every printed
   reading of the ring phase carries the card's name and power limit.
11. Before item 10's lines, drives the Gavel round path (``run_gavel``;
   it and item 13 run in a process of their own, ``python chip_smoke.py
   --host-phases b``, started before item 17 and waited for after item 8,
   whose output is then printed):
   Gavel's policies, whose allocation LPs run on the host (scipy's
   HiGHS), through ``bench_sim.run_trace`` and the Figure-9 runner
   (``shockwave_tpu_torch/tools/scale_experiments.py``): (a) the 12-job
   trace on 8 GPUs under ``fifo`` and ``max_min_fairness``, each within
   1e-3 of tests/test_golden.py; (b) Figure 9: the 220-job trace, 4 GPUs a
   server, 120 s rounds, under ``max_min_fairness`` and ``shockwave_tpu``
   at 64, 128 and 256 GPUs and under ``finish_time_fairness`` and
   ``max_min_fairness_water_filling`` at 64, and the 2048-job trace on 256
   GPUs under ``max_min_fairness`` (item 8's ``shockwave_tpu`` run, cut to
   its first rounds, printed beside it), each within 1e-3 of the JAX
   package's run (``bench_sim.FIGURE9``, ``TIER_2048_MMF``), with a table
   of makespan, average JCT, worst FTF and unfair fraction and the
   Shockwave against max-min ratios at 220 jobs; (c) the
   220-job trace on ``v100:16 p100:16 k80:16`` under ``fifo``,
   ``fifo_perf``, ``max_min_fairness``, ``max_min_fairness_perf``,
   ``finish_time_fairness_perf``, ``max_sum_throughput_perf`` and
   ``min_total_duration_perf``, each within 1e-3 of the JAX package's
   (``bench_sim.HETERO``); every run is held to the JAX package's run
   under the same scipy (``bench_sim.pinned``: the pins are scipy
   1.17.0's, ``SCIPY_PINS`` the cells another scipy's HiGHS moves); (d)
   for every run its wall time and its
   allocation calls and their seconds, each line with the card's name
   and power limit and scipy's version. It prints one JSON line
   ``{"gavel": ...}``.
12. After item 11, drives the cells market and the what-if fleet, kernel A
   launched as a grid of lanes, a block a lane (``run_cells``): (i) the
   JAX package's quality A/B (``bench_cells_scale.quality_ab``: its bench
   stress problem of 1000 jobs x 256 GPUs x 50 rounds, seed 0, split
   round robin into 8 cells), one global launch and one launch of 8
   lanes: every lane equal in every bit to its own one-lane launch and
   within the limits of its plain version, the merged cell schedule
   feasible for the global problem and its objective within
   ``CELLS_GAP_PCT`` (0.5%) of the global solve's, then the 8 lanes over
   a lane mesh that holds card 0 in 2 and in 4 places
   (``CELLS_MESH_PLACES``; ``cells/batched.py``'s ``mesh``): one launch a
   place, every lane equal in every bit to the single launch's; (ii) the
   12-job trace on
   8 GPUs under ``shockwave_tpu_pdhg --cells 2`` within 1e-3 of the JAX
   package's run (``bench_sim.GOLDEN_CELLS``) in its rounds, then
   ``python -m shockwave_tpu_torch.simulate -t
   traces/generated_2048_dynamic.trace -p shockwave_tpu_pdhg -c v100=256
   --time_per_iteration 120 --cells 4 --max_rounds 260`` (run beside item
   17 in a process of its own, ``run_cells_tier``; the tier's first
   260 rounds, round 253 the one with the most incomplete jobs): every
   cell plan audited, every lane of every launch equal to its one-lane
   launch, its metrics within 1e-3 of the JAX package's run of the same
   rounds (``bench_sim.TIER_2048_CELLS_CUT``), with its launches,
   lanes a launch, device head and host tail; (iii) ``python -m
   shockwave_tpu_torch.tools.whatif
   sweep`` on (a) round 91 of the committed decision log with the JAX
   package's 1024-scenario fleet (``bench_whatif_fleet.build_grid``) and
   (b) the tier's ``CellPlanner`` state at its round with the most
   incomplete jobs, written as an export-state envelope, on a 65-scenario
   grid (fleet sizes x weights x switch-cost scales): every lane audited
   equal to its one-lane launch, the scenarios/s, the grid's kernel time
   against its lanes launched one by one and its bound
   (``bench_sim.time_lane_grid``, also at the 8 lanes of (i)), and the
   card's busy share of a ``solve_scenarios`` call; grid (a)'s 1024 lanes
   over card 0 in 4 places (``whatif/scenario.py``'s ``mesh``), every lane
   equal in every bit to the single launch's. Then re-times the
   non-causal flash kernels and SDPA's ``is_causal=False`` forward at the
   hop shape beside item 7's reading (back to back, the host's issue time
   and queued behind a sleep kernel) with the card's clock and power. It
   prints one JSON line ``{"cells": ...}``; the ``eg_pdhg`` row of item
   10's line carries the lane grid's launches and times.

13. After item 12, drives the rest of the policy library (``run_library``),
   whose LPs, assignments and MILP run on the host: (a) the 12-job trace
   on 8 GPUs under every policy of ``bench_sim.GOLDEN_LIBRARY`` (the
   packed policies with the scheduler's pair throughputs, ``gandiva``,
   the cost-normalized throughput sums and ``shockwave``, the exact
   MILP), ``allox`` on its single-GPU jobs, the SLO programs with every
   job's deadline at 1.2 x its isolated duration, and the 220-job trace
   on 64 GPUs, 4 a server, under ``gandiva`` and
   ``max_min_fairness_packed``, each within 1e-3 of the JAX package's
   run in its rounds (``bench_sim.library_runs``, held to
   ``bench_sim.pinned`` as in item 11), none launching a kernel or a
   device solve, with ``allox`` and
   ``max_min_fairness_strategy_proof`` failing on the golden trace where
   the JAX package fails; (b) the MILP's solves by HiGHS status, failing
   if a pinned run had a solve stop at its time limit; (c) on a seeded
   problem of 200 jobs x 64 GPUs x 20 rounds (``bench_sim.MILP_WINDOW``)
   the MILP in both formulations on the host (each must end optimal
   within its gap, under 15 s) against the card's level solve and kernel
   A: host seconds, card seconds and objective gaps, every plan audited
   (``EGProblem.audit_schedule``). It prints one JSON line
   ``{"library": ...}``; each line carries the card's name and power
   limit and scipy's version.

14. After item 13, drives the rest of the Shockwave planner
   (``run_planner``; the JAX package's runs it is held to are
   ``bench_sim.PLANNER`` and ``SPECULATE_SMOKE``, from
   tests/planner_reference.py): (a) checkpoints: the 220-job trace on 64
   GPUs, 4 a server, under ``shockwave_tpu_pdhg``, saving once 110 jobs
   were admitted and running on, within 1e-3 of the JAX package's
   unbroken run in its rounds, then a fresh scheduler resumed from the
   file, equal to it in every printed digit and round, every solve on
   kernel A; (b) speculation: (i) the pipelining smoke trace at t0 under
   ``shockwave_tpu`` and ``shockwave_tpu_pdhg``, serial and speculative,
   the same rounds and every boundary a hit; (ii) the 220-job trace on 64
   GPUs under ``shockwave_tpu``, serial and ``--speculate``, with the JAX
   package's hit / repair / miss counts and each run's exposed planning
   seconds; (iii) the golden trace under ``shockwave_tpu_pdhg --cells 2
   --speculate``, every lane of every launch equal to its one-lane launch;
   (iv) the smoke trace with an arrival every 60 s under ``shockwave_tpu
   --speculate``, whose repair solves run on kernel A, timed alone with
   CUDA events; (c) pool sets: the 120-job trace on v100:8 p100:4 k80:4
   under ``shockwave_tpu`` and the 220-job trace on v100:16 p100:16
   k80:16 under ``shockwave_tpu_pdhg``, both with ``hetero_pools``, with
   their solves by pool and backend; (d) the PyTorch greedy on the card
   on tests/test_native_solver.py's problems and 8 windows of the
   2048-job tier: equal to its CPU run, feasible, its objective and the
   native greedy's within 2% of each other (the JAX package's bar;
   where the 16-grant steps the reference takes above 4096 grants fall
   further below the native greedy, as the JAX package's do on the same
   windows, the single-grant greedy must meet it), its time a solve
   beside the native greedy's; and the golden trace on 5 GPUs under
   ``shockwave_tpu_level`` with the native greedy unavailable, which takes
   the fallback on the card; (e) ``solve_eg_pdhg_with_duals`` on the 8
   windows, each report equal to ``dual_report`` of its ``s`` on the host
   and to a second call's, each plan audited. It prints one JSON line
   ``{"planner": ...}``; the ``eg_pdhg`` row of item 10's line carries
   the phase's launches of kernel A (``planner_launches``).

15. After item 14, drives the simulator's remaining features
   (``run_sim_features``; the pins are ``bench_sim.SIM_FEATURES``,
   ``SIM_FEATURE_COUNTS``, ``SIM_FEATURE_DIGESTS`` and ``PRICING``, from
   tests/sim_features_reference.py): (a) ``python -m
   shockwave_tpu_torch.simulate -t traces/generated_220_dynamic.trace -c
   v100=64 --num_gpus_per_server v100=4 --time_per_iteration 120
   --fault-plan P --round_log L`` under ``shockwave_tpu_pdhg`` (kernel A)
   and ``max_min_fairness``, ``P`` the seeded churn plan
   ``bench_sim.CHURN_PLAN`` (200 events: worker crashes, reclaims and
   re-adds, two solver faults, two scheduler kills), each held to the
   JAX package's run of the same plan: metrics within 1e-3 in its rounds,
   the injector's summary, the survivors' worker ids, the unfinished and
   dropped jobs, every recovery record, every scheduler kill a bit-exact
   round trip through the HA codec's JSON, and the round log equal record
   for record (exact under max-min, 1e-3 under pdhg), with kernel A's
   launches; (b) online estimation, masked ALS on the card: the six
   cells of the JAX package's estimator sweep (the golden trace on 8
   v100s under ``max_min_fairness_packed``) and the 220-job trace on 64
   v100s through ``simulate --profiling_percentage 0.5
   --num_reference_models 8``, each held to its pin with its
   reference-job matches, and the ALS's ms a call; (c) pricing: ``python
   -m shockwave_tpu_torch.tools.whatif price`` on round 91 of the
   committed decision log (tests/test_whatif.py's burst) and on item 12's
   ``--cells 4`` tier state (round 253, 1053 jobs) with a burst of 8,
   and a ``price_batch`` of 16 bursts on that state as one launch, each
   decision the JAX package's, every lane equal to its one-lane launch,
   each burst's one-burst batch equal to its ``price`` in every bit and
   the batch's verdicts the sequential ones, with ``solve_s``. It prints
   one JSON line ``{"sim_features": ...}``; the ``eg_pdhg`` row of item
   10's line carries the phase's launches of kernel A
   (``sim_features_launches``).

16. After item 15, Ulysses attention and the telemetry planes
   (``run_ulysses``, ``run_telemetry``): (a) ``ulysses_attention`` (the
   flash body, one causal launch a shard over the gathered sequence) on a
   4-shard seq mesh of the card against ``flash_attention`` in float32
   and bf16 (B=2, S=1024, H=4, D=64), output and q/k/v gradients within
   rtol 1e-3, atol 1e-4; the 110M tier with ``attention="ulysses"`` on a
   (1, 1, 4, 1) mesh against the flash model on the same seed-0 weights
   (first loss within 2e-5, every gradient within 0.08 relative, and
   whether they are bitwise equal), 5 steps each within 5e-5 of the flash
   run's loss with 32 causal launches of each kernel a step and none
   non-causal, ``train.main --attention ulysses`` for 2 steps, and the
   steps/s and peak memory beside the flash step's; (b) the flight
   recorder's fixture run (``python -m shockwave_tpu_torch.simulate -t
   traces/small_12_dynamic.trace -p shockwave_tpu_level -c 2:0:0 --seed 0
   --time_per_iteration 60`` with ``--metrics-out``, ``--trace-out``,
   ``--decision-log`` and ``--watchdog``, its level solves on the card)
   held to ``results/flight_recorder/``: metrics within 1e-3 in its 419
   rounds, 32 plan records whose windows are the committed log's, its 419
   round contexts, the committed counters and gauges that are current
   (``bench_sim.TELEMETRY_HELD``), and to the JAX package's CPU run of
   today (``bench_sim.TELEMETRY_FIXTURE``; the committed fixture predates
   its calibration scoring and market plane): the calibration summary
   within 1e-6, the market gauges and the alerts of the deterministic
   watchdog rules round for round (``solver_time`` reads wall seconds and
   is reported); then the same run with every plane off, whose plans and
   round log must equal the planes-on run's, both wall times printed; (c)
   phase 14's golden ``--cells 2 --speculate`` run and phase 15's churned
   pdhg run write their decision logs and metrics dumps, their pins
   holding as before; (d) ``python -m shockwave_tpu_torch.obs.recorder
   replay`` (its ``main``) of the logs of (b) and (c) and of the JAX
   package's two committed logs with the solves on the card, every plan
   diff empty, with the records replayed and the seconds taken; (e)
   ``explain.narrative_from_records`` over ``results/explain/
   decisions.jsonl`` equal to ``narratives.json``, and a coherent
   narrative for every job of (c)'s cells log. It prints one JSON line
   ``{"telemetry": ...}``; the causal flash rows of item 10's line carry
   the Ulysses run's launches (``ulysses_launches``).
17. Drives the physical control plane (``run_physical_plane``) through
   the card driver's loop (``tools/physical_drivers.py::
   run_physical_cluster``): a ``PhysicalScheduler`` in this process (policy
   ``shockwave_tpu_pdhg``, planner on the card, ``speculate`` on, rounds
   of 25 s) and one worker agent started by
   its CLI (``python -m shockwave_tpu_torch.runtime.worker -t h100 -n
   2``), whose two slots share card 0. The planner plans from phase 20's
   oracle. Three jobs ``Transformer (batch size 8)`` at the 110M tier's
   widths, cut to 4 layers, are submitted through ``SubmitterClient`` (the
   SubmitJobs RPC) and the stream is closed; the card driver sizes their
   steps from the oracle (``localize_jobs``: its rate x 0.5 x the
   seconds that make ``PHYSICAL_JOB_EPOCHS`` epochs). The phase has the
   time the smoke has
   left of its 1200 s, less phase 18's reserve and the exit margin. Fails
   unless every
   job completes with at least its steps and held workers in two rounds
   or more, the scheduler preempted a job (it lost its slot at a round
   boundary), every job ran in two attempts or more (its process stopped
   before the job's end, at a preemption or at its lease's end) and
   every later attempt printed ``RESUMED`` from its checkpoint, every
   attempt's summary line names ``device=cuda``, kernel A launched in
   this process, at least one background speculative solve launched on
   the planner's own stream (not the card's default stream), and no
   scheduler or worker thread raised. Prints the phase's seconds, the
   planner's solve seconds, the payloads' relaunch
   phases (mean over attempts) and the launches of kernel A and of the
   flash kernels, with the card's name and power limit.
18. Drives the survivable control plane's failover drill
   (``run_failover``; ``shockwave_tpu_torch/tools/ha_smoke.py``'s
   hot-standby and cold-restart arms): two synthetic agents
   (``runtime.worker --ha_dir --device cuda``), both scheduler nodes
   ``python -m shockwave_tpu_torch.ha.standby --device cuda --policy
   shockwave_tpu_pdhg`` subprocesses, six jobs through SubmitJobs, the
   leader SIGKILLed by the seeded ``scheduler_crash``. Fails unless, in
   each arm, the leader exits by SIGKILL after its first round, the
   successor takes the lease at epoch 2 on its own port with the
   ``sched_fault`` marker in its restored tail, loses no worker, completes all 6 jobs once with their steps,
   dedups the first token resent across the failover (6 jobs admitted),
   launches kernel A on the card after its restore, and no node or agent
   log holds a traceback. Prints each arm's ``takeover_s``, the journal's
   ``last_lsn`` and checkpoint seq and the makespan with the card's name
   and power limit, and one JSON line ``{"failover": ...}``; its logs are
   under ``_smoke_out/failover/``.

19. Drives every family of the training payload and the Transformer's
   memory options (``run_families``, run after phase 16 and before phase
   21): (a) ``train.main`` on the card for ResNet-18 at batch 256,
   ResNet-50 at 16, LM at 10, Recommendation at 8192 (the golden trace's
   largest batch of each), A3C and CycleGAN at 32: 3 steps with a
   checkpoint, then a resumed step; fails unless every summary line names
   ``device=cuda``, every loss is finite, the first loss equals the same
   step's on the card host's CPU within 1e-4 relative, and the resumed
   run prints ``RESUMED ... at step 3``; one step of each profiled (its
   kernels and the card's idle share); Recommendation again with
   ``--ckpt_backend orbax`` (a directory checkpoint, resumed at step 3).
   (b) The MoE tier (the 110M tier's widths with 4 experts of d_ff 4096,
   grouped dispatch, capacity 1.25; 312,543,232 parameters, held) through
   ``train.build_family``: 5 steps, fails unless the losses are finite,
   each flash kernel launched 8 times a step, and the first loss within
   2e-2 of the same weights' under dense attention on the card. (c) The
   same weights with ``remat`` and ``logit_chunk=512``, 2 steps: the first
   loss within 2e-2 of (b)'s, and a peak memory below (b)'s. Prints each
   family's steps/s, the MoE tier's steps/s, peak memory and dropped-token
   share, and one JSON line ``{"families": ...}``; the flash rows of item
   10's line carry the MoE run's launches (``moe_launches``).

20. Measures the card's own oracle (``run_oracle``, after phase 7):
   ``tools/measure_throughput.measure_oracle`` (the slope method) on phase
   17's payload under its label ``Transformer (batch size 8)`` (flash, the
   110M widths at 4 layers) and on ``Recommendation (batch size 512)``,
   under the worker type ``h100``; writes ``_smoke_out/oracle/
   oracle_h100.json``, which ``read_throughputs`` must read back equal;
   fails unless the payload's rate is within a factor 2 of phase 6's
   probe scaled by layers (8 / 4) and each flash kernel launched in its
   measurement. Then one two-rank gang of the card driver's command
   (ResNet-18 at ``GANG_CPU_BATCH``, ``GANG_STEPS`` steps, ``--gang_device
   cpu``: both ranks on the host's CPU over gloo); fails unless both ranks
   exit 0 on the CPU and report the same finite losses. The flash rows of
   item 10's line carry the measurement's launches (``oracle_launches``).
21. Runs the chaos soak's reduced campaign (``run_chaos``;
   ``tools/chaos_soak.py --smoke``: 10 jobs on 4 GPUs, 80 target events,
   3 solver faults, seed 0) with the planner and the replays on the card;
   fails on any violated invariant (a lost job, a fault without its
   recovery in the injector or the decision log, a replay that diverges,
   no degraded round or a solve past the plan deadline) or unless kernel A
   launched once for each round the ladder degraded to pdhg. Prints the
   counts, both runs' makespan and worst FTF; kernels A's and B's rows of
   item 10's line carry the campaign's launches (``chaos_launches``).
22. Runs the soaks of the admission front door (``run_soaks``): (a) the
   streaming soak's reduced campaign (``tools/streaming_soak.py --smoke``:
   ``scripts/ci/churn_smoke.py``'s 14 jobs on 4 GPUs, 80 target churn
   events, 2 SubmitJobs and 2 solver faults, seed 0) under
   ``shockwave_tpu_pdhg`` with the planner and the replays on the card;
   fails on any violated invariant (a job lost or admitted twice,
   backpressure that never engaged or drained, the p99 replan past the
   round, a fault without its recovery, a replay that diverges) or unless
   kernel A launched once for each pdhg replan of both runs and for each
   replay of one; prints both runs' makespan and worst FTF. (b) The
   ingest soak's decode-parity gate (the scalar and the columnar decode
   through the SubmitJobs handler, byte-equal acks, equal drained jobs).
   (c) One repetition of the full-scale ingest campaign
   (``tools/ingest_soak.py``'s defaults: a columnar peer of 245760 jobs
   and a legacy peer of 16384, batch 1536, window 6, 8 client faults each)
   through the port's socket front door; fails unless no job is lost or
   admitted twice, every fault recovered, both peers moved jobs, the
   queue's p99 is within 150 ms and the rate reaches 60000 jobs/s (the
   JAX package's floors), and the pricing phase's 8 lanes convoy into
   fewer
   dispatches of kernel A's lane grid on the card with the audit
   bit-identical; prints the rate, the p99 and each peer's rate. Kernel
   A's row of item 10's line carries the phase's launches
   (``soak_launches``).
23. Runs gangs of the training program on card 0 (``run_gangs``), each
   rank ``python -m shockwave_tpu_torch.models.train`` over gloo (NCCL
   refuses two ranks on one card; each hop and collective goes through
   pinned host memory): (a) the 110M tier with ``--seq_parallel 2
   --attention ring``, 3 steps, and (b) with ``--attention ulysses``, 2
   steps; each fails unless both ranks name ``backend=gloo`` and
   ``device=cuda``, each launched each causal flash kernel 8 times a step
   (and under ring the second rank each non-causal one as often), the
   ranks' losses and parameters are equal, and each step's loss and the
   parameters rank 0 saved after the last are one process's over a
   two-place mesh of the card on the same weights and global batch:
   losses within ``RING_LOSS_RTOL`` on step 1 and ``RING_STEPS_RTOL`` on
   each, parameters within ``GANG_PARAMS_RTOL`` of that run's update
   (``GANG_PARAM_RTOL`` for the worst one), limits that a planted ring
   bug (one live hop without its K/V gradient) must fail; they and (d)
   resume the seed's weights from a step-0 checkpoint this process
   writes. (c) The MoE tier's widths cut to 2
   layers, two ranks of batch 4, 2 steps: the ranks equal, and the losses
   within ``MOE_GANG_RTOL`` of one process's on the global batch. The
   gangs run on card 0, one CPU thread a rank. (d) The 110M tier
   with ``--model_parallel 2`` (4 heads, half the MLP and the vocabulary a
   rank), ``GANG_MODEL_STEPS`` steps, and (e) the MoE tier's 2 layers
   with its 4 experts over "model" (2 a rank), at batches 4 and 8 from
   the seed (the ranks share the draw): each fails unless the ranks are equal,
   each launched each causal flash kernel once a layer a step on its own
   heads (8 a step in (d)), and each step's loss and the whole parameters rank
   0 saved (gathered over "model") are one process's on the same weights
   and batch, within ``MODEL_LOSS_RTOL``, ``MODEL_PARAMS_RTOL`` and
   ``MODEL_PARAM_RTOL`` (for (e) ``MODEL_MOE_*``), limits each of which
   (d) with one planted fault must fail: a gang whose first
   layer leaves its tensor-parallel input gradients unsummed over "model"
   (``planted_model_rank``). (f) ``parallel/pipeline.py::PipelinedLM`` at
   the 110M widths cut to 4 layers, 2 stages over a two-rank pipe gang, 4
   microbatches of 2, ``PIPE_STEPS`` AdamW steps (``pipe_rank``): every
   step's loss within ``PIPE_RTOL`` of one process's pipelined run, and
   the first within it of ``logits_sequential``'s. All of them run at once
   (fourteen processes), while this process computes the references. The
   flash rows of item 10's line carry (a)'s and (b)'s launches
   (``gang_seq_launches``) and (d)'s and (e)'s (``gang_model_launches``).

Phase 20 and then phase 17 run right after phase 7 (phase 17's long
rounds then leave the rest of the smoke its time), phases 21, 22 and 23
after phase 19, and phase 18 last. Phases 17 and 18 run to
deadlines (``phase_deadlines``): phase 17's leaves
phase 18 its reserve (``FAILOVER_RESERVE_S``, above its measured 63.6-84.2
s) and the smoke its exit margin, and phase 18's waits are bounded by what
is left of the 1200 s. Any failed phase exits nonzero without the last
line. It needs one card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "_smoke_ckpt"

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

SOURCE = "shockwave_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "shockwave_tpu/ops/flash_attention.py:285",
    "flash_dkv": "shockwave_tpu/ops/flash_attention.py:491",
    "flash_dq": "shockwave_tpu/ops/flash_attention.py:543",
    # Jitted XLA loops, not Pallas kernels: the planner's device work.
    "eg_pdhg": "shockwave_tpu/solver/eg_pdhg.py:121",
    "eg_relaxed": "shockwave_tpu/solver/eg_jax.py:121",
}
SOURCES = {
    "eg_pdhg": "shockwave_tpu_torch/ops/csrc/eg_pdhg.cu",
    "eg_relaxed": "shockwave_tpu_torch/ops/csrc/eg_relaxed.cu",
}
# Widths of the tiles the bf16 kernels walk (FWD_BN, DKV_BQ and DQ_BN in
# the source): a planted fault skips one such tile.
DKV_Q_TILE = 64
DQ_K_TILE = 128


# The phase that is running and the smoke's start, for fail()'s message.
PROGRESS = {"phase": "start-up", "started": time.time()}


def enter(phase: str) -> float:
    """Marks ``phase`` as the one running; returns the time."""
    PROGRESS["phase"] = phase
    return time.time()


def where() -> str:
    return (f"in phase {PROGRESS['phase']}, "
            f"{time.time() - PROGRESS['started']:.1f} s after the start")


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED {where()}: {message}", file=sys.stderr,
          flush=True)
    sys.exit(1)


def sync():
    torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def live_pairs(S: int, window, causal: bool = True, Sk=None) -> int:
    """(row, col) score entries the mask keeps: the causal (windowed) ones,
    or every one of S x Sk when not causal."""
    if not causal:
        return S * (S if Sk is None else Sk)
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def bound(kernel: str, bh: int, bhkv: int, S: int, D: int, dtype, window,
          causal: bool = True, Sk=None):
    """Least time (ms) for the kernel's work on an H100 SXM, and what
    bounds it: products over the live entries at the dtype's tensor rate,
    or each input read once and each output written once. q-like tensors
    have S rows, k/v (and dk/dv, per query head) Sk."""
    Sk = S if Sk is None else Sk
    products = {"flash_fwd": 2, "flash_dkv": 4, "flash_dq": 3}[kernel]
    flops = products * 2 * D * live_pairs(S, window, causal, Sk) * bh
    e = torch.tensor([], dtype=dtype).element_size()
    qlike, kvlike, rows = bh * S * D * e, bhkv * Sk * D * e, bh * S * 4
    nbytes = {
        "flash_fwd": qlike + 2 * kvlike + qlike + rows,
        "flash_dkv": 2 * qlike + 2 * kvlike + 2 * rows + 2 * bh * Sk * D * e,
        "flash_dq": 2 * qlike + 2 * kvlike + 2 * rows + qlike,
    }[kernel]
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# Kernels whose SASS must hold wgmma and TMA loads, at every head dim.
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_dkv_bf16", "flash_dq_bf16")


def kernel_of(mangled: str):
    """(kernel, head dim, causal) of a mangled instantiation such as
    ``..._14flash_fwd_bf16ILi128ELb1EEEv...``, or None for another
    symbol."""
    m = re.search(r"\d(flash_(?:fwd|dkv|dq)_(?:bf16|f32))ILi(\d+)ELb([01])E",
                  mangled)
    return (m.group(1), int(m.group(2)), m.group(3) == "1") if m else None


def inspect_library(_build, path):
    """Print registers, stack, shared and local memory of each kernel
    (cuobjdump -res-usage); fail unless the SASS of every instantiation of
    HOPPER_KERNELS holds HGMMA (wgmma) and UTMALDG (TMA tile load)
    instructions, or if the build log shows ptxas serialising wgmma
    instructions (it then waits on each product before the next, which
    the kernels' overlaps rely on it not doing). Returns
    {(kernel, D): {"REG": .., "STACK": .., ...}}."""
    serialized = [line.strip() for line in
                  path.with_suffix(".log").read_text().splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    for line in serialized:
        print(f"  {line}")
    if serialized:
        fail(f"ptxas serialised wgmma in {len(serialized)} function(s)")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")

    def dump(flag):
        return subprocess.run([str(cuobjdump), flag, str(path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    usage, current = {}, None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function"):
            current = kernel_of(line)
        elif current and "REG:" in line:
            usage[current] = {k: int(v) for k, v in
                              re.findall(r"(\w+):(\d+)", line)}
    print("kernel resources (cuobjdump -res-usage; LOCAL > 0 would be "
          "spills):")
    for (name, D, causal), u in sorted(usage.items()):
        print(f"  {name}<{D}, {'causal' if causal else 'non-causal'}>: "
              f"{u['REG']} registers, stack {u['STACK']} B, static shared "
              f"{u['SHARED']} B, local {u['LOCAL']} B")
    counts, current = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            current = kernel_of(line)
            counts.setdefault(current, {"HGMMA": 0, "UTMALDG": 0})
        elif current:
            for op in ("HGMMA", "UTMALDG"):
                counts[current][op] += op in line
    print("SASS of the bf16 kernels (cuobjdump -sass):")
    missing = []
    for name in HOPPER_KERNELS:
        for D in (16, 32, 64, 128):
            for causal in (True, False):
                c = counts.get((name, D, causal), {"HGMMA": 0, "UTMALDG": 0})
                label = f"{name}<{D}, {'causal' if causal else 'non-causal'}>"
                print(f"  {label}: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                      "UTMALDG")
                if not (c["HGMMA"] and c["UTMALDG"]):
                    missing.append(label)
    if missing:
        fail("no wgmma (HGMMA) or TMA (UTMALDG) instructions in "
             + ", ".join(missing))
    return usage


def check_kernels(fa, bench, label, seed, B, S, H, Hkv, D, dtype, window,
                  device, causal=True, Sk=None):
    """Each kernel against its plain version on the same inputs from
    ``seed``, under ``fa.KERNEL_TOLERANCE`` (``bench.check_kernels``).
    Prints the readings of every output and fails after the last if any
    broke a limit. Returns the largest absolute error of each kernel, and
    the inputs and plain outputs."""
    found, inputs, plain = bench.check_kernels(
        fa, fa, seed, B, S, H, Hkv, D, dtype, window, device, causal=causal,
        Sk=Sk)
    errors, broken = {}, []
    for (kernel, what), r in found.items():
        print(f"  {label} seed {seed} {kernel} {what}: " + bench.describe(r))
        if not r["ok"]:
            broken.append(f"{label} seed {seed} {kernel} {what}")
        errors[kernel] = max(errors.get(kernel, 0.0), r["max_abs_err"])
    if broken:
        fail("disagree with their plain versions: " + ", ".join(broken))
    return errors, inputs, plain


def planted_faults(fa, q, k, v, g, lse, delta, num_q_heads, causal=True):
    """What a kernel with one bug would return on these inputs (no window,
    as many KV heads as q heads, Sk = S, in the mode ``causal``), from the
    plain versions' math: the forward skipping the k tile at mid-sequence,
    dQ skipping the k tile there and dK/dV the q tile there, each of the
    width that kernel walks, and the forward weighting the later half of
    its rows 2% high. Returns {(output, fault): tensor}."""
    BH, S, D = q.shape
    dtype = q.dtype
    s = fa._masked_scores(q, k, num_q_heads, None, causal)
    s_skip = s.clone()
    s_skip[:, :, S // 2:S // 2 + fa._FWD_K_TILE] = -1e30
    p_skip = torch.softmax(s_skip, dim=-1)
    out_skip = (p_skip.to(dtype).float() @ v.float()).to(dtype)
    del s_skip, p_skip

    def grads(p):
        ds = (p * (g.float() @ v.float().transpose(1, 2) - delta[..., None]))
        return p.to(dtype).float(), ds.to(dtype).float()

    p = torch.exp(s - lse[..., None])
    del s
    p_cols = p.clone()
    p_cols[:, :, S // 2:S // 2 + DQ_K_TILE] = 0
    _, ds = grads(p_cols)
    dq = ((ds @ k.float()) / math.sqrt(D)).to(dtype)
    p[:, S // 2:S // 2 + DKV_Q_TILE, :] = 0
    p_rows, ds = grads(p)
    dv = (p_rows.transpose(1, 2) @ g.float()).to(dtype)
    dk = (ds.transpose(1, 2) @ q.float()).to(dtype)
    out_heavy = fa.flash_fwd_plain(q, k, v, num_q_heads, None,
                                   causal)[0].clone()
    out_heavy[:, S // 2:] = (out_heavy[:, S // 2:].float() * 1.02).to(dtype)
    return {("out", "k tile skipped"): out_skip, ("dq", "k tile skipped"): dq,
            ("dk", "q tile skipped"): dk, ("dv", "q tile skipped"): dv,
            ("out", "later rows 2% heavy"): out_heavy}


def check_planted_faults(fa, bench, inputs, plain, H, causal=True):
    """The tolerance, flip terms included, must reject every planted
    fault."""
    tol = fa.KERNEL_TOLERANCE[inputs[0].dtype]
    terms = fa.largest_terms(*inputs, H, None, causal)
    mode = "" if causal else "non-causal "
    for (what, fault), bad in planted_faults(fa, *inputs, H, causal).items():
        r = fa.compare(bad, plain[what], tol, terms[what])
        print(f"  planted fault, {mode}{what} with {fault}: "
              + bench.describe(dict(r, tol=tol)))
        if r["ok"]:
            fail(f"the tolerance accepts {what} with {fault}")
    sync()


def check_small_model(device):
    """A small model on the card: the flash kernels against the dense
    reference on the same weights, loss and every gradient, float32."""
    from shockwave_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    kw = dict(vocab_size=512, d_model=256, num_heads=2, num_layers=2,
              d_ff=1024, max_len=256)
    gen = torch.Generator().manual_seed(3)
    flash = TransformerLM(TransformerConfig(**kw, attention="flash"), gen)
    dense = TransformerLM(TransformerConfig(**kw, attention="dense"))
    dense.load_state_dict(flash.state_dict())
    flash.to(device), dense.to(device)
    tokens = torch.randint(0, 512, (2, 257), generator=gen).to(device)
    losses = []
    for model in (flash, dense):
        loss = lm_loss(model, tokens)
        loss.backward()
        losses.append(float(loss.detach()))
    sync()
    if not all(math.isfinite(x) for x in losses):
        fail(f"small model: non-finite loss {losses}")
    if abs(losses[0] - losses[1]) > 1e-4 * abs(losses[1]):
        fail(f"small model: flash loss {losses[0]} vs dense {losses[1]}")
    worst = 0.0
    for (name, p), q in zip(flash.named_parameters(), dense.parameters()):
        err = float((p.grad - q.grad).abs().max())
        scale = float(q.grad.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if err > 1e-3 * scale:
            fail(f"small model: gradient {name} off by {err} (scale {scale})")
    print(f"small model (f32, S=256, D=128): flash loss {losses[0]:.6f} "
          f"dense {losses[1]:.6f}; worst gradient error {worst:.2e} of max")


def train_args(steps: int, attention: str = "flash"):
    """The 110M tier's command line (its checkpoint in CKPT_DIR)."""
    return ["--model", "Transformer", "--batch_size", "8", "-n", str(steps),
            "--vocab_size", "8192", "--d_model", "1024", "--num_heads", "8",
            "--num_layers", "8", "--seq_len", "2048", "--attention", attention,
            "--dtype", "bfloat16", "--learning_rate", "1e-3", "--seed", "0",
            "--checkpoint_dir", str(CKPT_DIR), "--device", "cuda"]


def run_main_path(fa, train, steps: int, resume: bool):
    fa.reset_launch_counts()
    result = train.main(train_args(steps))
    launches = dict(fa.LAUNCHES)
    if result["resumed"] != resume:
        fail(f"expected resumed={resume}, got {result['resumed']}")
    losses = result["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"losses {losses}")
    for name, count in launches.items():
        expected = 0 if name.endswith("_nc") else 8 * steps
        if count != expected:
            fail(f"{name} launched {count} times in {steps} steps of an "
                 f"8-layer model, expected {expected}")
    return result, launches


# The ring phase: a 4-shard seq mesh of the one card. At the 110M tier's
# seq 2048 a shard holds 512 tokens, so a hop is B=8, Sq=Sk=512, H=8, D=128.
RING_SHARDS = 4
RING_GQA = dict(B=2, S=512, Sk=1024, H=4, Hkv=2, D=64)
# The ring 110M tier against the flash model on the same seed-0 weights and
# batches, bf16. On an H100 the first losses are 4.9e-6 apart (relative),
# the five steps' at most 1.1e-5, and every parameter's gradient on the
# first batch within 0.032 of the flash model's (relative Frobenius; the
# last layers' query and key weights, whose gradients are small at random
# weights). A live hop dropped or weighted twice, in every layer or in the
# last alone, moves some parameter's gradient by 0.125 or more, and the
# first loss by as little as 8e-6.
RING_LOSS_RTOL = 2e-5
RING_STEPS_RTOL = 5e-5
RING_GRAD_RTOL = 0.08


def check_ring_against_flash(device):
    """Ring attention (flash body, a RING_SHARDS-shard seq mesh of the
    card) against flash_attention on the same float32 inputs: output and
    q/k/v gradients within rtol 1e-3, atol 1e-4, the JAX package's limits
    for ring against dense (tests/test_ring_attention.py). Returns the
    largest absolute error."""
    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.parallel.mesh import make_mesh
    from shockwave_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh((1, 1, RING_SHARDS, 1), [device] * RING_SHARDS)
    gen = torch.Generator(device=device).manual_seed(0)
    B, S, H, Hkv, D = 2, 1024, 4, 2, 64
    inputs = [torch.randn(B, S, h, D, generator=gen, device=device)
              for h in (H, Hkv, Hkv)]
    w = torch.randn(B, S, H, D, generator=gen, device=device)
    results = []
    for attend in (lambda *a: ring_attention(*a, mesh, inner="flash"),
                   fa.flash_attention):
        leaves = [x.clone().requires_grad_() for x in inputs]
        out = attend(*leaves)
        (out * w).sum().backward()
        results.append([out.detach()] + [x.grad for x in leaves])
    sync()
    worst = 0.0
    for what, got, ref in zip(("out", "dq", "dk", "dv"), *results):
        err = (got - ref).abs()
        worst = max(worst, float(err.max()))
        over = int((err > 1e-4 + 1e-3 * ref.abs()).sum())
        if over or not bool(torch.isfinite(got).all()):
            fail(f"ring against flash: {what} has {over} elements past "
                 "rtol 1e-3, atol 1e-4")
    return worst


def loss_and_grads(model, batch):
    """The model's loss on ``batch`` and each parameter's gradient, in
    float32; leaves no gradient on the model."""
    from shockwave_tpu_torch.models.transformer import lm_loss

    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, batch)
    loss.backward()
    grads = {name: p.grad.float() for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def worst_grad_error(grads, ref):
    """(name, error) of the parameter whose gradient is furthest from
    ``ref``'s, in relative Frobenius norm."""
    errors = {name: float((grads[name] - g).norm() / g.norm().clamp_min(
        1e-30)) for name, g in ref.items()}
    name = max(errors, key=errors.get)
    return name, errors[name]


def ring_fault(attend, kind: str, layers, live: int):
    """``flash_attention_lse`` as the ring's flash body would see it with
    one bug: in each layer of ``layers`` (None: every layer) the last live
    hop (the last shard attending the first shard's block) is dropped
    (``kind`` "drop": its lse is -inf, so the merge gives it no weight) or
    weighted twice ("double": its lse raised by ln 2). ``live`` is the
    count of live hops a layer; a forward calls the body's non-causal
    hops layer by layer, each layer's in hop order."""
    calls = [0]

    def faulty(q, k, v, causal=True, window=None):
        out, lse = attend(q, k, v, causal=causal, window=window)
        if causal:
            return out, lse
        layer, hop = divmod(calls[0], live)
        calls[0] += 1
        if hop == live - 1 and (layers is None or layer in layers):
            lse = (torch.full_like(lse, -math.inf) if kind == "drop"
                   else lse + math.log(2.0))
        return out, lse

    return faulty


def run_ring(fa, bench, train, device, card, flash_losses):
    """The ring slice (docstring, item 7): the kernels against their
    plain versions at the ring's shapes with planted faults rejected, ring
    against flash, the 110M tier under ring attention (its first loss and
    gradients against the flash model's, planted hop faults rejected, 5
    steps against ``flash_losses``, the flash run's, and its launches),
    ``train.main --attention ring --seq_parallel 1`` for 2 steps, and the
    non-causal kernels timed. Returns the readings; fails on any miss."""
    from shockwave_tpu_torch.parallel import ring_attention as ra
    from shockwave_tpu_torch.parallel.mesh import make_mesh

    B, S, H, D = bench.HOP_SHAPE
    print(f"ring phase [{card}]: the kernels against their plain versions "
          "at the shapes the ring gives them:", flush=True)
    # Hop 0 of every shard is a causal launch at the hop shape.
    causal_errors = check_kernels(fa, bench, "ring-hop causal bf16", 0, B, S,
                                  H, H, D, torch.bfloat16, None, device)[0]
    errors, inputs, plain = check_kernels(
        fa, bench, "ring-hop bf16", 0, B, S, H, H, D, torch.bfloat16, None,
        device, causal=False)
    g = RING_GQA
    for dtype in (torch.bfloat16, torch.float32):
        label = f"gqa Sk!=Sq {'bf16' if dtype == torch.bfloat16 else 'f32'}"
        found = check_kernels(fa, bench, label, 0, g["B"], g["S"], g["H"],
                              g["Hkv"], g["D"], dtype, None, device,
                              causal=False, Sk=g["Sk"])[0]
        if dtype == torch.bfloat16:
            errors = {k: max(e, found[k]) for k, e in errors.items()}
    print("planted faults against the bf16 tolerance, non-causal (all must "
          "fail it):")
    check_planted_faults(fa, bench, inputs, plain, H, causal=False)
    del inputs, plain
    ring_err = check_ring_against_flash(device)
    print(f"ring ({RING_SHARDS} shards of one card, flash body) against "
          f"flash_attention, f32 B=2 S=1024 H=4 Hkv=2 D=64: out and q/k/v "
          f"gradients within rtol 1e-3 atol 1e-4, largest |err| "
          f"{ring_err:.3e} [{card}]", flush=True)

    # The flash model's loss and gradients on the seed-0 weights and first
    # batch, against the ring model's on the same.
    args = train.parse_args(train_args(5, "flash"))
    model, _, _, batch_fn = train.build_family("Transformer", args, device)
    first_batch = batch_fn(np.random.default_rng(args.seed))
    flash_loss, flash_grads = loss_and_grads(model, first_batch)
    del model

    args = train.parse_args(train_args(5, "ring"))
    mesh = make_mesh((1, 1, RING_SHARDS, 1), [device] * RING_SHARDS)
    model, step_fn, _, batch_fn = train.build_family("Transformer", args,
                                                     device, mesh)
    live = RING_SHARDS * (RING_SHARDS - 1) // 2
    ring_loss, grads = loss_and_grads(model, first_batch)
    grad_err = worst_grad_error(grads, flash_grads)
    del grads
    loss_err = abs(ring_loss - flash_loss) / abs(flash_loss)
    print(f"110M tier, first batch: ring loss {ring_loss!r} against flash's "
          f"{flash_loss!r} ({loss_err:.3e} relative, limit "
          f"{RING_LOSS_RTOL:g}); worst gradient {grad_err[0]} at "
          f"{grad_err[1]:.4f} relative (limit {RING_GRAD_RTOL:g}) [{card}]",
          flush=True)
    if loss_err > RING_LOSS_RTOL or grad_err[1] > RING_GRAD_RTOL:
        fail("ring 110M tier: first loss or gradients past their limits")
    print("planted hop faults against those limits (all must fail them):")
    last = args.num_layers - 1
    faults = {}
    for kind, layers in (("drop", None), ("drop", (last,)),
                         ("double", None), ("double", (last,))):
        attend = ra.flash_attention_lse
        ra.flash_attention_lse = ring_fault(attend, kind, layers, live)
        try:
            f_loss, f_grads = loss_and_grads(model, first_batch)
        finally:
            ra.flash_attention_lse = attend
        f_name, f_err = worst_grad_error(f_grads, flash_grads)
        del f_grads
        f_loss_err = abs(f_loss - flash_loss) / abs(flash_loss)
        what = (f"last live hop {'dropped' if kind == 'drop' else 'doubled'}"
                f" in {'every layer' if layers is None else f'layer {last}'}")
        faults[what] = {"loss_rel": f_loss_err, "worst_grad": f_name,
                        "worst_grad_rel": f_err}
        print(f"  {what}: loss {f_loss_err:.3e} relative, worst gradient "
              f"{f_name} at {f_err:.4f}")
        if f_loss_err <= RING_LOSS_RTOL and f_err <= RING_GRAD_RTOL:
            fail(f"the ring limits accept the {what}")
    del flash_grads

    np_rng = np.random.default_rng(args.seed)
    sync()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses = [step_fn(batch_fn(np_rng))]
    sync()
    start = time.perf_counter()
    for _ in range(args.num_steps - 1):
        losses.append(step_fn(batch_fn(np_rng)))
    sync()
    steady_s = (time.perf_counter() - start) / (args.num_steps - 1)
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del model, step_fn
    losses = [float(x) for x in losses]
    steps_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         flash_losses))
    print(f"110M tier, ring on a (1, 1, {RING_SHARDS}, 1) mesh of one card: "
          f"losses {losses} against the flash run's {flash_losses} (at most "
          f"{steps_err:.3e} relative, limit {RING_STEPS_RTOL:g}); "
          f"{1 / steady_s:.3f} steps/s after the "
          f"first ({args.batch_size * args.seq_len / steady_s:.0f} "
          f"tokens/s); peak memory {peak_gib:.2f} GiB; launches {launches} "
          f"[{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"ring 110M tier: losses {losses}")
    if len(losses) != len(flash_losses) or steps_err > RING_STEPS_RTOL:
        fail(f"ring 110M tier: losses {losses} against the flash run's "
             f"{flash_losses}, past {RING_STEPS_RTOL:g} of them")
    # A layer runs RING_SHARDS causal hops and P(P-1)/2 live non-causal
    # ones, forward and backward.
    layers, steps = args.num_layers, args.num_steps
    for name, count in launches.items():
        expected = layers * steps * (live if name.endswith("_nc")
                                     else RING_SHARDS)
        if count != expected:
            fail(f"ring 110M tier: {name} launched {count} times in {steps} "
                 f"steps, expected {expected}")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        fa.reset_launch_counts()
        one = train.main(train_args(2, "ring") + ["--seq_parallel", "1"])
        one_launches = dict(fa.LAUNCHES)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"train.main --attention ring --seq_parallel 1: losses "
          f"{one['losses']}, launches {one_launches} [{card}]", flush=True)
    if len(one["losses"]) != 2 or not all(math.isfinite(x)
                                          for x in one["losses"]):
        fail(f"train.main --attention ring: losses {one['losses']}")
    if one_launches != {name: 0 if name.endswith("_nc") else 2 * layers
                        for name in one_launches}:
        fail(f"train.main --attention ring --seq_parallel 1: launches "
             f"{one_launches}")

    ms, sdpa_fwd, sdpa_bwd = bench.time_kernels(fa, B, S, H, D,
                                                torch.bfloat16, device,
                                                causal=False)
    return {"max_abs_err": errors, "causal_max_abs_err": causal_errors,
            "ring_vs_flash_max_abs_err": ring_err,
            "flash_first_loss": flash_loss, "ring_first_loss": ring_loss,
            "first_loss_rel": loss_err, "worst_grad": grad_err[0],
            "worst_grad_rel": grad_err[1], "planted_hop_faults": faults,
            "losses": losses, "flash_losses": flash_losses,
            "losses_max_rel": steps_err,
            "steps_per_s": 1 / steady_s,
            "tokens_per_s": args.batch_size * args.seq_len / steady_s,
            "peak_gib": peak_gib, "launches": launches,
            "seq_parallel_1": {"losses": one["losses"],
                               "launches": one_launches},
            "ms": ms, "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd}


def run_simulation(device) -> dict:
    """Phases (a)-(d) of the simulation path (docstring, item 8); fails
    on any metric past its tolerance, a level solve off the card or
    counts that differ from the CPU's."""
    from shockwave_tpu_torch.tools import bench_sim as sim

    golden = {}
    for policy in ("shockwave_tpu_level", "shockwave_native"):
        plans = [] if policy == "shockwave_tpu_level" else None
        r = sim.run_trace(sim.GOLDEN_TRACE, policy, 8, device, plans=plans)
        if plans is not None:
            r["plans"] = plans
        print(f"golden trace, {policy}: makespan {r['makespan']:.3f} avg "
              f"JCT {r['avg_jct']:.3f} worst FTF {r['worst_ftf']:.3f}, "
              f"{r['rounds']} rounds, solves {r['solves']} on "
              f"{r['device_solves']}, {r['wall_s']:.2f} s", flush=True)
        bad = sim.check_run(r, sim.GOLDEN[policy])
        if bad:
            fail(f"golden trace under {policy}: " + ", ".join(bad))
        golden[policy] = r
    level = golden["shockwave_tpu_level"]
    if level["device_solves"] != {"cuda": 16} or level["solves"] != {
            "level": 16}:
        fail(f"golden level run: expected 16 level solves on cuda, got "
             f"{level['solves']} on {level['device_solves']}")

    problems = []
    tier = sim.run_trace(sim.TRACE_2048, "shockwave_tpu", 256, device,
                         capture=problems,
                         max_rounds=sim.TIER_2048_CUT["rounds"])
    print(f"2048-job tier's first {sim.TIER_2048_CUT['rounds']} rounds, "
          f"shockwave_tpu on 256 GPUs: makespan "
          f"{tier['makespan']:.3f} avg JCT {tier['avg_jct']:.3f} worst FTF "
          f"{tier['worst_ftf']:.3f}, {tier['rounds']} rounds; solves "
          f"{tier['solves']} taking {tier['solve_s']} s (level solves by "
          f"device {tier['device_solves']}); wall {tier['wall_s']:.2f} s",
          flush=True)
    bad = sim.check_run(tier, sim.TIER_2048_CUT)
    if bad:
        fail("2048-job tier: " + ", ".join(bad))
    on_card = tier["device_solves"].get("cuda", 0)
    if on_card == 0 or on_card != tier["solves"].get("level", 0):
        fail(f"2048-job tier: level solves {tier['solves']} but "
             f"{tier['device_solves']} by device")

    bad, report = sim.solve_report(device, problems, sim.SMOKE_ITERS,
                                   sim.SMOKE_NATIVE_ITERS,
                                   sim.SMOKE_TRACE_SAMPLE)
    if not bad:
        print(f"  (c) {report['check_s']:.1f} s, (d) "
              f"{report['timing_s']:.1f} s (medians of {sim.SMOKE_ITERS}, "
              f"on {sim.SMOKE_TRACE_SAMPLE} of the run's problems)",
              flush=True)
    if bad:
        fail("level solve on the card against the CPU's: " + "; ".join(bad))
    return {"golden": golden, "tier_2048": tier, **report}


# Phase 8 (e): the sharded level solve's places on card 0, the
# objective's tolerance against the one-card solve (its sum over jobs runs
# shard by shard), and the job counts of its timing.
SHARDED_PLACES = (1, 2, 4, 8)
SHARDED_OBJ_RTOL = 1e-5
SHARDED_TIMED_JOBS = (4096, 16384)


def tie_heavy_problem(J: int = 512):
    """tests/test_sharded_solver.py's tie-heavy problem (:41-67): every
    job identical, so every marginal density ties across shards."""
    from shockwave_tpu_torch.solver.eg_problem import EGProblem

    return EGProblem(
        priorities=np.full(J, 2.0), completed_epochs=np.full(J, 3.0),
        total_epochs=np.full(J, 10.0), epoch_duration=np.full(J, 100.0),
        remaining_runtime=np.full(J, 700.0), nworkers=np.full(J, 2.0),
        num_gpus=64, round_duration=120.0, future_rounds=10,
        regularizer=1.0, log_bases=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0]))


def run_sharded(device, card: str, level_golden: dict) -> dict:
    """Phase 8 (e) (docstring, item 8): the sharded level solve against
    the one-card solve, the golden trace under ``shockwave_tpu_sharded``
    against ``level_golden`` (phase 8 (a)'s level run, with its plans),
    then the timing it prints and does not hold."""
    from shockwave_tpu_torch.parallel.mesh import make_solve_mesh
    from shockwave_tpu_torch.solver import eg_level, eg_sharded
    from shockwave_tpu_torch.tools import bench_sim as sim

    tag = f"[{card}]"
    meshes = {p: make_solve_mesh([device] * p) for p in SHARDED_PLACES}
    cases = [(f"parity band {band}", sim.parity_problem(0, band, True),
              SHARDED_PLACES) for band in sim.PARITY_PER_BAND]
    cases.append(("tie-heavy, 512 jobs", tie_heavy_problem(),
                  SHARDED_PLACES))
    cases.append(("16384 jobs x 50 rounds x 4096 GPUs",
                  sim.stress_problem(16384, 50, 4096, seed=0), (8,)))
    checked = []
    for name, problem, places in cases:
        ref, ref_obj = eg_level.solve_level_counts(problem, device)
        for p in places:
            counts, obj = eg_sharded.solve_level_sharded(
                problem, mesh=meshes[p], device=device)
            rel = abs(obj - ref_obj) / max(abs(ref_obj), 1e-30)
            if not np.array_equal(counts, ref) or rel > SHARDED_OBJ_RTOL:
                fail(f"sharded level solve, {name}, {p} places: "
                     f"{int(np.sum(counts != ref))} counts differ from the "
                     f"one-card solve's, objective {obj!r} against "
                     f"{ref_obj!r} ({rel:.2e} relative, limit "
                     f"{SHARDED_OBJ_RTOL})")
            checked.append(dict(case=name, places=p, jobs=problem.num_jobs,
                                obj_rel_err=rel))
        print(f"  (e) sharded level solve, {name}: counts equal to the "
              f"one-card solve's at {', '.join(map(str, places))} places "
              f"of card 0 {tag}", flush=True)

    eg_sharded.SOLVES.clear()
    plans = []
    golden = sim.run_trace(sim.GOLDEN_TRACE, "shockwave_tpu_sharded", 8,
                           device, plans=plans)
    level_plans = level_golden["plans"]
    same_plans = len(plans) == len(level_plans) and all(
        r == lr and np.array_equal(Y, LY)
        for (r, Y), (lr, LY) in zip(plans, level_plans))
    metrics = ("makespan", "avg_jct", "worst_ftf", "rounds")
    if (any(golden[k] != level_golden[k] for k in metrics) or not same_plans
            or golden["solves"] != {"sharded": len(plans)}
            or eg_sharded.SOLVES["cuda"] != len(plans)):
        fail(f"golden trace under shockwave_tpu_sharded: "
             f"{ {k: golden[k] for k in metrics} } against the level run's "
             f"{ {k: level_golden[k] for k in metrics} }, plans equal "
             f"{same_plans}, solves {golden['solves']}, sharded solves by "
             f"device {dict(eg_sharded.SOLVES)}")
    print(f"  (e) golden trace under shockwave_tpu_sharded {tag}: makespan "
          f"{golden['makespan']:.3f} avg JCT {golden['avg_jct']:.3f} worst "
          f"FTF {golden['worst_ftf']:.3f}, {golden['rounds']} rounds, "
          f"{len(plans)} plans, each equal to the level run's; solves "
          f"{golden['solves']} on the card", flush=True)

    timing = []
    for jobs in SHARDED_TIMED_JOBS:
        problem = sim.stress_problem(jobs, 50, jobs // 4, seed=0)
        row = dict(jobs=jobs, future_rounds=50, num_gpus=jobs // 4)
        for label, solve in (
                ("one_card", lambda: eg_level.solve_level_counts(
                    problem, device)),
                ("sharded_8", lambda: eg_sharded.solve_level_sharded(
                    problem, mesh=meshes[8], device=device))):
            solve()
            row[f"{label}_ms"] = 1e3 * sim._median_s(solve, 3)
            row[f"{label}_launches"] = sim.device_profile(
                problem, device, solve)["launches"]
        timing.append(row)
        print(f"  (e) {jobs} jobs x 50 rounds x {jobs // 4} GPUs {tag}: "
              f"sharded at 8 places {row['sharded_8_ms']:.2f} ms, "
              f"{row['sharded_8_launches']} launches; one card "
              f"{row['one_card_ms']:.2f} ms, {row['one_card_launches']} "
              f"launches (median of 3, device head with its fetch; not "
              f"held)", flush=True)
    return dict(checked=checked, timing=timing,
                golden={k: golden[k] for k in (*metrics, "solves")},
                golden_plans=len(plans))


def check_resident(what: str, run: dict, kernel: str) -> None:
    """Fails unless every launch of ``kernel`` in ``run`` (a
    ``bench_sim.run_trace`` result) took a resident instantiation: the
    per-job state in shared memory."""
    variants = run["variants"][kernel]
    print(f"  {what}: {kernel} launches by instantiation {variants}",
          flush=True)
    if not variants or any(not v.endswith("-resident") for v in variants) \
            or sum(variants.values()) != run["launches"][kernel]:
        fail(f"{what}: {kernel} launched {variants}, not every launch "
             f"resident")


def run_first_order(device) -> dict:
    """Phases (a)-(d) of the first-order backends (docstring, item 9);
    fails on a plan that is not feasible, a window where pdhg falls below
    the level backend's bar, a metric past its tolerance, a kernel that
    disagrees with its plain version or repeats differently, a ladder that
    did not absorb the fault on its pdhg rung, or a kernel the main path
    did not launch. Returns the readings and each kernel's main-path
    launches."""
    from shockwave_tpu_torch.runtime import faults
    from shockwave_tpu_torch.solver import eg_pdhg as pdhg_solver
    from shockwave_tpu_torch.solver.eg_level import solve_eg_level
    from shockwave_tpu_torch.solver.eg_pdhg import solve_eg_pdhg
    from shockwave_tpu_torch.tools import bench_sim as sim

    # The device head of each pdhg solve (pack, copy, kernel A, fetch),
    # timed apart from the solve's host tail (rounding, polish, placement).
    head = {"s": 0.0}
    device_head = pdhg_solver.solve_pdhg_relaxed

    def timed_head(*args, **kwargs):
        start = time.perf_counter()
        try:
            return device_head(*args, **kwargs)
        finally:
            head["s"] += time.perf_counter() - start

    problems, plans = [], []
    pdhg_solver.solve_pdhg_relaxed = timed_head
    try:
        tier = sim.run_trace(sim.TRACE_2048, "shockwave_tpu_pdhg", 256,
                             device, capture=problems, plans=plans,
                             max_rounds=sim.TIER_2048_PDHG_CUT["rounds"])
    finally:
        pdhg_solver.solve_pdhg_relaxed = device_head
    tier["device_head_s"] = head["s"]
    launches = {"eg_pdhg": tier["launches"]["eg_pdhg"]}
    for problem, (round_index, Y) in zip(problems, plans):
        try:
            problem.audit_schedule(Y)
        except AssertionError as e:
            fail(f"2048-job tier under pdhg, round {round_index}: {e}")
    print(f"2048-job tier, shockwave_tpu_pdhg on 256 GPUs, its first "
          f"{sim.TIER_2048_PDHG_CUT['rounds']} rounds: makespan "
          f"{tier['makespan']:.3f} avg JCT {tier['avg_jct']:.3f} worst FTF "
          f"{tier['worst_ftf']:.3f}, {tier['rounds']} rounds; solves "
          f"{tier['solves']} taking {tier['solve_s']} s (device head "
          f"{head['s']:.3f} s, the rest the host tail), kernel A launched "
          f"{launches['eg_pdhg']} times; {len(plans)} plans audited; wall "
          f"{tier['wall_s']:.2f} s", flush=True)
    off = sim.check_run(tier, sim.TIER_2048_PDHG_CUT)
    print(f"  against the JAX package's run of the same rounds on the CPU "
          f"({sim.TIER_2048_PDHG_CUT}): "
          + (", ".join(off) if off else "within 1e-3"), flush=True)
    if off:
        fail("2048-job tier under pdhg against the JAX package's run: "
             + ", ".join(off))
    if tier["solves"] != {"pdhg": len(plans)} or launches["eg_pdhg"] < len(
            plans):
        fail(f"2048-job tier under pdhg: solves {tier['solves']}, kernel A "
             f"launches {launches}, {len(plans)} plans")
    check_resident("2048-job tier under pdhg", tier, "eg_pdhg")
    windows = sim.sample_by_jobs(problems, 8)
    vs_level = []
    for problem in windows:
        Y_pdhg = solve_eg_pdhg(problem, device=device)
        problem.audit_schedule(Y_pdhg)
        o_pdhg = problem.objective_value(Y_pdhg)
        o_level = problem.objective_value(solve_eg_level(problem, device))
        vs_level.append(dict(jobs=problem.num_jobs, pdhg=o_pdhg,
                             level=o_level))
        print(f"  window of {problem.num_jobs} jobs: pdhg objective "
              f"{o_pdhg!r}, level {o_level!r}", flush=True)
        if o_pdhg < o_level - 1e-3 * abs(o_level):
            fail(f"window of {problem.num_jobs} jobs: pdhg objective "
                 f"{o_pdhg} below level {o_level} by more than 1e-3")

    golden = {}
    for policy, expected in sim.GOLDEN_FIRST_ORDER.items():
        r = sim.run_trace(sim.GOLDEN_TRACE, policy, 8, device)
        print(f"golden trace, {policy}: makespan {r['makespan']:.3f} avg "
              f"JCT {r['avg_jct']:.3f} worst FTF {r['worst_ftf']:.3f}, "
              f"solves {r['solves']}, kernel launches {r['launches']}",
              flush=True)
        bad = sim.check_run(r, expected)
        if bad:
            fail(f"golden trace under {policy}: " + ", ".join(bad))
        check_resident(f"golden trace under {policy}", r,
                       "eg_pdhg" if policy.endswith("pdhg") else "eg_relaxed")
        golden[policy] = {k: r[k] for k in ("makespan", "avg_jct",
                                            "worst_ftf", "solves",
                                            "launches", "variants",
                                            "wall_s")}
    launches["eg_relaxed"] = golden["shockwave_tpu_relaxed"]["launches"][
        "eg_relaxed"]
    for name, count in launches.items():
        if count == 0:
            fail(f"the main path launched {name} no time")

    print("first-order kernels against their plain versions and their "
          f"sequential instantiations (seeded problems of "
          f"{sim.EG_CHECK_BANDS} jobs, 8 tier windows):", flush=True)
    checked = [sim.seeded_problem(jobs) for jobs in sim.EG_CHECK_BANDS]
    undetermined = []
    bad, max_err = sim.check_eg_kernels(checked + windows, device,
                                        undetermined)
    for u in undetermined:
        print(f"  {u['kernel']} on the {u['jobs']}-job problem: s "
              f"{u['s_err']!r} from the plain version, whose own run with "
              f"its start one float32 step up / down spreads "
              f"{u['plain_spread']}: s is not determined there, the "
              f"objective, the rounded objective and feasibility are held",
              flush=True)
    if bad:
        fail("first-order kernels against their plain versions or their "
             "sequential instantiations: " + "; ".join(bad))
    print(f"  both kernels within the limits on {len(checked + windows)} "
          f"problems, bitwise repeatable and equal to the sequential "
          f"instantiation in every bit; largest |s| error where float32 "
          f"determines s {max_err}", flush=True)

    faults.configure(faults.FaultPlan(
        seed=0, events=[faults.FaultEvent(0, "solver_timeout", round=0)]))
    try:
        r = sim.run_trace(sim.GOLDEN_TRACE, "shockwave_tpu", 8, device,
                          config={"plan_deadline_s": 30.0})
    finally:
        faults.reset()
    degraded = [rec for rec in r["records"] if rec.get("degraded")]
    print(f"ladder: golden trace under shockwave_tpu with a 30 s deadline "
          f"and one injected solver_timeout: degraded solves {degraded}",
          flush=True)
    if len(degraded) != 1 or degraded[0]["ladder"] != [
            {"backend": "tpu", "outcome": "timeout_injected"},
            {"backend": "pdhg", "outcome": "ok"}]:
        fail(f"ladder did not absorb the timeout on its pdhg rung: "
             f"{degraded}")
    print("first-order kernels timed, the wrapper's instantiation and the "
          f"sequential one in turns (CUDA events, median of {sim.EG_ITERS}; "
          f"plain: one run, up to {sim.EG_PLAIN_MAX_JOBS} jobs):", flush=True)
    started = time.time()
    timings = sim.time_eg_kernels(device, sim.SMOKE_EG_TIME_BANDS)
    timing_s = time.time() - started
    print(f"  (d): {timing_s:.1f} s (bands {sim.SMOKE_EG_TIME_BANDS})",
          flush=True)
    differ = [f"{r['kernel']} {r['jobs']} jobs" for r in timings
              if not r["identical"]]
    if differ:
        fail("instantiations that differ from the sequential one in some "
             "bit: " + ", ".join(differ))
    return {"tier_2048_pdhg": {k: tier[k] for k in (
                "makespan", "avg_jct", "worst_ftf", "rounds", "solves",
                "solve_s", "device_head_s", "launches", "wall_s")},
            "windows_vs_level": vs_level, "golden": golden,
            "max_abs_err": max_err, "s_undetermined": undetermined,
            "ladder": degraded,
            "timings": timings, "timing_s": timing_s, "launches": launches,
            # The tier's 8 windows, for phase 14 (dropped from the line).
            "windows": windows}


def run_gavel(device, card: str) -> dict:
    """Phases (a)-(d) of the Gavel round path (docstring, item 11); fails
    on any run past its tolerance."""
    import scipy

    from shockwave_tpu_torch.tools import bench_sim as sim
    from shockwave_tpu_torch.tools import scale_experiments as fig9

    tag = f"[{card}; scipy {scipy.__version__}]"
    runs = {}

    def check(label: str, r: dict, table: str, key=None) -> None:
        expected = sim.pinned(table, key, scipy.__version__)
        wall = r.get("wall_s", r.get("sim_wall_clock_s"))
        print(f"  {label}: makespan {r['makespan']:.3f} avg JCT "
              f"{r['avg_jct']:.3f} worst FTF {r['worst_ftf']:.3f} unfair "
              f"{r['unfair_fraction']:.1f}%, {r['rounds']} rounds; "
              f"{r['allocations']} allocations taking "
              f"{r['allocation_s']:.3f} s of {wall:.2f} s wall {tag}",
              flush=True)
        if (table, key) in sim.SCIPY_PINS.get(scipy.__version__, {}):
            print(f"    held to the JAX package's run under scipy "
                  f"{scipy.__version__}: {expected}", flush=True)
        bad = sim.check_run(r, expected)
        if bad:
            fail(f"{label} against the JAX package's run: " + ", ".join(bad))
        runs[label] = {k: r[k] for k in (
            "makespan", "avg_jct", "worst_ftf", "unfair_fraction", "rounds",
            "allocations", "allocation_s", "solves")}
        runs[label]["wall_s"] = wall

    print(f"Gavel round path {tag}:", flush=True)
    for policy in sim.GOLDEN_GAVEL:
        check(f"golden trace, {policy} on 8 GPUs",
              sim.run_trace(sim.GOLDEN_TRACE, policy, 8, device),
              "GOLDEN_GAVEL", policy)
    for policy, gpus in sim.FIGURE9:
        check(f"Figure 9, {policy} on {gpus} GPUs",
              fig9.run_cell(sim.TRACE_220, policy, gpus, device=device),
              "FIGURE9", (policy, gpus))
    check("2048-job tier, max_min_fairness on 256 GPUs",
          sim.run_trace(sim.TRACE_2048, "max_min_fairness", 256, device),
          "TIER_2048_MMF")
    for policy in sim.HETERO:
        check(f"v100:16 p100:16 k80:16, {policy}",
              sim.run_trace(sim.TRACE_220, policy, 16, device,
                            cluster=sim.HETERO_CLUSTER, gpus_per_server=4),
              "HETERO", policy)

    for title, kind in (("Figure 9", lambda l: "Figure 9" in l or "2048" in l),
                        ("heterogeneous", lambda l: l.startswith("v100"))):
        print(f"{title} table {tag}: run | makespan | avg JCT | worst FTF "
              f"| unfair %", flush=True)
        for label, r in runs.items():
            if kind(label):
                print(f"  {label} | {r['makespan']:.3f} | "
                      f"{r['avg_jct']:.3f} | {r['worst_ftf']:.3f} | "
                      f"{r['unfair_fraction']:.1f}", flush=True)
    pairs = {f"220 jobs, {gpus} GPUs": (
        f"Figure 9, shockwave_tpu on {gpus} GPUs",
        f"Figure 9, max_min_fairness on {gpus} GPUs") for gpus in (64, 128,
                                                                    256)}
    ratios = {}
    for cell, (sw, mmf) in pairs.items():
        r = ratios[cell] = {k: runs[sw][k] / runs[mmf][k]
                            for k in ("makespan", "avg_jct", "worst_ftf")}
        print(f"  shockwave_tpu / max_min_fairness, {cell}: makespan "
              f"{r['makespan']:.4f}, avg JCT {r['avg_jct']:.4f}, worst FTF "
              f"{r['worst_ftf']:.4f} {tag}", flush=True)
    return {"runs": runs, "ratios": ratios, "scipy": scipy.__version__}


# Host work that runs beside phase 17, whose rounds leave the host most of
# its cores: phases 11 and 13 (their LPs, assignments and MILPs on the
# host; the card only for Figure 9's Shockwave cells and the MILP window's
# level and pdhg solves) in one process, and phase 12's --cells 4 tier (its
# planner's host tail; its device head is 2.3 s of its minute) in another;
# the tier's device head is read beside phase 17's payloads on the card.
# Work that keeps the card busy stays out: phase 9's checks there put
# phase 17's first leases at 20-31 s and its rounds at 12, not 9 (PERF.md
# section 6).
HOST_PHASES = {"a": "12's tier", "b": "11 and 13"}
HOST_DIR = ROOT / "_smoke_out" / "host_phases"
HOST_PHASES_NICE = 10
HOST_PHASES_FLAG = "--host-phases"


def run_host_phases(group: str, device, card: str) -> None:
    """One group of :data:`HOST_PHASES`, as ``python chip_smoke.py
    --host-phases <group>`` runs it: its readings and seconds pickled
    into ``HOST_DIR / <group>.pkl``. It yields the host to phase 17, whose
    payloads' start-ups set its rounds (a start-up past a round costs the
    job that round)."""
    import pickle

    os.nice(HOST_PHASES_NICE)
    readings = {}
    if group == "a":
        started = enter("12 (the cells tier)")
        readings["cells_tier"] = run_cells_tier(device, card)
        readings["cells_tier"]["phase_s"] = time.time() - started
    else:
        started = enter("11 (Gavel)")
        readings["gavel"] = run_gavel(device, card)
        readings["gavel"]["phase_s"] = time.time() - started
        print(f"Gavel phase: {readings['gavel']['phase_s']:.1f} s [{card}]",
              flush=True)
        started = enter("13 (the policy library)")
        readings["library"] = run_library(device, card)
        readings["library"]["phase_s"] = time.time() - started
        print(f"policy library phase: {readings['library']['phase_s']:.1f} "
              f"s [{card}]", flush=True)
    with open(HOST_DIR / f"{group}.pkl", "wb") as f:
        pickle.dump(readings, f)


def start_host_phases() -> dict:
    """Starts each group of :data:`HOST_PHASES` in its own process, its
    output into ``HOST_DIR / <group>.log``; :func:`finish_host_phases`
    collects them."""
    shutil.rmtree(HOST_DIR, ignore_errors=True)
    HOST_DIR.mkdir(parents=True)
    procs = {}
    for group in HOST_PHASES:
        log = open(HOST_DIR / f"{group}.log", "w")
        procs[group] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), HOST_PHASES_FLAG,
             group], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log)
    return procs


def finish_host_phases(procs: dict, deadline: float) -> tuple:
    """Waits for every group (until ``deadline``), prints each one's
    output and returns (their readings merged, seconds waited)."""
    import pickle

    waited = time.time()
    readings = {}
    for group, (proc, log) in procs.items():
        try:
            proc.wait(timeout=max(deadline - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        print((HOST_DIR / f"{group}.log").read_text(), end="", flush=True)
        out = HOST_DIR / f"{group}.pkl"
        if proc.returncode != 0 or not out.exists():
            fail(f"phases {HOST_PHASES[group]} (their own process) ended "
                 f"with {proc.returncode}; their output is above")
        with open(out, "rb") as f:
            readings.update(pickle.load(f))
    return readings, time.time() - waited


# The cells-vs-global objective gap the cells market is held to
# (scripts/ci/cells_smoke.py:40, percent).
CELLS_GAP_PCT = 0.5
FLIGHT_LOG = ROOT / "results" / "flight_recorder" / "decisions.jsonl"
CELLS_STATE = ROOT / "_smoke_out" / "cells_tier_state.json"


def check_lanes_alone(what: str, launches) -> int:
    """Fails unless every lane of each recorded cells launch ((problems,
    s0s, keyword arguments, s list, objectives)) equals its own one-lane
    launch in every bit. Returns the lanes checked."""
    from shockwave_tpu_torch.cells import batched

    lanes = 0
    for problems, s0s, kwargs, s_list, objs in launches:
        for i, problem in enumerate(problems):
            s, obj, _ = batched.solve_cells_pdhg(
                [problem], None if s0s is None else [s0s[i]], **kwargs)
            if not (np.array_equal(s[0], s_list[i]) and obj[0] == objs[i]):
                fail(f"{what}: lane {i} of {len(problems)} differs from its "
                     "one-lane launch")
            lanes += 1
    return lanes


def frozen_state(planner) -> dict:
    """``planner.state_dict()`` that later rounds cannot change: the
    state dict shares each job's metadata fields, of which only the
    throughput schedule is updated in place."""
    state = planner.state_dict()
    for child in state["children"].values():
        for md in child["job_metadata"].values():
            md["throughput_schedule"] = dict(md["throughput_schedule"])
    return state


# Phase 12's lane meshes: the quality A/B's lanes over card 0 in these
# many places, and what-if grid (a)'s over four.
CELLS_MESH_PLACES = (2, 4)
WHATIF_MESH_GRID = "a"
WHATIF_MESH_PLACES = 4


def run_cells(device, card: str, tier: dict) -> dict:
    """Phase 12 (docstring, item 12): the cells market and the what-if
    fleet on kernel A's lane grid; fails on any lane that differs in a bit
    from its one-lane launch, a gap past CELLS_GAP_PCT, a plan that is not
    feasible, or a tier metric past its tolerance. ``tier`` is
    :func:`run_cells_tier`'s (the ``--cells 4`` tier, run beside phase
    17), whose state at its most incomplete jobs is in ``CELLS_STATE``."""
    from shockwave_tpu_torch.cells import batched
    from shockwave_tpu_torch.obs import recorder
    from shockwave_tpu_torch.ops import eg_pdhg as kernel
    from shockwave_tpu_torch.parallel.mesh import make_solve_mesh
    from shockwave_tpu_torch.solver import eg_pdhg as pdhg_solver
    from shockwave_tpu_torch.solver.eg_level import num_slots_for
    from shockwave_tpu_torch.tools import bench_sim as sim
    from shockwave_tpu_torch.tools import whatif as wcli
    from shockwave_tpu_torch.whatif import (ScenarioBatch,
                                            base_problem_from_log,
                                            base_problem_from_state,
                                            solve_scenarios)

    tag = f"[{card}]"
    readings = {}

    # (i) The quality A/B: one global launch, one 8-lane launch.
    g = sim.stress_problem(1000, 50, 256, seed=0)
    cells, indices = sim.split_cells(g, 8)
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    Y_global = pdhg_solver.solve_eg_pdhg(g, device=device)
    global_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_list, objs, diags = batched.solve_cells_pdhg(cells, device=device)
    cells_s = time.perf_counter() - t0
    ab_launches = kernel.LAUNCHES["eg_pdhg"]
    if ab_launches != 2 or diags[0]["lanes"] != 8:
        fail(f"quality A/B: {ab_launches} launches, lanes {diags[0]}")
    slots = num_slots_for(max(c.num_jobs for c in cells))
    check_lanes_alone("quality A/B", [(cells, None, {"slots": slots,
                                                     "device": device},
                                       s_list, objs)])
    merged = np.zeros_like(Y_global)
    for cell, idx, s in zip(cells, indices, s_list):
        merged[idx] = batched.schedule_cell(cell, s, device)
    try:
        g.audit_schedule(Y_global)
        g.audit_schedule(merged)
    except AssertionError as e:
        fail(f"quality A/B: a schedule is not feasible for the global "
             f"problem: {e}")
    obj_g, obj_c = g.objective_value(Y_global), g.objective_value(merged)
    gap_pct = 100.0 * (obj_g - obj_c) / abs(obj_g)
    packed = torch.from_numpy(pdhg_solver.pack_problems(
        cells, [None] * 8, slots, pdhg_solver.DEFAULT_TOL,
        pdhg_solver._STALL_REL)).to(device)
    out = kernel.pdhg(packed, pdhg_solver.DEFAULT_MAX_CYCLES,
                      pdhg_solver.DEFAULT_INNER_ITERS).cpu().numpy()
    worst = 0.0
    for b, cell in enumerate(cells):
        plain = pdhg_solver._pdhg_core(
            packed[b], pdhg_solver.DEFAULT_MAX_CYCLES,
            pdhg_solver.DEFAULT_INNER_ITERS).cpu().numpy()
        J = cell.num_jobs
        misses = sim.eg_misses(cell, out[b, :J].astype(np.float64),
                               float(out[b, slots]),
                               plain[:J].astype(np.float64),
                               float(plain[slots]))
        if misses:
            fail(f"quality A/B lane {b} against the plain version: {misses}")
        worst = max(worst, float(np.abs(out[b, :J] - plain[:J]).max()))
    grid8 = sim.time_lane_grid(packed)
    # The 8 lanes over card 0 in 2 and in 4 places: one launch a place,
    # each lane the single launch's in every bit.
    mesh_launches = {}
    for places in CELLS_MESH_PLACES:
        kernel.reset_launch_counts()
        s_mesh, objs_mesh, _ = batched.solve_cells_pdhg(
            cells, mesh=make_solve_mesh([device] * places, "cells"),
            device=device)
        mesh_launches[places] = kernel.LAUNCHES["eg_pdhg"]
        differ = [i for i in range(len(cells))
                  if not np.array_equal(s_mesh[i], s_list[i])
                  or objs_mesh[i] != objs[i]]
        if differ or mesh_launches[places] != places:
            fail(f"quality A/B over {places} places of card 0: lanes "
                 f"{differ} differ from the single launch's, "
                 f"{mesh_launches[places]} launches")
    print(f"cells quality A/B (1000 jobs x 256 GPUs x 50 rounds, 8 cells) "
          f"{tag}: objective global {obj_g!r}, cells {obj_c!r}, gap "
          f"{gap_pct:.6f}% (limit {CELLS_GAP_PCT}%); merged schedule "
          f"feasible; global solve {global_s:.3f} s, 8 cells "
          f"{cells_s:.3f} s; {ab_launches} launches (1 global, 1 of 8 "
          f"lanes); every lane equal to its one-lane launch; lanes against "
          f"the plain version within the limits, largest |s| error "
          f"{worst}; over {' and '.join(map(str, CELLS_MESH_PLACES))} "
          f"places of card 0, {mesh_launches} launches, every lane the "
          f"single launch's", flush=True)
    if gap_pct > CELLS_GAP_PCT:
        fail(f"quality A/B: gap {gap_pct}% > {CELLS_GAP_PCT}%")
    readings["quality_ab"] = dict(
        objective_global=obj_g, objective_cells=obj_c, gap_pct=gap_pct,
        global_solve_s=global_s, cells_solve_s=cells_s,
        launches=ab_launches, max_abs_err=worst, grid=grid8,
        mesh_launches=mesh_launches)

    # (ii) The golden trace under two cells against the JAX package's
    # run, then the 2048-job tier through the CLI.
    golden = sim.run_trace(sim.GOLDEN_TRACE, "shockwave_tpu_pdhg", 8, device,
                           config={"cells": 2})
    print(f"golden trace, shockwave_tpu_pdhg --cells 2 on 8 GPUs {tag}: "
          f"makespan {golden['makespan']:.3f} avg JCT "
          f"{golden['avg_jct']:.3f} worst FTF {golden['worst_ftf']:.3f}, "
          f"{golden['rounds']} rounds, solves {golden['solves']}, kernel A "
          f"launched {golden['launches']['eg_pdhg']} times", flush=True)
    bad = sim.check_run(golden, sim.GOLDEN_CELLS)
    if bad or not golden["launches"]["eg_pdhg"]:
        fail("golden trace under --cells 2 against the JAX package's run: "
             + ", ".join(bad or ["no launch of kernel A"]))
    readings["golden"] = {k: golden[k] for k in (
        "makespan", "avg_jct", "worst_ftf", "rounds", "solves", "launches")}
    readings["tier"] = tier

    # (iii) The what-if fleet through its CLI: (a) round 91 of the
    # committed log on the JAX package's 1024-scenario fleet; (b) the
    # tier's state at its most incomplete jobs, 65 scenarios.
    fleet_lists = [",".join(f"{x:g}" for x in values) for values in (
        wcli.FLEET_CAPACITIES, wcli.FLEET_PRIORITY_SCALES,
        wcli.FLEET_SWITCH_SCALES)]
    grids = {
        "a": (["--log", str(FLIGHT_LOG), "--round", "91"], fleet_lists,
              f"round 91 of {FLIGHT_LOG.relative_to(ROOT)}"),
        "b": (["--state", str(CELLS_STATE)],
              ["128,192,256,320", "0.5,1,2,4", "0,0.5,1,2"],
              f"the cells tier's state at round {tier['state_round']} "
              f"({tier['state_jobs']} incomplete jobs)"),
    }
    fleet = {}
    for name, (source_args, (caps, pscales, sscales), source) in grids.items():
        out_path = ROOT / "_smoke_out" / f"whatif_grid_{name}.json"
        kernel.reset_launch_counts()
        rc = wcli.main(["sweep", *source_args, "--capacity", caps,
                        "--priority-scale", pscales, "--switch-scale",
                        sscales, "--out", str(out_path)])
        grid_launches = kernel.LAUNCHES["eg_pdhg"]
        with open(out_path) as f:
            report = json.load(f)
        if rc != 0 or not report["audit"]["bit_identical"] or report[
                "audit"]["audited"] != report["timing"]["scenarios"]:
            fail(f"what-if grid ({name}): audit {report['audit']}")
        if name == "a":
            base, _, warm, _ = base_problem_from_log(str(FLIGHT_LOG),
                                                     round_index=91)
        else:
            base, _, warm = base_problem_from_state(recorder.load_exported_state(
                str(CELLS_STATE))["planner_state"])
        grid = wcli.build_grid(base, caps, pscales, sscales)
        batch = ScenarioBatch(base, grid, s0=warm)
        timing = sim.time_lane_grid(torch.from_numpy(batch.packed()).to(
            device))
        if timing["differ"]:
            fail(f"what-if grid ({name}): lanes {timing['differ'][:8]} "
                 "differ from their one-lane launches")
        sync()
        t0 = time.perf_counter()
        single = solve_scenarios(batch, device=device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        mesh_launches = None
        if name == WHATIF_MESH_GRID:
            # The grid's lanes over card 0 in 4 places: one launch a
            # place (a chunk), each lane the single launch's in every bit.
            kernel.reset_launch_counts()
            meshed = solve_scenarios(batch, mesh=make_solve_mesh(
                [device] * WHATIF_MESH_PLACES, "scenarios"), device=device)
            mesh_launches = kernel.LAUNCHES["eg_pdhg"]
            differ = [i for i in range(batch.lanes)
                      if not np.array_equal(meshed[0][i], single[0][i])
                      or meshed[1][i] != single[1][i]]
            if differ or mesh_launches < WHATIF_MESH_PLACES:
                fail(f"what-if grid ({name}) over {WHATIF_MESH_PLACES} "
                     f"places of card 0: lanes {differ[:8]} differ from "
                     f"the single launch's, {mesh_launches} launches")
            print(f"what-if grid ({name}) over {WHATIF_MESH_PLACES} places "
                  f"of card 0 {tag}: {batch.lanes} lanes in "
                  f"{mesh_launches} launches, every lane the single "
                  f"launch's", flush=True)
        t = report["timing"]
        fleet[name] = dict(source=source, jobs=base.num_jobs,
                           scenarios=t["scenarios"], lanes=t["lanes"],
                           chunk=t["chunk"], slots=t["slots"],
                           launches=grid_launches,
                           scenarios_per_s=t["scenarios_per_s"],
                           batch_solve_s=t["batch_solve_s"],
                           one_by_one_s=report["audit"]["one_by_one_s"],
                           audited=report["audit"]["audited"], grid=timing,
                           solve_wall_ms=wall_ms,
                           busy_share=timing["ms"] / wall_ms,
                           mesh_launches=mesh_launches)
        print(f"what-if grid ({name}), {source}: {base.num_jobs} jobs x "
              f"{t['scenarios']} scenarios in {t['lanes']} lanes "
              f"({t['chunk']} a launch, {t['slots']} slots) {tag}: "
              f"{t['scenarios_per_s']:.1f} scenarios/s (batch "
              f"{t['batch_solve_s']:.4f} s; the {report['audit']['audited']} "
              f"lanes one by one {report['audit']['one_by_one_s']:.4f} s); "
              f"kernel A {timing['ms']:.4f} ms for the grid against "
              f"{timing['one_by_one_ms']:.4f} ms for its lanes one by one "
              f"(bound {timing['bound_ms']:.5f} ms by {timing['bound_by']}; "
              f"slowest lane {timing['max_cycles']} cycles); the card busy "
              f"{timing['ms']:.4f} of {wall_ms:.4f} ms of a solve_scenarios "
              f"call ({100 * timing['ms'] / wall_ms:.1f}%); "
              f"{grid_launches} launches by the CLI; every lane equal to "
              f"its one-lane launch", flush=True)
    readings["whatif"] = fleet
    return readings


def run_cells_tier(device, card: str) -> dict:
    """Phase 12's ``--cells 4`` tier (docstring, item 12 (ii)): every cell
    plan audited, every lane equal to its one-lane launch, the metrics
    within the JAX package's run of the same rounds; its state at its most
    incomplete jobs written to ``CELLS_STATE``. Its readings."""
    from shockwave_tpu_torch import simulate
    from shockwave_tpu_torch.cells import batched
    from shockwave_tpu_torch.cells.planner import CellPlanner
    from shockwave_tpu_torch.obs import recorder
    from shockwave_tpu_torch.ops import eg_pdhg as kernel
    from shockwave_tpu_torch.tools import bench_sim as sim

    tag = f"[{card}]"
    launches, head, audited = [], {"s": 0.0}, {"plans": 0}
    snapshot = {"jobs": -1}
    real_solve = batched.solve_cells_pdhg
    real_write = CellPlanner._write_schedules
    real_round = CellPlanner.current_round_schedule

    def recording(problems, s0s=None, **kwargs):
        start = time.perf_counter()
        s, o, d = real_solve(problems, s0s, **kwargs)
        head["s"] += time.perf_counter() - start
        launches.append((list(problems), None if s0s is None else [
            None if x is None else np.array(x) for x in s0s],
            {k: kwargs[k] for k in ("tol", "max_cycles", "inner_iters",
                                    "slots", "device")}, s, o))
        return s, o, d

    def auditing(self, built, solved):
        real_write(self, built, solved)
        for name, info in solved.items():
            try:
                built[name][0].audit_schedule(info["Y"])
            except AssertionError as e:
                fail(f"cells tier, round {self.round_index}, cell {name}: "
                     f"{e}")
            audited["plans"] += 1

    def snapshotting(self):
        snapshot["planner"] = self
        incomplete = sum(1 for c in self.children.values()
                         for md in c.job_metadata.values()
                         if md.completed_epochs < md.total_epochs)
        if incomplete > snapshot["jobs"]:
            snapshot.update(jobs=incomplete, round=self.round_index,
                            state=frozen_state(self))
        return real_round(self)

    argv = [*sim.TIER_2048_CELLS_ARGS, "--max_rounds",
            str(sim.TIER_2048_CELLS_CUT["rounds"])]
    batched.solve_cells_pdhg = recording
    CellPlanner._write_schedules = auditing
    CellPlanner.current_round_schedule = snapshotting
    kernel.reset_launch_counts()
    try:
        tier = simulate.main(argv)
    finally:
        batched.solve_cells_pdhg = real_solve
        CellPlanner._write_schedules = real_write
        CellPlanner.current_round_schedule = real_round
    tier_launches = kernel.LAUNCHES["eg_pdhg"]
    lanes = [len(problems) for problems, *_ in launches]
    if tier_launches != len(launches) or not launches:
        fail(f"cells tier: {tier_launches} kernel launches for "
             f"{len(launches)} batched solves")
    solve_s = tier["solves"]
    tail_s = sum(r["seconds"] for r in snapshot["planner"]
                 .coord_solve_records) - head["s"]
    checked = check_lanes_alone("cells tier", launches)
    per_launch = {n: lanes.count(n) for n in sorted(set(lanes))}
    print(f"cells tier, python -m shockwave_tpu_torch.simulate "
          f"{' '.join(argv)} {tag}: makespan {tier['makespan']:.3f} avg JCT "
          f"{tier['avg_jct']:.3f} worst FTF {tier['worst_ftf']:.3f}, "
          f"{tier['rounds']} rounds; solves {solve_s}; kernel A launched "
          f"{tier_launches} times, lanes a launch {per_launch}; device head "
          f"{head['s']:.3f} s, host tail {tail_s:.3f} s; {audited['plans']} "
          f"cell plans audited; {checked} lanes equal to their one-lane "
          f"launches; wall {tier['wall_s']:.2f} s", flush=True)
    bad = sim.check_run(tier, sim.TIER_2048_CELLS_CUT)
    print(f"  against the JAX package's run of the same rounds on the CPU "
          f"({sim.TIER_2048_CELLS_CUT}): "
          + (", ".join(bad) if bad else "within 1e-3"), flush=True)
    if bad:
        fail("cells tier against the JAX package's run: " + ", ".join(bad))
    recorder.write_state(str(CELLS_STATE), snapshot["state"],
                         snapshot["round"], "cells", source=" ".join(argv))
    return dict(
        {k: tier[k] for k in ("makespan", "avg_jct", "worst_ftf", "rounds",
                              "solves", "wall_s")},
        launches=tier_launches, lanes_per_launch=per_launch,
        device_head_s=head["s"], host_tail_s=tail_s,
        plans_audited=audited["plans"], lanes_checked=checked,
        state_round=snapshot["round"], state_jobs=snapshot["jobs"])


def run_library(device, card: str) -> dict:
    """Item 13: the rest of the policy library (docstring); fails on a run
    past its pin, a pinned MILP solve stopped at its time limit, a policy
    that does not fail where the JAX package fails, or an infeasible card
    plan."""
    import scipy

    from shockwave_tpu_torch.tools import bench_sim as sim

    tag = f"[{card}; scipy {scipy.__version__}]"
    runs = {}
    milp_statuses = {}
    print(f"policy library {tag}:", flush=True)
    for table, key, args, kwargs in sim.library_runs():
        r = sim.run_trace(*args, device, **kwargs)
        label = f"{table} {key or args[1]}"
        expected = sim.pinned(table, key, scipy.__version__)
        print(f"  {label}: makespan {r['makespan']:.3f} avg JCT "
              f"{r['avg_jct']:.3f} worst FTF {r['worst_ftf']:.3f}, "
              f"{r['rounds']} rounds, {r['slo_violations']} SLO violations; "
              f"{r['allocations']} allocations taking "
              f"{r['allocation_s']:.3f} s of {r['wall_s']:.2f} s wall"
              + (f"; MILP solves by HiGHS status {r['milp_statuses']}"
                 if r["milp_statuses"] else "") + f" {tag}", flush=True)
        bad = sim.check_run(r, expected)
        if bad:
            fail(f"{label} against the JAX package's run: " + ", ".join(bad))
        if any(r["launches"].values()) or r["device_solves"]:
            fail(f"{label} launched a kernel or a device solve "
                 f"({r['launches']}, {r['device_solves']}): the library's "
                 "programs run on the host")
        for status, n in r["milp_statuses"].items():
            milp_statuses[status] = milp_statuses.get(status, 0) + n
        if r["milp_statuses"].get(1):
            fail(f"{label}: {r['milp_statuses'][1]} MILP solves stopped at "
                 "their time limit, so the pinned run hung on the clock")
        runs[label] = {k: r[k] for k in (
            "makespan", "avg_jct", "worst_ftf", "unfair_fraction", "rounds",
            "slo_violations", "allocations", "allocation_s",
            "milp_statuses", "wall_s")}
    print(f"  MILP solves by HiGHS status over the pinned runs (0 optimal "
          f"within the gap, 1 the time limit): {milp_statuses} {tag}",
          flush=True)
    # Where the JAX package fails, the port fails too: AlloX on the
    # trace's multi-GPU jobs, strategy-proof max-min on its
    # (allocation, discounts) result.
    failures = {}
    for policy, error in (("allox", ValueError),
                          ("max_min_fairness_strategy_proof",
                           (ValueError, RuntimeError))):
        try:
            sim.run_trace(sim.GOLDEN_TRACE, policy, 8, device)
        except error as e:
            failures[policy] = f"{type(e).__name__}: {e}"
            print(f"  {policy} on the golden trace fails as the JAX "
                  f"package's does: {failures[policy]}", flush=True)
        else:
            fail(f"{policy} completed the golden trace, where the JAX "
                 "package fails")
    try:
        window = sim.milp_window(device)
    except AssertionError as e:
        fail(f"a plan of the MILP window is infeasible: {e}")
    shape = "{num_jobs} jobs x {num_gpus} GPUs x {future_rounds} rounds, " \
        "seed {seed}".format(**window["problem"])
    for m in window["milp"]:
        print(f"  MILP window ({shape}): {sim.describe_milp(m)} {tag}",
              flush=True)
        if m["status"] != 0:
            fail(f"the MILP window's {m['formulation']} solve did not end "
                 f"optimal within its gap (status {m['status']})")
    for c in window["card"]:
        gaps = ", ".join(f"{100 * g:.5f}% against the {f} MILP"
                         for f, g in c["gap"].items())
        print(f"  MILP window: {c['backend']} on the card "
              f"{c['seconds']:.4f} s, objective {c['objective']:.4f} "
              f"(plan audited); above the MILP by {gaps} {tag}", flush=True)
    return {"runs": runs, "milp_statuses": milp_statuses,
            "fails_as_reference": failures, "milp_window": window,
            "scipy": scipy.__version__}


PLANNER_CKPT = ROOT / "_smoke_out" / "planner_220_pdhg.ckpt"


def pin_line(r: dict) -> str:
    return (f"makespan {r['makespan']:.3f} avg JCT {r['avg_jct']:.3f} worst "
            f"FTF {r['worst_ftf']:.3f}, {r['rounds']} rounds")


def planner_cell(sim, key: str, device, tag: str, **overrides) -> dict:
    """One cell of ``bench_sim.planner_runs`` on ``device``, held to the
    JAX package's run (``bench_sim.PLANNER``): metrics within 1e-3 in its
    rounds and, where pinned, the hit / repair / miss counts equal."""
    (args, kwargs), = [(a, k) for name, a, k in sim.planner_runs()
                       if name == key]
    kwargs = {**kwargs, **overrides}
    r = sim.run_trace(*args, device, **kwargs)
    print(f"  {key}: {pin_line(r)}; solves {r['solves']}"
          + (f" by pool {r['solves_by_pool']}" if r["solves_by_pool"] else "")
          + (f"; speculation {r['spec_stats']}, exposed planning "
             f"{r['exposed_plan_s']:.3f} s" if r["spec_stats"] and any(
                 r["spec_stats"].values()) else "")
          + f"; kernel A launched {r['launches']['eg_pdhg']} times; "
          f"{r['wall_s']:.2f} s {tag}", flush=True)
    bad = sim.check_run(r, sim.PLANNER[key])
    if bad:
        fail(f"planner cell {key} against the JAX package's run: "
             + ", ".join(bad))
    return r


def run_planner(device, card: str, windows) -> dict:
    """Phase 14 (docstring, item 14): the rest of the Shockwave planner on
    the card; fails on any run past the JAX package's, a resumed run that
    differs from the run that saved, a speculative run that differs from
    its serial run or the JAX package's counts, a lane that differs from
    its one-lane launch, a greedy schedule that is infeasible, below the
    native greedy's bar or off the CPU's, or a dual report that differs
    from the host's."""
    from shockwave_tpu_torch import native
    from shockwave_tpu_torch.cells import batched
    from shockwave_tpu_torch.ops import eg_pdhg as kernel
    from shockwave_tpu_torch.solver import duals
    from shockwave_tpu_torch.solver import eg_pdhg as pdhg_solver
    from shockwave_tpu_torch.solver.eg_level import num_slots_for
    from shockwave_tpu_torch.tools import bench_sim as sim

    tag = f"[{card}]"
    readings, launches = {}, {}
    print(f"planner phase {tag}:", flush=True)

    # (a) Checkpoints: save once 110 jobs were admitted and run on, then a
    # fresh scheduler resumes from the file; every solve on kernel A.
    PLANNER_CKPT.parent.mkdir(parents=True, exist_ok=True)
    PLANNER_CKPT.unlink(missing_ok=True)
    saving = planner_cell(sim, "checkpoint_save", device, tag,
                          checkpoint_file=str(PLANNER_CKPT))
    if not PLANNER_CKPT.exists():
        fail("the checkpointing run wrote no checkpoint")
    resumed = planner_cell(sim, "checkpoint_resume", device, tag,
                           checkpoint_file=str(PLANNER_CKPT))
    PLANNER_CKPT.unlink(missing_ok=True)
    if pin_line(resumed) != pin_line(saving) or (
            resumed["rounds"] != saving["rounds"]):
        fail(f"resumed run ({pin_line(resumed)}) differs from the run that "
             f"saved ({pin_line(saving)})")
    for what, r in (("saving", saving), ("resumed", resumed)):
        if set(r["solves"]) != {"pdhg"} or not r["launches"]["eg_pdhg"]:
            fail(f"checkpoint {what} run: solves {r['solves']}, kernel A "
                 f"launches {r['launches']}")
    launches["checkpoint"] = (saving["launches"]["eg_pdhg"]
                              + resumed["launches"]["eg_pdhg"])
    readings["checkpoint"] = {what: {k: r[k] for k in (
        "makespan", "avg_jct", "worst_ftf", "rounds", "solves", "launches",
        "wall_s")} for what, r in (("saving", saving), ("resumed", resumed))}

    # (b) Speculation. (i) The static smoke trace, serial and speculative:
    # the same rounds, every boundary a hit.
    smoke = {}
    for policy in ("shockwave_tpu", "shockwave_tpu_pdhg"):
        serial = sim.run_smoke_trace(policy, False, 0.0, device)
        spec = sim.run_smoke_trace(policy, True, 0.0, device)
        pin = sim.SPECULATE_SMOKE[(policy, 0.0)]
        print(f"  smoke trace at t0, {policy}: serial makespan "
              f"{serial['makespan']:.3f}, speculative "
              f"{spec['makespan']:.3f}, speculation {spec['spec_stats']} "
              f"{tag}", flush=True)
        if spec["rounds"] != serial["rounds"] or spec["spec_stats"] != (
                pin["spec_stats"]) or spec["spec_stats"]["hit"] < 1:
            fail(f"smoke trace under {policy}: the speculative rounds differ "
                 f"from the serial ones or a boundary was not a hit "
                 f"({spec['spec_stats']})")
        for r in (serial, spec):
            if abs(r["makespan"] - pin["makespan"]) > sim.TOLERANCE:
                fail(f"smoke trace under {policy}: makespan {r['makespan']} "
                     f"vs the JAX package's {pin['makespan']}")
        smoke[policy] = {"makespan": spec["makespan"],
                         "spec_stats": spec["spec_stats"],
                         "rounds": len(spec["rounds"])}
    # (iv) Arrivals every 60 s: a churned boundary repairs through kernel
    # A whatever the configured backend; its device head timed.
    heads = []
    real_head = pdhg_solver.solve_pdhg_relaxed

    def timed_head(problem, s0=None, *args, **kwargs):
        start = time.perf_counter()
        out = real_head(problem, s0, *args, **kwargs)
        heads.append((time.perf_counter() - start, problem, s0))
        return out

    pdhg_solver.solve_pdhg_relaxed = timed_head
    kernel.reset_launch_counts()
    try:
        churn = sim.run_smoke_trace("shockwave_tpu", True, 60.0, device)
    finally:
        pdhg_solver.solve_pdhg_relaxed = real_head
    repair_launches = kernel.LAUNCHES["eg_pdhg"]
    pin = sim.SPECULATE_SMOKE[("shockwave_tpu", 60.0)]
    repairs = [r for r in churn["records"] if r.get("repair")]
    print(f"  smoke trace, arrivals every 60 s, shockwave_tpu --speculate: "
          f"makespan {churn['makespan']:.3f}, speculation "
          f"{churn['spec_stats']}, repair solves {len(repairs)} on "
          f"{[r['backend'] for r in repairs]}, kernel A launched "
          f"{repair_launches} times {tag}", flush=True)
    if (churn["spec_stats"] != pin["spec_stats"]
            or abs(churn["makespan"] - pin["makespan"]) > sim.TOLERANCE
            or not repairs or any(r["backend"] != "pdhg" for r in repairs)
            or repair_launches != len(repairs)):
        fail(f"churned smoke trace: {churn['spec_stats']}, repairs "
             f"{repairs}, {repair_launches} launches, against {pin}")
    # The repair solves' kernel A, timed alone with CUDA events on the
    # problem and warm start each repair gave it.
    repair_ms = []
    for head_s, problem, s0 in heads:
        packed = torch.from_numpy(pdhg_solver._packed_args(
            problem, num_slots_for(problem.num_jobs), s0,
            pdhg_solver.DEFAULT_TOL, pdhg_solver._STALL_REL)).to(device)[None]
        times = sorted(sim._event_ms(lambda: sim.eg_solve("pdhg", packed))
                       for _ in range(5))
        repair_ms.append(dict(jobs=problem.num_jobs, head_s=head_s,
                              kernel_ms=times[2]))
    print(f"  repair solves' kernel A (CUDA events, median of 5): "
          f"{repair_ms} {tag}", flush=True)
    launches["repair"] = repair_launches
    # (ii) The 220-job trace on 64 GPUs, serial and speculative: the
    # exposed planning seconds of each.
    serial = sim.run_trace(sim.TRACE_220, "shockwave_tpu", 64, device,
                           gpus_per_server=4)
    spec = planner_cell(sim, "speculate_220", device, tag)
    if abs(serial["makespan"] - spec["makespan"]) > sim.TOLERANCE:
        fail(f"220-job trace: serial makespan {serial['makespan']} against "
             f"speculative {spec['makespan']}")
    print(f"  220-job trace, shockwave_tpu on 64 GPUs: exposed planning "
          f"{serial['exposed_plan_s']:.3f} s serial, "
          f"{spec['exposed_plan_s']:.3f} s speculative "
          f"({spec['spec_stats']['repair']} repair solves on kernel A) "
          f"{tag}", flush=True)
    launches["speculate_220"] = spec["launches"]["eg_pdhg"]
    # (iii) The golden trace under --cells 2 --speculate: every lane of
    # every launch equal to its one-lane launch.
    recorded = []
    real_solve = batched.solve_cells_pdhg

    def recording(problems, s0s=None, **kwargs):
        s, o, d = real_solve(problems, s0s, **kwargs)
        recorded.append((list(problems), None if s0s is None else [
            None if x is None else np.array(x) for x in s0s],
            {k: kwargs[k] for k in ("tol", "max_cycles", "inner_iters",
                                    "slots", "device")}, s, o))
        return s, o, d

    batched.solve_cells_pdhg = recording
    try:
        # With the flight recorder and the metrics plane on: the pin must
        # hold all the same (phase 16 replays the log).
        with planes_on(TELEMETRY_LOGS["cells_speculate"],
                       TELEMETRY_OUT / "cells_speculate_metrics.json"):
            cells = planner_cell(sim, "speculate_golden_cells", device, tag)
    finally:
        batched.solve_cells_pdhg = real_solve
    launches["cells_speculate"] = cells["launches"]["eg_pdhg"]
    lanes = check_lanes_alone("golden --cells 2 --speculate", recorded)
    print(f"  golden --cells 2 --speculate: {len(recorded)} launches, every "
          f"one of their {lanes} lanes equal to its one-lane launch {tag}",
          flush=True)
    readings["speculation"] = {
        "smoke_t0": smoke,
        "smoke_churn": {k: churn[k] for k in ("makespan", "spec_stats",
                                              "exposed_plan_s")},
        "repair_kernel": repair_ms,
        "trace_220": {"serial_exposed_s": serial["exposed_plan_s"],
                      "speculative_exposed_s": spec["exposed_plan_s"],
                      "serial_wall_s": serial["wall_s"],
                      "speculative_wall_s": spec["wall_s"],
                      "spec_stats": spec["spec_stats"],
                      "makespan": spec["makespan"]},
        "golden_cells": {"makespan": cells["makespan"],
                         "spec_stats": cells["spec_stats"],
                         "launches": len(recorded), "lanes": lanes}}

    # (c) Pool sets.
    pools = {}
    for key in ("pools_120", "pools_220_pdhg"):
        r = planner_cell(sim, key, device, tag)
        pools[key] = {k: r[k] for k in ("makespan", "avg_jct", "worst_ftf",
                                        "rounds", "solves_by_pool",
                                        "launches", "wall_s")}
    if not pools["pools_220_pdhg"]["launches"]["eg_pdhg"]:
        fail("the pdhg pool set launched kernel A no time")
    launches["pools"] = pools["pools_220_pdhg"]["launches"]["eg_pdhg"]
    readings["pools"] = pools

    # (d) The PyTorch greedy on the card against its CPU run and the native
    # greedy, then one golden run with the native greedy unavailable.
    problems = sim.greedy_problems() + [
        (f"2048-tier window of {p.num_jobs} jobs", p) for p in windows]
    bad, rows = sim.check_greedy(problems, device)
    for row in rows:
        single = row.get("objective_single_grant")
        print(f"  greedy {row['problem']} (grant batch {row['grant_batch']}): "
              f"{row['differ']} cells differ from the CPU's; objective "
              f"{row['objective']!r} (native {row['objective_native']!r}"
              + (f"; single grants {single!r}" if single is not None else "")
              + f"); {1e3 * row['greedy_s']:.1f} ms a solve on the card, "
              f"native {1e3 * row['native_s']:.2f} ms {tag}", flush=True)
    if bad:
        fail("the PyTorch greedy on the card: " + "; ".join(bad))
    fallback = planner_cell(sim, "greedy_fallback_golden", device, tag)
    if not fallback["greedy_solves"].get(device.type):
        fail(f"the golden run without the native greedy took no greedy "
             f"fallback on the card: {fallback['greedy_solves']}")
    if not native.available():
        fail("the native greedy is unavailable after the patched run")
    readings["greedy"] = {"problems": rows,
                          "fallback_run": {k: fallback[k] for k in (
                              "makespan", "avg_jct", "worst_ftf", "rounds",
                              "greedy_solves", "wall_s")}}

    # (e) Duals: kernel A's solve with its report on the 8 windows.
    kernel.reset_launch_counts()
    reports = []
    for problem in windows:
        Y, report = pdhg_solver.solve_eg_pdhg_with_duals(problem,
                                                         device=device)
        Y2, report2 = pdhg_solver.solve_eg_pdhg_with_duals(problem,
                                                           device=device)
        host = duals.dual_report(problem, s=report.s)
        for other, what in ((host, "the host's report of its s"),
                            (report2, "a second call")):
            same = all(getattr(report, f).tobytes()
                       == getattr(other, f).tobytes()
                       for f in ("s", "fair_share", "marginal_welfare",
                                 "price", "welfare_contribution", "spend",
                                 "makespan_binding"))
            if not same or report.to_dict() != other.to_dict():
                fail(f"dual report of the {problem.num_jobs}-job window "
                     f"differs from {what}")
        if not np.array_equal(Y, Y2):
            fail(f"{problem.num_jobs}-job window: two plans differ")
        try:
            problem.audit_schedule(Y)
        except AssertionError as e:
            fail(f"{problem.num_jobs}-job window with duals: {e}")
        reports.append({"jobs": problem.num_jobs, **report.to_dict()})
    launches["duals"] = kernel.LAUNCHES["eg_pdhg"]
    print(f"  duals on {len(windows)} windows: every report equal to the "
          f"host's of the same s and to a second call's, every plan audited; "
          f"kernel A launched {launches['duals']} times {tag}", flush=True)
    readings["duals"] = reports
    if not all(launches[k] for k in ("checkpoint", "repair", "pools",
                                      "cells_speculate", "duals")):
        fail(f"a planner path launched kernel A no time: {launches}")
    readings["launches"] = launches
    return readings


SIM_OUT = ROOT / "_smoke_out" / "sim_features"
JAX_SIM_REFERENCE = ROOT / "results" / "sim_features" / "jax_reference.json.gz"


def run_sim_features(device, card: str) -> dict:
    """Phase 15 (docstring, item 15): the simulator's remaining features
    on the card. Every check runs, and the phase fails at its end on any
    run, count, digest, round log or decision past its pin, an inexact
    HA round trip, or a price_batch lane that differs from its one-lane
    launch or its single-burst price."""
    import gzip

    from shockwave_tpu_torch import simulate
    from shockwave_tpu_torch.core import throughput_estimator as te
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.ops import eg_pdhg as kernel
    from shockwave_tpu_torch.ops import matrix_completion as mc
    from shockwave_tpu_torch.runtime import faults
    from shockwave_tpu_torch.tools import bench_sim as sim
    from shockwave_tpu_torch.tools import whatif as wcli
    from shockwave_tpu_torch.whatif import AdmissionPricer

    tag = f"[{card}]"
    kind = torch.cuda.get_device_name(0)
    bad, readings, launches = [], {}, {}
    SIM_OUT.mkdir(parents=True, exist_ok=True)
    with gzip.open(JAX_SIM_REFERENCE, "rt") as f:
        jax_runs = json.load(f)["runs"]
    runs = {key: (args, kwargs) for key, args, kwargs in
            sim.sim_feature_runs()}
    print(f"simulator features phase {tag}:", flush=True)

    # The scheduler each CLI run builds, for its features.
    built = {}
    real_simulate = Scheduler.simulate

    def capturing(self, *args, **kwargs):
        built["sched"] = self
        return real_simulate(self, *args, **kwargs)

    def cli_run(argv, key):
        Scheduler.simulate = capturing
        try:
            result = simulate.main([*argv, "--device", str(device)])
        finally:
            Scheduler.simulate = real_simulate
            injector = faults.active()
            faults.reset()
        r = {**result, **sim.sim_features(built.pop("sched"), injector)}
        misses = sim.check_features(r, key, kind)
        if misses:
            bad.append(f"{key}: " + ", ".join(misses))
        return r

    # (a) Churn: the 220-job trace on 64 v100s under a seeded churn plan,
    # through the simulate CLI with --fault-plan and --round_log.
    seconds = {}
    part_started = time.time()
    plan_path = SIM_OUT / "churn_plan.json"
    plan = sim.churn_plan(faults)
    plan_path.write_text(plan.to_json())
    churn = {}
    for policy in sim.CHURN_POLICIES:
        key = f"churn_{policy}"
        log_path = SIM_OUT / f"{key}.jsonl"
        kernel.reset_launch_counts()
        # The pdhg run with the flight recorder and the metrics plane on:
        # its pins must hold all the same (phase 16 replays the log).
        planes = [] if policy != "shockwave_tpu_pdhg" else [
            "--decision-log", str(TELEMETRY_LOGS["churn_pdhg"]),
            "--metrics-out", str(TELEMETRY_OUT / "churn_pdhg_metrics.json")]
        for path in planes[1::2]:
            Path(path).unlink(missing_ok=True)
        r = cli_run(["-t", str(sim.TRACE_220), "-p", policy, "-c", "v100=64",
                     "--num_gpus_per_server", "v100=4",
                     "--time_per_iteration", "120", "--fault-plan",
                     str(plan_path), "--round_log", str(log_path),
                     "--no_profile_cache", *planes], key)
        launches[key] = kernel.LAUNCHES["eg_pdhg"]
        written = [json.loads(line) for line in
                   log_path.read_text().splitlines()]
        tol = sim.TOLERANCE if policy.startswith("shockwave") else 0.0
        log_misses = sim.round_log_misses(written, jax_runs[key]["round_log"],
                                          tol)
        if written != r["round_log"] or log_misses:
            bad.append(f"{key}: the round log against the JAX package's: "
                       f"{log_misses[:3]}")
        kills = [v for v in r["recoveries"].values()
                 if v["how"].startswith("journal")]
        if len(kills) != sum(e.kind in faults.SCHEDULER_KINDS
                             for e in plan.events) or not all(
                                 v["roundtrip_exact"] for v in kills):
            bad.append(f"{key}: scheduler kills {kills}")
        if sim.recoveries_without_hashes(r["recoveries"]) != (
                sim.recoveries_without_hashes(
                    {int(k): v for k, v in
                     jax_runs[key]["recoveries"].items()})):
            bad.append(f"{key}: recovery records differ from the JAX "
                       "package's")
        churn[key] = {k: r[k] for k in (
            "makespan", "avg_jct", "worst_ftf", "rounds", "faults",
            "lost_jobs", "dropped_jobs", "solves", "wall_s")}
        churn[key].update(kernel_launches=launches[key],
                          round_log_records=len(written),
                          kills_exact=[v["roundtrip_exact"] for v in kills])
        print(f"  {key}: {pin_line(r)}; faults {r['faults']['applied']} "
              f"applied, {r['faults']['recovered']} recovered, "
              f"unrecovered {r['faults']['unrecovered']}; {len(kills)} "
              f"scheduler kills, exact {churn[key]['kills_exact']}; "
              f"unfinished {r['lost_jobs']}, dropped {r['dropped_jobs']}; "
              f"{len(written)} round-log records; kernel A launched "
              f"{launches[key]} times; {r['wall_s']:.2f} s {tag}",
              flush=True)
    if not launches["churn_shockwave_tpu_pdhg"]:
        bad.append("the pdhg churn run launched kernel A no time")
    readings["churn"] = churn
    seconds["churn"] = time.time() - part_started
    part_started = time.time()

    # (b) Estimation, masked ALS on the card: the six sweep cells, then
    # the 220-job trace through the CLI.
    als = []
    real_als = mc.masked_als

    def timed_als(*args, **kwargs):
        sync()
        start = time.perf_counter()
        out = real_als(*args, **kwargs)
        sync()
        als.append(time.perf_counter() - start)
        return out

    # Each completion on the card is also made on the host from the same
    # start: where the two pick other reference types, the card's
    # distances to both must be a near-tie.
    flips = []
    real_complete = te.complete

    def both_completions(X, mask, *args, **kwargs):
        card_m = real_complete(X, mask, *args, **kwargs)
        host_m = real_complete(X, mask, *args, **{**kwargs, "device": "cpu"})
        dist = [[te.cosine_distance(m[i], m[-1]) for i in range(len(m) - 1)]
                for m in (card_m, host_m)]
        pick = [int(np.argmin(d)) for d in dist]
        if pick[0] != pick[1]:
            flips.append(abs(dist[0][pick[0]] - dist[0][pick[1]]))
        return card_m

    mc.masked_als = timed_als
    te.complete = both_completions
    estimate = {}
    try:
        for key, (args, kwargs) in runs.items():
            if not key.startswith("estimate_p"):
                continue
            r = sim.run_trace(*args, device, **kwargs)
            misses = sim.check_features(r, key, kind)
            if misses:
                bad.append(f"{key}: " + ", ".join(misses))
            estimate[key] = {k: r[k] for k in ("makespan", "avg_jct",
                                               "worst_ftf", "rounds")}
            print(f"  {key}: {pin_line(r)}; matches digest "
                  f"{sim.digest(r['matches'])} (pin "
                  f"{sim.SIM_FEATURE_DIGESTS[key]['matches']}); "
                  f"{r['wall_s']:.2f} s {tag}", flush=True)
        args, kwargs = runs["estimate_220"]
        r = cli_run(["-t", str(sim.TRACE_220), "-p", args[1], "-c",
                     "v100=64", "--num_gpus_per_server", "v100=4",
                     "--time_per_iteration", "120",
                     "--profiling_percentage",
                     str(kwargs["profiling_percentage"]),
                     "--num_reference_models",
                     str(kwargs["num_reference_models"]),
                     "--no_profile_cache"], "estimate_220")
        estimate["estimate_220"] = {k: r[k] for k in (
            "makespan", "avg_jct", "worst_ftf", "rounds", "wall_s")}
        print(f"  estimate_220 (simulate --profiling_percentage 0.5 "
              f"--num_reference_models 8): {pin_line(r)}; "
              f"{len(r['matches'])} matches, digest "
              f"{sim.digest(r['matches'])}; {r['wall_s']:.2f} s {tag}",
              flush=True)
    finally:
        mc.masked_als = real_als
        te.complete = real_complete
    if any(gap >= sim.NEAR_TIE for gap in flips):
        bad.append(f"card and host completions pick other reference types "
                   f"at distance gaps {flips}, beyond {sim.NEAR_TIE}")
    als = als[::2]  # the card's calls; every other one is the host's
    als_ms = sorted(1e3 * t for t in als)
    readings["estimation"] = dict(runs=estimate, als_calls=len(als),
                                  als_ms_median=als_ms[len(als_ms) // 2],
                                  als_ms_max=als_ms[-1])
    readings["estimation"]["near_tie_flips"] = flips
    print(f"  masked ALS on the card: {len(als)} calls, "
          f"{als_ms[len(als_ms) // 2]:.3f} ms a call (median; max "
          f"{als_ms[-1]:.3f} ms); {len(flips)} matches differ from the "
          f"host's completion, every one a near-tie (distance gaps "
          f"{[f'{g:.2e}' for g in flips]}) {tag}", flush=True)

    seconds["estimation"] = time.time() - part_started
    part_started = time.time()

    # (c) Pricing, kernel A as a lane grid.
    kernel.reset_launch_counts()
    price_out = SIM_OUT / "price_log.json"
    b = sim.PRICING_LOG_BURST
    if wcli.main(["price", "--log", str(FLIGHT_LOG), "--round",
                  str(sim.PRICING_LOG_ROUND), "--burst-jobs", str(b["jobs"]),
                  "--burst-scale", str(b["scale"]), "--burst-duration",
                  str(b["duration"]), "--out", str(price_out),
                  "--device", str(device)]) != 0:
        bad.append("whatif price on the committed log exited nonzero")
    log_decision = json.loads(price_out.read_text())["priced_decision"]
    misses = sim.decision_misses(log_decision, sim.PRICING["log"])
    if misses:
        bad.append("price on round 91: " + ", ".join(misses))
    # The market the CLI builds from the tier's state, kept for the batch.
    loaded = []
    real_load = wcli._load_base

    def keeping(args):
        loaded.append(real_load(args))
        return loaded[-1]

    tier_out = SIM_OUT / "price_tier.json"
    wcli._load_base = keeping
    try:
        rc = wcli.main(["price", "--state", str(CELLS_STATE), "--burst-jobs",
                        str(sim.PRICING_TIER_BURST["jobs"]), "--out",
                        str(tier_out), "--device", str(device)])
    finally:
        wcli._load_base = real_load
    if rc != 0:
        bad.append("whatif price on the tier's state exited nonzero")
    problem, keys, s0, tier_round, _ = loaded[0]
    if tier_round != sim.PRICING["tier"]["round"]:
        bad.append(f"the cells tier's snapshot is round {tier_round}, the "
                   f"pins' {sim.PRICING['tier']['round']}")
    tier_decision = json.loads(tier_out.read_text())["priced_decision"]
    misses = sim.decision_misses(tier_decision, sim.PRICING["tier_single"])
    if misses:
        bad.append("price on the tier's state: " + ", ".join(misses))
    cli_launches = kernel.LAUNCHES["eg_pdhg"]
    holder = {"problem": problem, "keys": keys, "s0": s0}
    pricer = AdmissionPricer(lambda: holder, budget_s=600.0, device=device)
    bursts = sim.pricing_bursts(Job)
    kernel.reset_launch_counts()
    batch = pricer.price_batch(bursts, audit=True)
    batch_launches = kernel.LAUNCHES["eg_pdhg"] - pricer.last_batch_audit[
        "audited"]
    if not pricer.last_batch_audit["bit_identical"]:
        bad.append(f"price_batch lanes differ from their one-lane launches: "
                   f"{pricer.last_batch_audit}")
    for i, (got, ref) in enumerate(zip(batch, sim.PRICING["tier_batch"])):
        misses = sim.decision_misses(got.as_record(), ref)
        if misses:
            bad.append(f"price_batch lane {i}: " + ", ".join(misses))
    lanes_equal, verdicts_equal = 0, 0
    for jobs, got in zip(bursts, batch):
        alone = pricer.price(jobs)
        lane = pricer.price_batch([jobs])[0]
        lanes_equal += (lane.welfare_delta == alone.welfare_delta
                        and lane.burst_welfare == alone.burst_welfare
                        and lane.action == alone.action)
        verdicts_equal += got.action == alone.action
    if lanes_equal != len(bursts) or verdicts_equal != len(bursts):
        bad.append(f"single-burst batches equal to price in {lanes_equal} "
                   f"of {len(bursts)}; batch verdicts equal to price in "
                   f"{verdicts_equal}")
    readings["pricing"] = dict(
        log=log_decision, tier_single=tier_decision,
        tier=dict(round=tier_round, jobs=problem.num_jobs),
        batch_solve_s=batch[0].solve_s,
        batch_actions=[d.action for d in batch],
        cli_launches=cli_launches, batch_launches=batch_launches,
        audit=pricer.last_batch_audit)
    launches["pricing"] = cli_launches + batch_launches
    print(f"  whatif price, round 91 of the committed log: "
          f"{log_decision} (JAX package: {sim.PRICING['log']['action']} "
          f"{sim.PRICING['log']['welfare_delta']}) {tag}", flush=True)
    print(f"  whatif price, the cells tier's state at round "
          f"{tier_round} ({problem.num_jobs} jobs), a burst of "
          f"{sim.PRICING_TIER_BURST['jobs']}: {tier_decision} (JAX package: "
          f"{sim.PRICING['tier_single']['action']} "
          f"{sim.PRICING['tier_single']['welfare_delta']}) {tag}",
          flush=True)
    print(f"  price_batch of {len(bursts)} bursts on that state: one launch "
          f"of {len(bursts) + 1} lanes, solve_s {batch[0].solve_s:.4f}; "
          f"audit {pricer.last_batch_audit}; {lanes_equal} single-burst "
          f"batches equal to price() in every bit; the CLI launched kernel "
          f"A {cli_launches} times {tag}", flush=True)
    seconds["pricing"] = time.time() - part_started
    readings["launches"] = launches
    readings["seconds"] = seconds
    print(f"  seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + f" {tag}", flush=True)
    if bad:
        fail("simulator features phase: " + "; ".join(bad))
    return readings


def card_state() -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def retime_noncausal(fa, bench, ring: dict, card: str) -> dict:
    """The non-causal kernels and SDPA's ``is_causal=False`` forward
    re-timed at the hop shape after phase 12, beside the ring phase's
    reading of the same call: back-to-back events, the host's issue time
    a call and the card's time with the launches queued
    (``bench_flash.retime_noncausal``), with the card's clock, power and
    temperature before and after."""
    before = card_state()
    readings = bench.retime_noncausal(fa, torch.device("cuda", 0))
    after = card_state()
    ring_ms = {**{k: v[0] for k, v in ring["ms"].items()},
               "sdpa_fwd": ring["sdpa_fwd_ms"]}
    for name, r in readings.items():
        r["ring_phase_ms"] = ring_ms[name]
        print(f"{name} non-causal at the hop shape, after phase 12 [{card}]: "
              f"{r['events_ms']:.4f} ms back to back (ring phase "
              f"{ring_ms[name]:.4f}); the host issues a call in "
              f"{r['host_ms']:.4f} ms; queued behind a sleep "
              f"{r['queued_ms']:.4f} ms", flush=True)
    print(f"  the card before and after (SM clock, power, temperature): "
          f"{before}; {after}", flush=True)
    return {"kernels": readings, "card_before": before, "card_after": after}


# Phase 16: Ulysses attention and the telemetry planes. A 4-shard seq
# mesh of the one card: at the 110M tier a shard's flash launch is B=8,
# S=2048, H/P=2, D=128. The limits are the ring phase's.
ULYSSES_SHARDS = 4
TELEMETRY_OUT = ROOT / "_smoke_out" / "telemetry"
FIXTURE_DIR = ROOT / "results" / "flight_recorder"
EXPLAIN_DIR = ROOT / "results" / "explain"
FIXTURE_ARGS = ["-t", str(ROOT / "traces" / "small_12_dynamic.trace"), "-p",
                "shockwave_tpu_level", "-c", "2:0:0", "--seed", "0",
                "--time_per_iteration", "60", "--no_profile_cache"]
# The card's calibration summary against the JAX package's CPU run.
CALIBRATION_TOL = 1e-6
# Phases 14 and 15 write these decision logs with the planes on; phase 16
# replays them.
TELEMETRY_LOGS = {"cells_speculate": TELEMETRY_OUT / "cells_speculate.jsonl",
                  "churn_pdhg": TELEMETRY_OUT / "churn_pdhg.jsonl"}


@contextlib.contextmanager
def planes_on(log: Path, metrics_out: Path):
    """The ``--decision-log`` and ``--metrics-out`` planes on around a run
    that builds its scheduler in-process (``bench_sim.run_trace``), as the
    simulate CLI turns them on; the dumps are written and every plane
    reset after it."""
    import argparse

    from shockwave_tpu_torch import obs

    for path in (log, metrics_out):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
    obs.reset()
    obs.apply_telemetry_args(argparse.Namespace(
        metrics_out=str(metrics_out), trace_out=None, decision_log=str(log),
        watchdog=False, watchdog_config=None))
    try:
        yield
        obs.export_run_summary(metrics_out=str(metrics_out))
    finally:
        obs.reset()


def check_ulysses_against_flash(device) -> dict:
    """``ulysses_attention`` (the flash body on ULYSSES_SHARDS shards of the
    card) against ``flash_attention`` on the same inputs, float32 and bf16
    (B=2, S=1024, H=4, D=64): output and q/k/v gradients within rtol 1e-3,
    atol 1e-4 (the ring phase's limits). Returns each dtype's largest
    |err| and whether every tensor was bitwise equal."""
    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.parallel.mesh import make_mesh
    from shockwave_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = make_mesh((1, 1, ULYSSES_SHARDS, 1), [device] * ULYSSES_SHARDS)
    B, S, H, D = 2, 1024, 4, 64
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=device).manual_seed(0)
        inputs = [torch.randn(B, S, H, D, generator=gen, device=device)
                  .to(dtype) for _ in range(3)]
        w = torch.randn(B, S, H, D, generator=gen, device=device)
        results = []
        for attend in (lambda *a: ulysses_attention(
                *a, mesh, local_attention="flash"), fa.flash_attention):
            leaves = [x.clone().requires_grad_() for x in inputs]
            out = attend(*leaves)
            (out.float() * w).sum().backward()
            results.append([out.detach()] + [x.grad for x in leaves])
        sync()
        worst, equal = 0.0, True
        for what, got, ref in zip(("out", "dq", "dk", "dv"), *results):
            equal = equal and bool(torch.equal(got, ref))
            got, ref = got.float(), ref.float()
            err = (got - ref).abs()
            worst = max(worst, float(err.max()))
            over = int((err > 1e-4 + 1e-3 * ref.abs()).sum())
            if over or not bool(torch.isfinite(got).all()):
                fail(f"ulysses against flash, {dtype}: {what} has {over} "
                     "elements past rtol 1e-3, atol 1e-4")
        readings[str(dtype).replace("torch.", "")] = {
            "max_abs_err": worst, "bitwise_equal": equal}
    return readings


def run_ulysses(fa, train, device, card, flash_losses, flash_steps_per_s,
                flash_peak_gib) -> dict:
    """Phase 16 (a) (docstring, item 16): Ulysses against flash, the 110M
    tier under ``attention="ulysses"`` against the flash model (first loss
    and gradients, 5 steps, launches), ``train.main --attention ulysses``
    for 2 steps, steps/s and peak memory beside the flash step's. Returns
    the readings; fails on any miss."""
    from shockwave_tpu_torch.parallel.mesh import make_mesh

    small = check_ulysses_against_flash(device)
    print(f"ulysses ({ULYSSES_SHARDS} shards of one card, flash body) "
          f"against flash_attention, B=2 S=1024 H=4 D=64: out and q/k/v "
          f"gradients within rtol 1e-3 atol 1e-4: {small} [{card}]",
          flush=True)

    args = train.parse_args(train_args(5, "flash"))
    model, _, _, batch_fn = train.build_family("Transformer", args, device)
    first_batch = batch_fn(np.random.default_rng(args.seed))
    flash_loss, flash_grads = loss_and_grads(model, first_batch)
    del model
    args = train.parse_args(train_args(5, "ulysses"))
    mesh = make_mesh((1, 1, ULYSSES_SHARDS, 1), [device] * ULYSSES_SHARDS)
    model, step_fn, _, batch_fn = train.build_family("Transformer", args,
                                                     device, mesh)
    loss, grads = loss_and_grads(model, first_batch)
    grad_err = worst_grad_error(grads, flash_grads)
    bitwise = loss == flash_loss and all(
        torch.equal(grads[n], flash_grads[n]) for n in grads)
    del grads, flash_grads
    loss_err = abs(loss - flash_loss) / abs(flash_loss)
    print(f"110M tier, first batch: ulysses loss {loss!r} against flash's "
          f"{flash_loss!r} ({loss_err:.3e} relative, limit "
          f"{RING_LOSS_RTOL:g}); worst gradient {grad_err[0]} at "
          f"{grad_err[1]:.4f} relative (limit {RING_GRAD_RTOL:g}); loss and "
          f"every gradient bitwise equal to flash's: {bitwise} [{card}]",
          flush=True)
    if loss_err > RING_LOSS_RTOL or grad_err[1] > RING_GRAD_RTOL:
        fail("ulysses 110M tier: first loss or gradients past their limits")

    np_rng = np.random.default_rng(args.seed)
    sync()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses = [step_fn(batch_fn(np_rng))]
    sync()
    start = time.perf_counter()
    for _ in range(args.num_steps - 1):
        losses.append(step_fn(batch_fn(np_rng)))
    sync()
    steady_s = (time.perf_counter() - start) / (args.num_steps - 1)
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del model, step_fn
    losses = [float(x) for x in losses]
    steps_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         flash_losses))
    print(f"110M tier, ulysses on a (1, 1, {ULYSSES_SHARDS}, 1) mesh of one "
          f"card: losses {losses} against the flash run's {flash_losses} (at "
          f"most {steps_err:.3e} relative, limit {RING_STEPS_RTOL:g}); "
          f"{1 / steady_s:.3f} steps/s after the first against flash's "
          f"{flash_steps_per_s:.3f}; peak memory {peak_gib:.2f} GiB against "
          f"flash's {flash_peak_gib:.2f}; launches {launches} [{card}]",
          flush=True)
    if len(losses) != len(flash_losses) or not all(
            math.isfinite(x) for x in losses) or steps_err > RING_STEPS_RTOL:
        fail(f"ulysses 110M tier: losses {losses} against the flash run's "
             f"{flash_losses}, past {RING_STEPS_RTOL:g} of them")
    # A layer launches each causal kernel once a shard, forward and
    # backward, and no non-causal one.
    layers, steps = args.num_layers, args.num_steps
    for name, count in launches.items():
        expected = 0 if name.endswith("_nc") else (
            layers * steps * ULYSSES_SHARDS)
        if count != expected:
            fail(f"ulysses 110M tier: {name} launched {count} times in "
                 f"{steps} steps, expected {expected}")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        fa.reset_launch_counts()
        one = train.main(train_args(2, "ulysses"))
        one_launches = dict(fa.LAUNCHES)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"train.main --attention ulysses: losses {one['losses']}, "
          f"launches {one_launches} [{card}]", flush=True)
    if len(one["losses"]) != 2 or not all(math.isfinite(x)
                                          for x in one["losses"]):
        fail(f"train.main --attention ulysses: losses {one['losses']}")
    if one_launches != {name: 0 if name.endswith("_nc") else 2 * layers
                        for name in one_launches}:
        fail(f"train.main --attention ulysses: launches {one_launches}")
    return {"small": small, "flash_first_loss": flash_loss,
            "ulysses_first_loss": loss, "first_loss_rel": loss_err,
            "worst_grad": grad_err[0], "worst_grad_rel": grad_err[1],
            "bitwise_equal_to_flash": bitwise, "losses": losses,
            "flash_losses": flash_losses, "losses_max_rel": steps_err,
            "steps_per_s": 1 / steady_s,
            "flash_steps_per_s": flash_steps_per_s,
            "tokens_per_s": args.batch_size * args.seq_len / steady_s,
            "peak_gib": peak_gib, "flash_peak_gib": flash_peak_gib,
            "launches": launches,
            "train_main": {"losses": one["losses"],
                           "launches": one_launches}}


def replay_on_card(log: Path, device) -> dict:
    """``python -m shockwave_tpu_torch.obs.recorder replay LOG`` (its
    ``main``, in this process) with the solves on the card: the records
    replayed, the seconds taken; fails unless every plan diff is empty."""
    import io

    from shockwave_tpu_torch.obs import recorder

    out = io.StringIO()
    start = time.time()
    with contextlib.redirect_stdout(out):
        rc = recorder.main(["replay", str(log), "--device", str(device)])
    seconds = time.time() - start
    last = out.getvalue().strip().splitlines()[-1]
    found = re.match(r"replayed (\d+) plan record\(s\): (\d+) exact, "
                     r"(\d+) diverged", last)
    if rc != 0 or not found or found.group(3) != "0" or (
            found.group(1) == "0"):
        fail(f"replay of {log} on the card: {out.getvalue()[-2000:]}")
    return {"records": int(found.group(1)), "seconds": seconds}


def run_telemetry(device, card: str, logs: dict) -> dict:
    """Phase 16 (b), (d) and (e) (docstring, item 16): the flight-recorder
    fixture run on the card with every plane on, held to the committed
    fixture and the JAX package's run, and again with every plane off;
    every log replayed on the card; the narratives. ``logs`` are phase
    14's and 15's decision logs. Returns the readings; fails at its end
    on any miss."""
    from shockwave_tpu_torch import simulate
    from shockwave_tpu_torch.obs import explain, recorder
    from shockwave_tpu_torch.tools import bench_sim as sim

    tag = f"[{card}]"
    bad, readings = [], {}
    TELEMETRY_OUT.mkdir(parents=True, exist_ok=True)
    paths = {k: TELEMETRY_OUT / f"fixture_{k}" for k in (
        "metrics.json", "trace.json", "decisions.jsonl", "on.jsonl",
        "off.jsonl")}
    for path in paths.values():
        path.unlink(missing_ok=True)
    pins = sim.TELEMETRY_FIXTURE
    print(f"telemetry phase {tag}:", flush=True)

    # (b) The fixture run, every plane on, then every plane off.
    argv = FIXTURE_ARGS + ["--device", str(device)]
    start = time.time()
    on = simulate.main(argv + [
        "--metrics-out", str(paths["metrics.json"]), "--trace-out",
        str(paths["trace.json"]), "--decision-log",
        str(paths["decisions.jsonl"]), "--watchdog", "--round_log",
        str(paths["on.jsonl"])])
    on_s = time.time() - start
    start = time.time()
    off = simulate.main(argv + ["--round_log", str(paths["off.jsonl"])])
    off_s = time.time() - start
    bad += [f"fixture run: {m}" for m in sim.check_run(on, pins["run"])]
    if any(on[k] != off[k] for k in ("makespan", "avg_jct", "worst_ftf",
                                     "rounds", "num_preemptions", "solves")):
        bad.append("the fixture run with every plane on differs from the "
                   "run with every plane off")
    if paths["on.jsonl"].read_text() != paths["off.jsonl"].read_text():
        bad.append("the planes-on run's round log differs from the "
                   "planes-off run's")
    ours = list(recorder.iter_records(str(paths["decisions.jsonl"])))
    committed = list(recorder.iter_records(str(FIXTURE_DIR /
                                               "decisions.jsonl")))

    def events(records, name):
        return [r for r in records if r["event"] == name]

    plans = [r["plan"] for r in events(ours, "plan")]
    if plans != [r["plan"] for r in events(committed, "plan")] or len(
            plans) != 32:
        bad.append(f"fixture run: {len(plans)} plan records, not the "
                   "committed log's 32 plan windows")
    contexts = events(ours, "round_context")
    if contexts != events(committed, "round_context") or len(
            contexts) != 419:
        bad.append(f"fixture run: {len(contexts)} round contexts, not the "
                   "committed log's 419")
    with open(paths["metrics.json"]) as f:
        metrics = json.load(f)
    with open(FIXTURE_DIR / "metrics.json") as f:
        fixture = json.load(f)
    bad += [f"fixture counters: {m}" for m in sim.metric_differences(
        metrics, fixture, sim.TELEMETRY_HELD)]
    got = sim.fixture_pins(paths["metrics.json"], paths["trace.json"])
    for k, v in pins["calibration"].items():
        if abs(got["calibration"][k] - v) > CALIBRATION_TOL * max(1.0,
                                                                  abs(v)):
            bad.append(f"calibration {k}: {got['calibration'][k]} against "
                       f"the JAX package's {v}")
    if got["market"] != pins["market"]:
        bad.append(f"market gauges {got['market']} against {pins['market']}")
    if got["alerts"] != pins["alerts"]:
        bad.append(f"deterministic alerts {got['alerts']} against the JAX "
                   f"package's {pins['alerts']}")
    every_rule = sim.health_alerts(paths["trace.json"], deterministic=False)
    stale = {k: fixture["metrics"][f"predictor_calibration_{k}"]["series"]
             [0]["value"] for k in ("scored", "mape")}
    readings["fixture_run"] = {
        "planes_on_s": on_s, "planes_off_s": off_s,
        "makespan": on["makespan"], "rounds": on["rounds"],
        "plans": len(plans), "round_contexts": len(contexts),
        "calibration": got["calibration"],
        "committed_fixture_calibration": stale,
        "alerts": len(got["alerts"]),
        "solver_time_alerts": every_rule.count("solver_time")}
    print(f"  fixture run (level solves on the card), every plane on: "
          f"{pin_line(on)}, {len(plans)} plan records, {len(contexts)} round "
          f"contexts, calibration {got['calibration']} (the committed "
          f"fixture's, stale: {stale}), {len(got['alerts'])} deterministic "
          f"alerts, solver_time {every_rule.count('solver_time')} "
          f"(reported, not held); {on_s:.2f} s, every plane off "
          f"{off_s:.2f} s {tag}", flush=True)

    # (d) Every log replayed on the card.
    replay = {}
    for name, log in (("fixture_run", paths["decisions.jsonl"]),
                      ("cells_speculate", logs["cells_speculate"]),
                      ("churn_pdhg", logs["churn_pdhg"]),
                      ("committed_flight_recorder",
                       FIXTURE_DIR / "decisions.jsonl"),
                      ("committed_explain", EXPLAIN_DIR / "decisions.jsonl")):
        replay[name] = replay_on_card(log, device)
        print(f"  replay {name}: {replay[name]['records']} plan records, "
              f"every diff empty, {replay[name]['seconds']:.2f} s {tag}",
              flush=True)
    summaries = {name: recorder.summarize_log(str(logs[name]))
                 for name in ("cells_speculate", "churn_pdhg")}
    cells_states = [recorder.decode(r["planner_state"]) for r in
                    recorder.iter_records(str(logs["cells_speculate"]))
                    if r.get("event") == "plan"]
    if not summaries["cells_speculate"]["speculations"] or not all(
            "cells_replay" in s for s in cells_states) or not summaries[
            "cells_speculate"]["speculative_plans"]:
        bad.append(f"the cells log lacks stamped, speculative or "
                   f"speculation records: {summaries['cells_speculate']}")
    churn = summaries["churn_pdhg"]
    if not churn["faults"] or churn["faults"] != churn["recoveries"]:
        bad.append(f"the churn log's fault and recovery records: {churn}")
    readings["replay"] = replay
    readings["log_summaries"] = summaries

    # (e) Narratives.
    with open(EXPLAIN_DIR / "narratives.json") as f:
        committed_narratives = json.load(f)
    narratives = json.loads(json.dumps(explain.narrative_from_log(
        str(EXPLAIN_DIR / "decisions.jsonl"))))
    if narratives != committed_narratives:
        bad.append("narratives over the committed explain log differ from "
                   "narratives.json")
    cells_narratives = explain.narrative_from_log(
        str(logs["cells_speculate"]))["jobs"]
    incoherent = [k for k, n in cells_narratives.items()
                  if not n["trail"] or n["rounds_run"] <= 0
                  or n["first_scheduled_round"] > n["last_scheduled_round"]]
    if len(cells_narratives) != 12 or incoherent:
        bad.append(f"narratives over the cells log: {len(cells_narratives)} "
                   f"jobs, incoherent {incoherent}")
    readings["narratives"] = {
        "committed_equal": narratives == committed_narratives,
        "cells_jobs": len(cells_narratives)}
    print(f"  narratives: the committed explain log's equal narratives.json "
          f"field for field: {narratives == committed_narratives}; "
          f"{len(cells_narratives)} jobs of the cells log with a trail "
          f"{tag}", flush=True)
    if bad:
        fail("telemetry phase: " + "; ".join(bad))
    return readings


# Phase 19: every family of the training payload, and the Transformer's
# MoE MLP, remat and chunked head at the 110M tier's widths. Each family at
# the largest batch the golden trace gives it (A3C and CycleGAN, in no
# trace, at the training program's default of 32).
FAMILIES_OUT = ROOT / "_smoke_out" / "families"
FAMILY_BATCHES = (("ResNet-18", 256), ("ResNet-50", 16), ("LM", 10),
                  ("Recommendation", 8192), ("A3C", 32), ("CycleGAN", 32))
FAMILY_STEPS = 3
FAMILY_CPU_RTOL = 1e-4  # the first loss on the card against its host's CPU
# The JAX package's moe4_dff4096 shape (results/moe_pipeline_tpu.json): the
# 110M tier with 4 experts of d_ff 4096, grouped dispatch, capacity 1.25.
MOE_EXPERTS = 4
MOE_PARAMS = 312_543_232
MOE_STEPS = 5
MOE_DENSE_RTOL = 2e-2  # flash against dense attention, bf16, first loss
MOE_MEMORY_STEPS = 2
LOGIT_CHUNK = 512


def captured_main(train, argv):
    """``train.main`` with its lines kept (and printed) for the checks."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = train.main(argv)
    print(out.getvalue(), end="", flush=True)
    return result, out.getvalue()


def profile_step(step_fn, batch) -> dict:
    """One warm step, then one under ``torch.profiler``: the kernels the
    card ran and its busy share of the step's wall time."""
    from shockwave_tpu_torch.tools.profile_step import _union_us

    step_fn(batch)
    sync()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step_fn(batch)
        sync()
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3
    return {"launches": len(kernels), "profiled_step_ms": wall_ms,
            "busy_ms": busy_ms, "idle_share": max(0.0, 1 - busy_ms / wall_ms)}


def run_family(train, device, family: str, batch: int, card: str) -> dict:
    """Phase 19(a) for one family: 3 steps and a resumed step on the card
    through ``train.main``, the first loss on the host's CPU, one step
    profiled."""
    ckpt = FAMILIES_OUT / family
    argv = ["--model", family, "--batch_size", str(batch), "--device",
            "cuda", "--checkpoint_dir", str(ckpt)]
    first, text = captured_main(train, argv + ["-n", str(FAMILY_STEPS)])
    resumed, resumed_text = captured_main(train, argv + ["-n", "1"])
    bad = []
    for lines in (text, resumed_text):
        if f"[{family}] steps=" not in lines or "device=cuda" not in lines:
            bad.append(f"{family}: no summary line naming device=cuda")
    losses = first["losses"] + resumed["losses"]
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"{family}: losses {losses}")
    if f"RESUMED from {ckpt / train.CHECKPOINT_NAME} at step " \
            f"{FAMILY_STEPS}" not in resumed_text:
        bad.append(f"{family}: the resumed run did not restore at step "
                   f"{FAMILY_STEPS}")
    args = train.parse_args(argv + ["-n", "1"])
    _, cpu_step, _, cpu_batch = train.build_family(family, args,
                                                   torch.device("cpu"))
    cpu_loss = float(cpu_step(cpu_batch(np.random.default_rng(args.seed))))
    if abs(first["losses"][0] - cpu_loss) > FAMILY_CPU_RTOL * abs(cpu_loss):
        bad.append(f"{family}: first loss {first['losses'][0]} on the card, "
                   f"{cpu_loss} on its host's CPU")
    _, step_fn, _, batch_fn = train.build_family(family, args, device)
    profiled = profile_step(step_fn, batch_fn(np.random.default_rng(1)))
    steady = (first["steps"] - 1) / first["phases"]["train"]
    print(f"  {family} (batch {batch}): {steady:.2f} steps/s after the first "
          f"step; first loss {first['losses'][0]:.6f} on the card, "
          f"{cpu_loss:.6f} on the CPU; resumed at step "
          f"{resumed['start_step']}; {profiled['launches']} kernels a step, "
          f"the card idle {100 * profiled['idle_share']:.1f}% of a profiled "
          f"{profiled['profiled_step_ms']:.1f} ms step {card}", flush=True)
    return {"batch": batch, "steps_per_s": steady,
            "losses": first["losses"], "resumed_losses": resumed["losses"],
            "cpu_first_loss": cpu_loss, "profile": profiled, "bad": bad}


def moe_args(steps: int):
    return train_args(steps) + [
        "--num_experts", str(MOE_EXPERTS), "--moe_dispatch", "grouped",
        "--moe_capacity_factor", "1.25"]


def model_like(cfg, device, state):
    """A TransformerLM of ``cfg`` holding ``state``'s weights (built on
    the meta device, so nothing is drawn)."""
    from shockwave_tpu_torch.models.transformer import TransformerLM

    with torch.device("meta"):
        model = TransformerLM(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model


def run_moe(fa, train, device, card: str) -> dict:
    """Phase 19(b) and (c): the MoE tier through the training program's
    builder, 5 steps; its first loss under dense attention; then
    ``--remat --logit_chunk 512`` on the same weights."""
    from shockwave_tpu_torch.models.transformer import lm_loss
    from shockwave_tpu_torch.ops.fused_adamw import FusedAdamW

    bad = []
    args = train.parse_args(moe_args(MOE_STEPS))
    model, step_fn, opt, batch_fn = train.build_family("Transformer", args,
                                                       device)
    params = sum(p.numel() for p in model.parameters())
    if params != MOE_PARAMS:
        bad.append(f"MoE tier: {params} parameters, expected {MOE_PARAMS}")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(args.seed)
    batches = [batch_fn(rng) for _ in range(MOE_STEPS)]
    dense = model_like(dataclasses.replace(model.config, attention="dense"),
                       device, state)
    with torch.no_grad():
        dense_loss = float(lm_loss(dense, batches[0]))
    del dense
    torch.cuda.empty_cache()

    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    start = time.time()
    losses = [step_fn(batches[0])]
    sync()
    after_first = time.time()
    losses += [step_fn(b) for b in batches[1:]]
    sync()
    elapsed, steady = time.time() - start, time.time() - after_first
    losses = [float(x) for x in losses]
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dropped = [float(block.moe.dropped) for block in model.blocks]
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"MoE tier: losses {losses}")
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        if launches.get(name) != 8 * MOE_STEPS:
            bad.append(f"MoE tier: {name} launched {launches.get(name)} "
                       f"times in {MOE_STEPS} steps, expected "
                       f"{8 * MOE_STEPS}")
    if abs(losses[0] - dense_loss) > MOE_DENSE_RTOL * abs(dense_loss):
        bad.append(f"MoE tier: first loss {losses[0]} under flash, "
                   f"{dense_loss} under dense attention")
    cfg = model.config
    del model, step_fn, opt
    torch.cuda.empty_cache()

    remat = model_like(dataclasses.replace(cfg, remat=True), device, state)
    remat_opt = FusedAdamW(remat.parameters(), args.learning_rate)
    torch.cuda.reset_peak_memory_stats()
    remat_losses = []
    fa.reset_launch_counts()
    for b in batches[:MOE_MEMORY_STEPS]:
        remat_opt.zero_grad(set_to_none=True)
        loss = lm_loss(remat, b, logit_chunk=LOGIT_CHUNK)
        loss.backward()
        remat_opt.step()
        remat_losses.append(float(loss.detach()))
    sync()
    remat_launches = dict(fa.LAUNCHES)
    remat_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if abs(remat_losses[0] - losses[0]) > MOE_DENSE_RTOL * abs(losses[0]):
        bad.append(f"MoE remat + chunk: first loss {remat_losses[0]}, the "
                   f"plain run's {losses[0]}")
    if not remat_peak_gib < peak_gib:
        bad.append(f"MoE remat + chunk: peak {remat_peak_gib:.2f} GiB, not "
                   f"below the plain run's {peak_gib:.2f} GiB")
    del remat, remat_opt, state
    torch.cuda.empty_cache()
    print(f"  MoE tier ({MOE_EXPERTS} experts, {params} parameters, bf16, "
          f"flash): losses {losses}; dense attention's first loss "
          f"{dense_loss:.6f}; {(MOE_STEPS - 1) / steady:.3f} steps/s after "
          f"the first ({MOE_STEPS / elapsed:.3f} over all {MOE_STEPS}); "
          f"peak {peak_gib:.2f} GiB; dropped share "
          f"{sum(dropped) / len(dropped):.4f} (layers {dropped}); launches "
          f"{launches} {card}", flush=True)
    print(f"  MoE tier --remat --logit_chunk {LOGIT_CHUNK}: losses "
          f"{remat_losses}; peak {remat_peak_gib:.2f} GiB against "
          f"{peak_gib:.2f}; launches {remat_launches} {card}", flush=True)
    return {"params": params, "losses": losses, "dense_first_loss": dense_loss,
            "steps_per_s": (MOE_STEPS - 1) / steady,
            "steps_per_s_all": MOE_STEPS / elapsed, "peak_gib": peak_gib,
            "dropped_share": sum(dropped) / len(dropped),
            "dropped_by_layer": dropped, "launches": launches,
            "remat_chunk": {"losses": remat_losses, "peak_gib": remat_peak_gib,
                            "launches": remat_launches},
            "bad": bad}


def run_families(fa, train, device, card: str) -> dict:
    """Phase 19 (docstring, item 19). Every check runs; the phase fails at
    its end on any that failed."""
    tag = f"[{card}]"
    print(f"families phase {tag}:", flush=True)
    shutil.rmtree(FAMILIES_OUT, ignore_errors=True)
    families, bad = {}, []
    for family, batch in FAMILY_BATCHES:
        families[family] = run_family(train, device, family, batch, tag)
        bad += families[family].pop("bad")
    # The directory checkpoint, saved and resumed on the card.
    ckpt = FAMILIES_OUT / "orbax"
    argv = ["--model", "Recommendation", "--batch_size", "8192", "--device",
            "cuda", "--checkpoint_dir", str(ckpt), "--ckpt_backend", "orbax"]
    captured_main(train, argv + ["-n", str(FAMILY_STEPS)])
    orbax, text = captured_main(train, argv + ["-n", "1"])
    if (f"RESUMED from {ckpt / train.DIRECTORY_CHECKPOINT_NAME} at step "
            f"{FAMILY_STEPS}" not in text or orbax["device"] != "cuda"):
        bad.append("the directory checkpoint did not resume at step "
                   f"{FAMILY_STEPS} on the card")
    moe = run_moe(fa, train, device, tag)
    bad += moe.pop("bad")
    shutil.rmtree(FAMILIES_OUT, ignore_errors=True)
    if bad:
        fail("families phase: " + "; ".join(bad))
    return {"families": families, "moe": moe,
            "orbax_resumed_loss": orbax["losses"][0]}


# Phase 20: the card's own oracle, measured through
# ``tools/measure_throughput`` before phase 17 plans from it, and one gang.
ORACLE_OUT = ROOT / "_smoke_out" / "oracle"
# Phase 17's payload under its label, and one small row of another family.
ORACLE_SMALL_ROW = ("Recommendation", 512)
ORACLE_PROBE_FACTOR = 2.0  # the payload's rate against phase 6's probe
GANG_TIMEOUT_S = 180.0


def run_gang(device, card: str) -> dict:
    """Phase 20(b): one two-rank gang of the card driver's command
    (ResNet-18 at ``GANG_CPU_BATCH``, ``GANG_STEPS`` steps, ``--gang_device
    cpu``), its ranks on the host's CPU over gloo. Returns each rank's
    exit code, losses and rendezvous seconds."""
    from shockwave_tpu_torch.runtime.testing import free_port
    from shockwave_tpu_torch.tools.physical_drivers import (
        GANG_CPU_BATCH,
        GANG_STEPS,
    )

    addr = f"127.0.0.1:{free_port()}"
    command = [sys.executable, "-m", "shockwave_tpu_torch.models.train",
               "--model", "ResNet-18", "--batch_size",
               str(GANG_CPU_BATCH["ResNet-18"]), "-n", str(GANG_STEPS),
               "--gang_device", "cpu", "--distributed_addr", addr,
               "--num_workers", "2", "--distributed_timeout", "60"]
    # The two ranks share the host's cores.
    env = dict(os.environ, SHOCKWAVE_PHASE_TIMINGS="1",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)))
    started = time.time()
    procs = [subprocess.Popen(command + ["--worker_rank", str(rank)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=GANG_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = []
    for proc, out in zip(procs, outs + [""] * (2 - len(outs))):
        m = re.search(r"^GANG rank=(\d+) world=2 params=(\w+) losses=(\[.*\])$",
                      out, re.M)
        p = _PHASES_LINE.search(out)
        ranks.append({
            "exit": proc.returncode,
            "losses": json.loads(m.group(3)) if m else None,
            "params": m.group(2) if m else None,
            "device_cpu": bool(re.search(r"steps=\d+ .* device=cpu$", out,
                                         re.M)),
            "rendezvous_s": (float(re.search(r"rendezvous=([\d.]+)s",
                                             p.group(1)).group(1))
                             if p and "rendezvous=" in p.group(1) else None),
            "tail": out[-1500:]})
    return {"ranks": ranks, "seconds": time.time() - started}


def run_oracle(fa, device, card: str, probe_steps_per_s: float) -> dict:
    """Phase 20 (docstring, item 20). ``probe_steps_per_s`` is phase 6's
    steps/s at 8 layers. Returns the readings and the oracle's path."""
    from shockwave_tpu_torch.data import read_throughputs
    from shockwave_tpu_torch.data.throughputs import stringify_throughputs
    from shockwave_tpu_torch.tools import measure_throughput as mt
    from shockwave_tpu_torch.utils.fileio import atomic_write_json

    tag = f"[{card}]"
    print(f"oracle phase {tag}:", flush=True)
    shutil.rmtree(ORACLE_OUT, ignore_errors=True)
    ORACLE_OUT.mkdir(parents=True)
    torch.cuda.empty_cache()
    bad = []
    rows = [("Transformer", PHYSICAL_BATCH, PHYSICAL_WIDTHS), ORACLE_SMALL_ROW]
    fa.reset_launch_counts()
    started = time.time()
    oracle = mt.measure_oracle(rows, PHYSICAL_WORKER_TYPE, device="cuda")
    measure_s = time.time() - started
    launches = dict(fa.LAUNCHES)
    path = ORACLE_OUT / "oracle_h100.json"
    atomic_write_json(str(path), stringify_throughputs(oracle))
    read = read_throughputs(str(path))
    if read != oracle:
        bad.append("the written oracle does not read back equal")
    isolated = {key[0]: entry["null"]
                for key, entry in read[PHYSICAL_WORKER_TYPE].items()
                if key[1] == 1}
    rate = isolated.get(PHYSICAL_JOB_TYPE)
    # Phase 6's probe runs 8 layers; the payload's 4 take about half the
    # time a step.
    expected = probe_steps_per_s * 8 / PHYSICAL_LAYERS
    if rate is None or not (expected / ORACLE_PROBE_FACTOR <= rate
                            <= expected * ORACLE_PROBE_FACTOR):
        bad.append(f"{PHYSICAL_JOB_TYPE}: {rate} steps/s, phase 6's probe "
                   f"scaled by layers {expected:.3f} (a factor "
                   f"{ORACLE_PROBE_FACTOR} allowed)")
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        if launches.get(name, 0) < 1:
            bad.append(f"the payload's measurement launched {name} "
                       f"{launches.get(name, 0)} times")
    gang = run_gang(device, card)
    losses = [r["losses"] for r in gang["ranks"]]
    for rank, r in enumerate(gang["ranks"]):
        if r["exit"] != 0 or r["losses"] is None or not r["device_cpu"]:
            bad.append(f"gang rank {rank}: exit {r['exit']}, losses "
                       f"{r['losses']}, on the CPU {r['device_cpu']}: "
                       f"{r['tail']!r}")
    if losses[0] is None or losses[0] != losses[1]:
        bad.append(f"gang ranks report different losses: {losses}")
    digests = [r["params"] for r in gang["ranks"]]
    if digests[0] is None or digests[0] != digests[1]:
        bad.append(f"gang ranks hold different parameters: {digests}")
    elif len(losses[0]) != 2 or not all(math.isfinite(x) for x in losses[0]):
        bad.append(f"gang losses {losses[0]}")
    print(f"  {', '.join(f'{k}: {v:.3f} steps/s' for k, v in isolated.items())}"
          f" alone on the card (slope method, {measure_s:.1f} s); phase 6's "
          f"probe scaled to {PHYSICAL_LAYERS} layers {expected:.3f} steps/s; "
          f"flash launches {launches} {tag}", flush=True)
    print(f"  gang (ResNet-18, 2 ranks on the host's CPU over gloo): losses "
          f"{losses[0]} on both ranks, rendezvous "
          f"{[r['rendezvous_s'] for r in gang['ranks']]} s, "
          f"{gang['seconds']:.1f} s {tag}", flush=True)
    if bad:
        fail("oracle phase: " + "; ".join(bad))
    return {"path": str(path), "isolated": isolated, "measure_s": measure_s,
            "probe_expected": expected, "launches": launches,
            "gang": {"losses": losses[0], "seconds": gang["seconds"],
                     "rendezvous_s": [r["rendezvous_s"]
                                      for r in gang["ranks"]]}}


# Phase 21: the chaos soak's reduced campaign (``tools/chaos_soak.py
# --smoke``) with the planner on the card.
CHAOS_OUT = ROOT / "_smoke_out" / "chaos"


def run_chaos(device, card: str) -> dict:
    """Phase 21 (docstring, item 21). Every invariant is hard."""
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.ops import eg_pdhg as kernel_a
    from shockwave_tpu_torch.ops import eg_relaxed as kernel_b
    from shockwave_tpu_torch.tools import chaos_soak

    tag = f"[{card}]"
    print(f"chaos phase {tag}:", flush=True)
    shutil.rmtree(CHAOS_OUT, ignore_errors=True)
    args = chaos_soak.build_parser().parse_args(
        ["--smoke", "--device", "cuda", "--out", str(CHAOS_OUT)])
    for key, value in chaos_soak.SMOKE.items():
        setattr(args, key, value)
    kernel_a.reset_launch_counts()
    kernel_b.reset_launch_counts()
    started = time.time()
    try:
        result = chaos_soak.run_campaign(args)
    finally:
        # The campaign's recorder and watchdog stay off the later phases.
        obs.reset()
    seconds = time.time() - started
    launches = {"eg_pdhg": kernel_a.LAUNCHES["eg_pdhg"],
                "eg_relaxed": kernel_b.LAUNCHES["eg_relaxed"]}
    bad = list(result["failures"])
    if launches["eg_pdhg"] < result["degraded_rounds"]:
        bad.append(f"kernel A launched {launches['eg_pdhg']} times for "
                   f"{result['degraded_rounds']} rounds the ladder degraded "
                   "to pdhg")
    print(f"  {result['applied_events']} faults applied, "
          f"{result['recovered_events']} recovered, "
          f"{result['log_faults']} / {result['log_recoveries']} in the log, "
          f"{result['chaos']['rounds']} rounds, {result['degraded_rounds']} "
          f"degraded, {result['replay_exact']} of {result['replayed_plans']} "
          f"plans replayed exactly; makespan "
          f"{result['baseline']['makespan_s']:.1f} s fault-free against "
          f"{result['chaos']['makespan_s']:.1f} s, worst FTF "
          f"{result['baseline']['worst_ftf']:.3f} against "
          f"{result['chaos']['worst_ftf']:.3f} (delta "
          f"{result['worst_ftf_delta']:+.3f}); launches {launches}; "
          f"{seconds:.1f} s {tag}", flush=True)
    if bad:
        fail("chaos phase: " + "; ".join(bad))
    return {**{k: v for k, v in result.items() if k != "failures"},
            "launches": launches, "seconds": seconds}


# Phase 22: the streaming soak's reduced campaign and the ingest soak's
# parity gate and one full-scale repetition (``tools/streaming_soak.py``,
# ``tools/ingest_soak.py``), the planner's and the pricer's kernel A on the
# card.
SOAKS_OUT = ROOT / "_smoke_out" / "soaks"
INGEST_TIMEOUT_S = 300.0
# The full campaign's floors (tools/ingest_soak.py's defaults, the JAX
# package's): jobs/s and the queue's p99 in ms.
INGEST_FLOORS = (60000.0, 150.0)


def run_soaks(device, card: str) -> dict:
    """Phase 22 (docstring, item 22). Every invariant is hard."""
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.tools import ingest_soak, streaming_soak

    tag = f"[{card}]"
    print(f"soaks phase {tag}:", flush=True)
    shutil.rmtree(SOAKS_OUT, ignore_errors=True)
    bad = []
    args = streaming_soak.build_parser().parse_args(
        ["--smoke", "--device", "cuda", "--out", str(SOAKS_OUT)])
    for key, value in streaming_soak.SMOKE.items():
        setattr(args, key, value)
    started = time.time()
    try:
        stream = streaming_soak.run_campaign(args)
    finally:
        obs.reset()  # the campaign's recorder and watchdog stay off
    stream_s = time.time() - started
    bad += stream["failures"]
    solves, launches = stream["solves_by_backend"], stream["kernel_launches"]
    # One launch of kernel A a replan the pdhg rung made, in each run and
    # in the replays of the churned run's plans.
    for run, made in (("baseline", solves["baseline"].get("pdhg", 0)),
                      ("chaos", solves["chaos"].get("pdhg", 0)),
                      ("replay", solves["chaos"].get("pdhg", 0))):
        if launches[run]["eg_pdhg"] != made or made < 1:
            bad.append(f"streaming {run}: kernel A launched "
                       f"{launches[run]['eg_pdhg']} times for {made} pdhg "
                       "replans")
    print(f"  streaming soak (--smoke, planner on the card): "
          f"{stream['total_events']} events ({stream['applied_fault_events']}"
          f" faults), {stream['admission']['rejected_batches']} rejects "
          f"drained, {stream['admission']['deduped_batches']} dedups, p99 "
          f"replan {stream['replan_p99_s']} s, {stream['replay_exact']} of "
          f"{stream['replayed_plans']} plans replayed exactly; makespan "
          f"{stream['baseline']['makespan_s']:.1f} s fault-free against "
          f"{stream['chaos']['makespan_s']:.1f} s, worst FTF "
          f"{stream['baseline']['worst_ftf']:.3f} against "
          f"{stream['chaos']['worst_ftf']:.3f}; solves {solves}, launches "
          f"{launches}; {stream_s:.1f} s {tag}", flush=True)

    if ingest_soak.parity_check() != 0:
        bad.append("ingest: the scalar and the columnar decode disagree")
    # The campaign runs as its own process, as a user runs it: its server's
    # threads share no interpreter with what earlier phases left running.
    started = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "shockwave_tpu_torch.tools.ingest_soak",
         "--device", "cuda", "--reps", "1", "--out",
         str(SOAKS_OUT)], cwd=ROOT, capture_output=True, text=True,
        timeout=INGEST_TIMEOUT_S)
    ingest_s = time.time() - started
    try:
        ingest = json.loads((SOAKS_OUT / "ingest_soak.json").read_text())
    except (OSError, ValueError):
        fail(f"ingest soak: exit {run.returncode}, no result: "
             f"{run.stdout[-1500:]!r} {run.stderr[-1500:]!r}")
    bad += [f"ingest: {v}" for v in ingest["violations"]]
    floors = (ingest["config"]["min_rate"], ingest["config"]["p99_budget_ms"])
    if floors != INGEST_FLOORS:
        bad.append(f"ingest: floors {floors}, not {INGEST_FLOORS}")
    if run.returncode != (1 if ingest["violations"] else 0):
        bad.append(f"ingest: exit {run.returncode}: {run.stderr[-1500:]!r}")
    pricing_launches = ingest["pricing"]["kernel_a_launches"]
    if pricing_launches < ingest["pricing"]["dispatches"]:
        bad.append(f"ingest pricing: kernel A launched {pricing_launches} "
                   f"times for {ingest['pricing']['dispatches']} dispatches")
    print(f"  ingest soak (full scale, one rep, the socket front door): "
          f"{ingest['throughput']['total_jobs']} jobs at "
          f"{ingest['throughput']['submits_per_s']:.1f} jobs/s over "
          f"{ingest['throughput']['fleet_span_s']:.3f} s (floor "
          f"{INGEST_FLOORS[0]:.0f}), queue p50 "
          f"{ingest['latency']['queue_p50_ms']} ms p99 "
          f"{ingest['latency']['queue_p99_ms']} ms (budget "
          f"{INGEST_FLOORS[1]:.0f}); per peer {ingest['interop']}; "
          f"{ingest['exactly_once']['faults_applied']} faults, "
          f"{ingest['exactly_once']['deduped_batches']} dedups, lost "
          f"{len(ingest['exactly_once']['lost'])}, double "
          f"{len(ingest['exactly_once']['double_admitted'])}; pricing "
          f"{ingest['pricing']['lanes_priced']} lanes in "
          f"{ingest['pricing']['dispatches']} dispatches (largest "
          f"{ingest['pricing']['max_convoy']}), audit "
          f"{ingest['pricing']['audit']}, kernel A launches "
          f"{pricing_launches}; {ingest_s:.1f} s {tag}", flush=True)
    if bad:
        fail("soaks phase: " + "; ".join(bad))
    return {"streaming": {k: v for k, v in stream.items()
                          if k not in ("failures", "submitter")},
            "ingest": {k: ingest[k] for k in (
                "config", "throughput", "latency", "interop", "pricing")},
            "ingest_faults": ingest["exactly_once"]["faults_applied"],
            "launches": (sum(r["eg_pdhg"] for r in launches.values())
                         + pricing_launches),
            "pricing_launches": pricing_launches,
            "seconds": {"streaming": stream_s, "ingest": ingest_s}}


# Phase 23: gangs of the training program on card 0, each rank a
# ``python -m shockwave_tpu_torch.models.train`` process over gloo (NCCL
# refuses two ranks on one card): the 110M tier with its sequence over the
# two ranks (ring 3 steps, Ulysses 2), and the MoE tier's widths cut to 2
# layers over two data shards, all three at once. Each is held to one
# process on the same card, weights and global batch.
GANG_SEQ_STEPS = {"ring": 3, "ulysses": 2}
GANG_MOE_STEPS = 2
GANG_MOE_LAYERS = 2
# The model-parallel gangs (tensor and expert parallelism over "model"):
# their steps, and their losses against one process's.
GANG_MODEL_STEPS = 2
# Batch 4: fourteen ranks and the references share the card's memory (72
# GiB at their peak on an H100; at batch 8 they overflow its 80 GB).
GANG_MODEL_BATCH = 4
# The dense model gang against one process on the card (NVIDIA H100 80GB
# HBM3, 700.00 W): its losses 7.66e-6 and 8.38e-6 apart (relative), its
# whole parameters 0.0862 of the update apart, worst the last layer's
# query weight 0.1806 (batch 8: 0.0810, 0.1539). A rank's row-parallel
# products are rounded to bf16 before the sum over "model", and AdamW's
# first steps move a parameter by about the learning rate whatever its
# gradient's size, so a gradient near zero that rounds otherwise moves it
# the other way. A gang whose first layer leaves its input gradients
# unsummed over "model" lies 0.2867 off, worst that layer's ln1 bias
# 1.0087: each limit below rejects it alone.
MODEL_LOSS_RTOL = 1e-4
MODEL_PARAMS_RTOL = 0.15
MODEL_PARAM_RTOL = 0.5
# The MoE's experts over "model": the first step's loss equal to the bit,
# the second 7.92e-5 apart and the whole parameters 0.2021 (worst an
# expert's w_out, 0.2675), the bf16 rounding above moving tokens between
# experts at near ties; the limits are about 6 and 2.5 times those.
MODEL_MOE_LOSS_RTOL = 5e-4
MODEL_MOE_PARAMS_RTOL = 0.5
MODEL_MOE_PARAM_RTOL = 0.7
# The pipeline over a two-rank pipe gang.
PIPE_LAYERS = 4
PIPE_MICROBATCHES = 4
PIPE_STEPS = 2
PIPE_RTOL = 1e-5
GANG_MOE_BATCH = 4  # a rank's: the global batch is the tier's 8
GANG_CARD_TIMEOUT_S = 300.0
GANG_OUT = ROOT / "_smoke_out" / "gangs"
# The seq gangs' parameters after their last step against the one-process
# run's, as a share of that run's update (Frobenius): over all parameters,
# and for the worst one. On an H100 the ring gang's lie 0.0134 apart (worst
# the last layer's key weight, 0.0337) and Ulysses' 0.0141 (0.0383), the
# bf16 products of half a sequence a rank rounding apart from one
# process's; one process's reruns are bit-equal. A ring whose live hop
# gives its K/V block no gradient (the hop's gradient never sent back)
# moves them 0.146 (worst 0.775) in the first layer alone, 0.324 (0.927)
# in the last and 0.608 (0.976) in every layer, while its losses move
# by as little as 1.7e-6 at step 2 and 8.4e-5 at step 3.
GANG_PARAMS_RTOL = 0.05
GANG_PARAM_RTOL = 0.15
# The MoE gang against one process on the global batch, bf16: the dense
# products run at batch 4 a rank against 8 in one process, so cuBLAS may
# tile them otherwise and the bf16 activations round apart, and a
# near-tie router choice may flip between experts. On an H100 the two
# steps' losses are 2.9e-6 apart (relative); the limit is 1e-4, about
# 35 times that.
MOE_GANG_RTOL = 1e-4
_MESH_LINE = re.compile(r"^MESH backend=(\w+) rank=(\d+) world=(\d+) "
                           r"mesh=(\{.*\}) device=(\S+)$", re.M)
_GANG_LINE = re.compile(r"^GANG rank=(\d+) world=\d+ params=(\w+) "
                        r"losses=(\[.*\])$", re.M)


def gang_argv(steps: int, attention: str, batch: int = 8,
              layers: int = 8) -> list:
    """The 110M tier's command line (no checkpoint) at ``layers``."""
    return ["--model", "Transformer", "--batch_size", str(batch), "-n",
            str(steps), "--vocab_size", "8192", "--d_model", "1024",
            "--num_heads", "8", "--num_layers", str(layers), "--seq_len",
            "2048", "--attention", attention, "--dtype", "bfloat16",
            "--learning_rate", "1e-3", "--seed", "0", "--device", "cuda"]


def start_card_gang(argv: list, ranks: int = 2, threads: int = 1) -> dict:
    """Starts ``ranks`` processes of the training program on the card, one
    gang, each with ``threads`` CPU threads; :func:`finish_card_gang`
    collects them."""
    from shockwave_tpu_torch.runtime.testing import free_port

    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, SHOCKWAVE_PHASE_TIMINGS="1",
               OMP_NUM_THREADS=str(threads),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shockwave_tpu_torch.models.train", *argv,
         "--distributed_addr", addr, "--num_workers", str(ranks),
         "--distributed_timeout", "120", "--worker_rank", str(rank)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(ranks)]
    return {"procs": procs, "started": time.time()}


def finish_card_gang(gang: dict) -> dict:
    """Each rank's exit code, backend line, losses, parameter digest,
    flash launches and phases, and the gang's seconds."""
    procs, outs = gang["procs"], []
    try:
        for proc in procs:
            left = gang["started"] + GANG_CARD_TIMEOUT_S - time.time()
            outs.append(proc.communicate(timeout=max(left, 1.0))[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.time() - gang["started"]
    result = []
    for proc, out in zip(procs, outs + [""] * (len(procs) - len(outs))):
        backend = _MESH_LINE.search(out)
        line = _GANG_LINE.search(out)
        launches = _LAUNCHES_LINE.search(out)
        phases = _PHASES_LINE.search(out)
        result.append({
            "exit": proc.returncode,
            "backend": backend.group(1) if backend else None,
            "device": backend.group(5) if backend else None,
            "losses": json.loads(line.group(3)) if line else None,
            "params": line.group(2) if line else None,
            "launches": json.loads(launches.group(1)) if launches else {},
            "phases": phases.group(1) if phases else None,
            "steps_device_cuda": bool(re.search(
                r"steps=\d+ .* device=cuda$", out, re.M)),
            "resumed": "RESUMED from" in out,
            "tail": out[-2000:]})
    return {"ranks": result, "seconds": seconds}


# The seed's weights of each configuration phase 23's references train,
# drawn once (a draw of the 110M tier takes seconds of the host's CPU,
# which the gangs' ranks are drawing theirs on).
_SEED_STATES = {}


def seed_family(train, args, device, mesh=None):
    """``train.build_family("Transformer", args, device, mesh)``, its
    weights the seed's: drawn for the first run of a configuration, then
    loaded from that draw."""
    key = tuple(getattr(args, k) for k in (
        "vocab_size", "d_model", "num_heads", "num_layers", "seq_len",
        "num_experts", "num_kv_heads", "positional", "seed"))
    cached = _SEED_STATES.get(key)
    built = train.build_family("Transformer", args, device, mesh,
                               draw=cached is None)
    if cached is None:
        _SEED_STATES[key] = {k: v.detach().to("cpu", copy=True)
                             for k, v in built[0].state_dict().items()}
    else:
        built[0].load_state_dict(cached)
    return built


def host_params(model) -> dict:
    """The model's parameters, copied to the host as float32."""
    return {name: p.detach().to("cpu", torch.float32, copy=True)
            for name, p in model.named_parameters()}


def one_process_seq_run(train, device, attention: str, steps: int,
                        fault=None) -> dict:
    """The seq gang's ``steps`` steps in one process over a two-place seq
    mesh of the card, on the same seed-0 weights and global batch (the
    data group's one draw from the seed): the losses, and the parameters
    before and after on the host. ``fault`` replaces the ring's
    ``flash_attention_lse`` for the run (a planted fault)."""
    from shockwave_tpu_torch.parallel import ring_attention as ra
    from shockwave_tpu_torch.parallel.mesh import make_mesh

    args = train.parse_args(gang_argv(steps, attention))
    mesh = make_mesh((1, 1, 2, 1), [device, device])
    model, step_fn, opt, batch_fn = seed_family(train, args, device, mesh)
    start = host_params(model)
    rng = np.random.default_rng(args.seed)
    attend = ra.flash_attention_lse
    ra.flash_attention_lse = fault or attend
    try:
        losses = [float(step_fn(batch_fn(rng))) for _ in range(steps)]
    finally:
        ra.flash_attention_lse = attend
    end = host_params(model)
    del model, step_fn, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "start": start, "end": end}


def live_hop_kv_grad_dropped(attend, layers, num_layers: int):
    """``flash_attention_lse`` as a two-shard ring's flash body would see
    it with one bug: in each layer of ``layers`` the live hop gives its
    K/V block no gradient, as if that hop's gradients were never sent back
    to the rank that sent the block. The ring has one live hop a layer,
    called layer by layer in each forward."""
    calls = [0]

    def faulty(q, k, v, causal=True, window=None):
        if not causal:
            if calls[0] % num_layers in layers:
                k, v = k.detach(), v.detach()
            calls[0] += 1
        return attend(q, k, v, causal=causal, window=window)

    return faulty


def update_errors(got: dict, ref: dict) -> tuple:
    """How far parameters ``got`` lie from ``ref["end"]``, relative to
    the reference's own update (``ref["end"] - ref["start"]``, Frobenius):
    (the worst parameter's name, its error, the error over all of them)."""
    worst, total, moved = ("", 0.0), 0.0, 0.0
    for name, end in ref["end"].items():
        miss = float(torch.linalg.vector_norm(got[name].float() - end))
        step = float(torch.linalg.vector_norm(end - ref["start"][name]))
        total, moved = total + miss ** 2, moved + step ** 2
        rel = miss / step if step else (math.inf if miss else 0.0)
        if rel > worst[1]:
            worst = (name, rel)
    return worst[0], worst[1], math.sqrt(total / moved)


def one_process_moe_losses(train, device) -> list:
    """The MoE gang's steps in one process on the global batch: the two
    ranks' draws (``--seed + r``, a rank's batch each) stacked."""
    args = train.parse_args(moe_gang_argv(2 * GANG_MOE_BATCH))
    model, step_fn, opt, _ = seed_family(train, args, device)
    rngs = [np.random.default_rng(args.seed + r) for r in range(2)]
    losses = []
    for _ in range(GANG_MOE_STEPS):
        # Each rank's draw, as its batch_fn makes it.
        batch = np.concatenate([rng.integers(
            0, args.vocab_size, (GANG_MOE_BATCH, args.seq_len + 1))
            for rng in rngs])
        losses.append(float(step_fn(torch.from_numpy(batch).to(device))))
    del model, step_fn, opt
    torch.cuda.empty_cache()
    return losses


def model_gang_argv(moe: bool) -> list:
    """The model-parallel gang's command line: the 110M tier at batch
    ``GANG_MODEL_BATCH``, or with ``moe`` the MoE tier's 2 layers at
    batch 8 (no checkpoint)."""
    if moe:
        return moe_gang_argv(8) + ["--model_parallel", "2"]
    return gang_argv(GANG_MODEL_STEPS, "flash", GANG_MODEL_BATCH) + [
        "--model_parallel", "2"]


def one_process_run(train, device, argv: list) -> dict:
    """``argv``'s steps in one process on the card (no model axis), from
    the seed's weights and draws: losses, parameters before and after."""
    args = train.parse_args(argv)
    args.model_parallel = 1
    model, step_fn, opt, batch_fn = seed_family(train, args, device)
    start = host_params(model)
    rng = np.random.default_rng(args.seed)
    losses = [float(step_fn(batch_fn(rng))) for _ in range(args.num_steps)]
    end = host_params(model)
    del model, step_fn, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "start": start, "end": end}


def _init_rank(rank: int, addr: str) -> None:
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def planted_model_rank(rank: int, addr: str) -> None:
    """A rank of (d)'s gang with one planted fault: the first layer's
    attention and MLP inputs take their gradient from this rank's heads
    and columns alone (the backward all-reduce over "model" left out).
    From the seed checkpoint, as (d)'s ranks start; rank 0 saves the
    losses and the whole parameters after the steps."""
    import torch.distributed as dist

    from shockwave_tpu_torch.models import train
    from shockwave_tpu_torch.parallel.mesh import make_process_mesh

    from shockwave_tpu_torch.models import transformer

    _init_rank(rank, addr)
    args = train.parse_args(model_gang_argv(False))
    mesh = make_process_mesh(1, 2)
    device = torch.device("cuda")
    model, step_fn, opt, batch_fn = train.build_family(
        "Transformer", args, device, mesh, train.Gang(), draw=False)
    train.FileCheckpoint(str(GANG_OUT / "seed")).load(model, opt, device,
                                                      mesh)
    # A forward copies its input to the model axis twice a layer (the
    # attention's and the MLP's) and once for the head; the first layer's
    # two copies become the identity, which sums no gradient.
    copy, calls = transformer.copy_to_model, [0]

    def faulty(x, mesh):
        calls[0] += 1
        if (calls[0] - 1) % (2 * args.num_layers + 1) < 2:
            return x
        return copy(x, mesh)

    transformer.copy_to_model = faulty
    rng = np.random.default_rng(args.seed)
    losses = [float(step_fn(batch_fn(rng))) for _ in range(args.num_steps)]
    state, _ = train.whole_state(model, opt, mesh)
    if rank == 0:
        torch.save({"losses": losses, "params": {
            k: v.detach().to("cpu", torch.float32) for k, v in state.items()}},
            GANG_OUT / "planted_model.pt")
    dist.destroy_process_group()


def pipe_config():
    from shockwave_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=8192, d_model=1024, num_heads=8,
                             num_layers=PIPE_LAYERS, d_ff=4096, max_len=2048,
                             dtype="bfloat16", attention="flash")


def pipe_inputs(device):
    """The pipeline's whole parameters (from seed 0) and its [8, 2049]
    tokens, on ``device``."""
    from shockwave_tpu_torch.parallel.pipeline import PipelinedLM, _tree_map

    params = PipelinedLM(pipe_config(), 2, PIPE_MICROBATCHES).init(
        torch.Generator().manual_seed(0), None)
    tokens = np.random.default_rng(0).integers(0, 8192, (8, 2049))
    return (_tree_map(lambda p: p.to(device), params),
            torch.from_numpy(tokens).to(device))


def pipe_steps(model, params, tokens) -> list:
    """``PIPE_STEPS`` AdamW steps of ``model.loss``: the losses."""
    from shockwave_tpu_torch.ops.fused_adamw import FusedAdamW
    from shockwave_tpu_torch.parallel.pipeline import _leaves

    for leaf in _leaves(params):
        leaf.requires_grad_()
    opt = FusedAdamW(_leaves(params), 1e-3)
    losses = []
    for _ in range(PIPE_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, tokens)
        loss.backward()
        model.sum_replicated_gradients(params)
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def pipe_rank(rank: int, addr: str) -> None:
    """Stage ``rank`` of (f)'s pipeline over a two-rank pipe gang: its
    losses and flash launches into ``GANG_OUT``."""
    import torch.distributed as dist

    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.parallel.mesh import make_process_mesh
    from shockwave_tpu_torch.parallel.pipeline import PipelinedLM

    _init_rank(rank, addr)
    mesh = make_process_mesh(pipe_parallel=2)
    model = PipelinedLM(pipe_config(), 2, PIPE_MICROBATCHES, mesh)
    params, tokens = pipe_inputs(torch.device("cuda"))
    losses = pipe_steps(model, model.shard_params(params), tokens)
    (GANG_OUT / f"pipe{rank}.json").write_text(json.dumps(
        {"losses": losses, "launches": dict(fa.LAUNCHES)}))
    dist.destroy_process_group()


def start_function_gang(function: str) -> dict:
    """Two processes running ``chip_smoke.<function>(rank, addr)`` on the
    card, one CPU thread each; :func:`finish_card_gang` collects them."""
    from shockwave_tpu_torch.runtime.testing import free_port

    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; "
         f"chip_smoke.{function}({rank}, {addr!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    return {"procs": procs, "started": time.time()}


def one_process_pipe(device) -> dict:
    """(f) in one process: the loss of ``logits_sequential`` and the
    pipelined steps' losses."""
    from shockwave_tpu_torch.models.small_models import token_xent
    from shockwave_tpu_torch.parallel.pipeline import PipelinedLM

    model = PipelinedLM(pipe_config(), 2, PIPE_MICROBATCHES)
    params, tokens = pipe_inputs(device)
    with torch.no_grad():
        sequential = float(token_xent(model.logits_sequential(
            params, tokens[:, :-1]), tokens[:, 1:]))
    losses = pipe_steps(model, params, tokens)
    del params
    torch.cuda.empty_cache()
    return {"sequential_loss": sequential, "losses": losses}


def moe_gang_argv(batch: int) -> list:
    return gang_argv(GANG_MOE_STEPS, "flash", batch, GANG_MOE_LAYERS) + [
        "--num_experts", str(MOE_EXPERTS), "--moe_dispatch", "grouped",
        "--moe_capacity_factor", "1.25"]


def _gang_checks(what: str, gang: dict, steps: int) -> list:
    bad = []
    ranks = gang["ranks"]
    for rank, r in enumerate(ranks):
        if (r["exit"] != 0 or r["losses"] is None or len(r["losses"]) != steps
                or not all(math.isfinite(x) for x in r["losses"])):
            bad.append(f"{what} rank {rank}: exit {r['exit']}, losses "
                       f"{r['losses']}: {r['tail']!r}")
        if r["backend"] != "gloo" or r["device"] != "cuda:0" or not r[
                "steps_device_cuda"]:
            bad.append(f"{what} rank {rank}: backend {r['backend']}, device "
                       f"{r['device']}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        bad.append(f"{what}: the ranks' losses differ: "
                   f"{[r['losses'] for r in ranks]}")
    if ranks[0]["params"] != ranks[1]["params"]:
        bad.append(f"{what}: the ranks hold different parameters")
    return bad


def run_gangs(train, device, card: str) -> dict:
    """Phase 23 (docstring, item 23). The gangs run at once (fourteen
    processes on card 0, one CPU thread each), while this process runs the
    one-process references. Every check is hard."""
    tag = f"[{card}]"
    print(f"gang phase {tag}:", flush=True)
    torch.cuda.empty_cache()
    started = time.time()
    shutil.rmtree(GANG_OUT, ignore_errors=True)
    # The 110M tier's seed weights, drawn once here: its gangs' ranks
    # resume them from a step-0 checkpoint (a rank's draw takes seconds of
    # the host's CPU, which fourteen ranks share).
    model, _, opt, _ = seed_family(train, train.parse_args(
        gang_argv(1, "flash")), torch.device("cpu"))
    train.FileCheckpoint(str(GANG_OUT / "seed")).save(model, opt, 0)
    del model, opt
    for name in ("ring", "ulysses", "model"):
        (GANG_OUT / name).mkdir(parents=True)
        os.link(GANG_OUT / "seed" / train.CHECKPOINT_NAME,
                GANG_OUT / name / train.CHECKPOINT_NAME)
    gangs = {attention: start_card_gang(
        gang_argv(steps, attention) + ["--seq_parallel", "2",
                                       "--checkpoint_dir",
                                       str(GANG_OUT / attention)])
        for attention, steps in GANG_SEQ_STEPS.items()}
    gangs["moe"] = start_card_gang(moe_gang_argv(GANG_MOE_BATCH))
    for name, moe in (("model", False), ("model_moe", True)):
        gangs[name] = start_card_gang(model_gang_argv(moe) + [
            "--checkpoint_dir", str(GANG_OUT / name)])
    GANG_OUT.mkdir(parents=True, exist_ok=True)
    gangs["planted_model"] = start_function_gang("planted_model_rank")
    gangs["pipe"] = start_function_gang("pipe_rank")
    alone = {attention: one_process_seq_run(train, device, attention, steps)
             for attention, steps in GANG_SEQ_STEPS.items()}
    alone["moe"] = one_process_moe_losses(train, device)
    for name, moe in (("model", False), ("model_moe", True)):
        alone[name] = one_process_run(train, device, model_gang_argv(moe))
    alone["pipe"] = one_process_pipe(device)
    # The parameter limits must reject the ring's subtlest planted bug.
    from shockwave_tpu_torch.parallel import ring_attention as ra

    planted = one_process_seq_run(
        train, device, "ring", GANG_SEQ_STEPS["ring"],
        fault=live_hop_kv_grad_dropped(ra.flash_attention_lse, (0,), 8))
    planted_errors = update_errors(planted["end"], alone["ring"])
    del planted
    gangs = {name: finish_card_gang(gang) for name, gang in gangs.items()}
    bad, readings, launches = [], {}, {}
    for name in ("ring", "ulysses", "model"):
        if not all(r["resumed"] for r in gangs[name]["ranks"]):
            bad.append(f"{name} gang: a rank did not resume the seed "
                       "checkpoint")
    for attention, steps in GANG_SEQ_STEPS.items():
        gang, what = gangs[attention], f"{attention} seq gang"
        bad += _gang_checks(what, gang, steps)
        for rank, r in enumerate(gang["ranks"]):
            causal = steps * 8  # one launch a layer a step on each rank
            want = {"flash_fwd": causal, "flash_dkv": causal,
                    "flash_dq": causal}
            if attention == "ring":  # rank 1's one live hop a layer
                want.update({k + "_nc": causal * rank for k in
                             ("flash_fwd", "flash_dkv", "flash_dq")})
            got = {k: r["launches"].get(k, 0) for k in want}
            if got != want:
                bad.append(f"{what} rank {rank}: flash launches {got}, "
                           f"expected {want}")
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        ref = alone[attention]
        losses = gang["ranks"][0]["losses"] or [float("nan")] * steps
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        if not (errs[0] <= RING_LOSS_RTOL
                and all(e <= RING_STEPS_RTOL for e in errs)):
            bad.append(f"{what}: losses {losses} against one process's "
                       f"{ref['losses']} (relative {errs}; limits "
                       f"{RING_LOSS_RTOL} on step 1, {RING_STEPS_RTOL} on "
                       "each)")
        # The parameters rank 0 saved after the last step, against the
        # one-process run's: the multi-process backward (the ring's hop
        # gradients sent back, Ulysses' all-to-all backward, the pinned
        # staging) moves them.
        try:
            saved = torch.load(GANG_OUT / attention / train.CHECKPOINT_NAME,
                               map_location="cpu", weights_only=True)["model"]
            name, worst, overall = update_errors(saved, ref)
            del saved
        except (OSError, RuntimeError, KeyError) as e:
            name, worst, overall = f"no checkpoint: {e}", math.inf, math.inf
        if not (worst <= GANG_PARAM_RTOL and overall <= GANG_PARAMS_RTOL):
            bad.append(f"{what}: parameters after {steps} steps {overall:.4f} "
                       f"of the update off one process's (limit "
                       f"{GANG_PARAMS_RTOL}), worst {name} {worst:.4f} "
                       f"(limit {GANG_PARAM_RTOL})")
        readings[attention] = {
            "losses": losses, "one_process_losses": ref["losses"],
            "loss_rel_errs": errs, "param_update_rel_err": overall,
            "worst_param": name, "worst_param_update_rel_err": worst,
            "seconds": gang["seconds"],
            "phases": [r["phases"] for r in gang["ranks"]],
            "launches": [r["launches"] for r in gang["ranks"]]}
        print(f"  {what} (110M tier, 2 ranks on card 0 over gloo, {steps} "
              f"steps): losses {losses} on both ranks; one process over a "
              f"two-place mesh {ref['losses']} (relative "
              f"{[f'{e:.2e}' for e in errs]}); parameters {overall:.4f} of "
              f"the update apart, worst {name} {worst:.4f}; launches "
              f"{[r['launches'] for r in gang['ranks']]}; phases "
              f"{[r['phases'] for r in gang['ranks']]}; "
              f"{gang['seconds']:.1f} s {tag}", flush=True)
    name, worst, overall = planted_errors
    print(f"  planted: the ring's first-layer live hop without its K/V "
          f"gradient moves one process's parameters {overall:.4f} of the "
          f"update, worst {name} {worst:.4f}", flush=True)
    if worst <= GANG_PARAM_RTOL and overall <= GANG_PARAMS_RTOL:
        bad.append("the gang's parameter limits accept a ring hop without "
                   "its K/V gradient")
    readings["planted_param_update_rel_err"] = overall
    gang = gangs["moe"]
    bad += _gang_checks("MoE gang", gang, GANG_MOE_STEPS)
    got = gang["ranks"][0]["losses"] or [float("nan")] * GANG_MOE_STEPS
    errs = [abs(a - b) / abs(b) for a, b in zip(got, alone["moe"])]
    if not all(e <= MOE_GANG_RTOL for e in errs):
        bad.append(f"MoE gang: losses {got} against one process's "
                   f"{alone['moe']} (relative {errs}, limit {MOE_GANG_RTOL})")
    readings["moe"] = {"losses": got, "one_process_losses": alone["moe"],
                       "rel_errs": errs, "seconds": gang["seconds"],
                       "phases": [r["phases"] for r in gang["ranks"]]}
    print(f"  MoE gang ({MOE_EXPERTS} experts, {GANG_MOE_LAYERS} layers, 2 "
          f"ranks of batch {GANG_MOE_BATCH} on card 0): losses {got} on both "
          f"ranks; one process on the global batch {alone['moe']} (relative "
          f"{[f'{e:.2e}' for e in errs]}, limit {MOE_GANG_RTOL}); "
          f"{gang['seconds']:.1f} s {tag}", flush=True)
    model_launches = {}
    for name, what in (("model", "model-parallel gang"),
                       ("model_moe", "MoE gang over \"model\"")):
        gang, ref = gangs[name], alone[name]
        steps = len(ref["losses"])
        bad += _gang_checks(what, gang, steps)
        layers = GANG_MOE_LAYERS if name == "model_moe" else 8
        want = {k: steps * layers for k in ("flash_fwd", "flash_dkv",
                                             "flash_dq")}
        for rank, r in enumerate(gang["ranks"]):
            got = {k: r["launches"].get(k, 0) for k in want}
            if got != want or any(r["launches"].get(k + "_nc", 0)
                                  for k in want):
                bad.append(f"{what} rank {rank}: flash launches "
                           f"{r['launches']}, expected {want}")
            for k, v in r["launches"].items():
                model_launches[k] = model_launches.get(k, 0) + v
        loss_rtol, params_rtol, param_rtol = (
            (MODEL_MOE_LOSS_RTOL, MODEL_MOE_PARAMS_RTOL, MODEL_MOE_PARAM_RTOL)
            if name == "model_moe" else
            (MODEL_LOSS_RTOL, MODEL_PARAMS_RTOL, MODEL_PARAM_RTOL))
        losses = gang["ranks"][0]["losses"] or [float("nan")] * steps
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        if not all(e <= loss_rtol for e in errs):
            bad.append(f"{what}: losses {losses} against one process's "
                       f"{ref['losses']} (relative {errs}, limit "
                       f"{loss_rtol})")
        try:
            saved = torch.load(GANG_OUT / name / train.CHECKPOINT_NAME,
                               map_location="cpu", weights_only=True)["model"]
            pname, worst, overall = update_errors(saved, ref)
            del saved
        except (OSError, RuntimeError, KeyError) as e:
            pname, worst, overall = f"no checkpoint: {e}", math.inf, math.inf
        if not (worst <= param_rtol and overall <= params_rtol):
            bad.append(f"{what}: whole parameters after {steps} steps "
                       f"{overall:.4f} of the update off one process's (limit "
                       f"{params_rtol}), worst {pname} {worst:.4f} (limit "
                       f"{param_rtol})")
        readings[name] = {
            "losses": losses, "one_process_losses": ref["losses"],
            "loss_rel_errs": errs, "param_update_rel_err": overall,
            "worst_param": pname, "worst_param_update_rel_err": worst,
            "seconds": gang["seconds"],
            "phases": [r["phases"] for r in gang["ranks"]],
            "launches": [r["launches"] for r in gang["ranks"]]}
        print(f"  {what} (2 ranks on card 0 over gloo, {steps} steps, "
              f"{layers} layers): losses {losses} on both ranks; one process "
              f"{ref['losses']} (relative {[f'{e:.2e}' for e in errs]}, limit "
              f"{loss_rtol}); whole parameters {overall:.4f} of the "
              f"update apart, worst {pname} {worst:.4f}; launches "
              f"{[r['launches'] for r in gang['ranks']]}; phases "
              f"{[r['phases'] for r in gang['ranks']]}; "
              f"{gang['seconds']:.1f} s {tag}", flush=True)
    planted = gangs["planted_model"]
    try:
        got = torch.load(GANG_OUT / "planted_model.pt", map_location="cpu",
                         weights_only=True)
        pname, worst, overall = update_errors(got["params"], alone["model"])
        planted_losses = got["losses"]
    except (OSError, RuntimeError, KeyError) as e:
        bad.append(f"the planted model-parallel gang did not run: {e}: "
                   f"{[r['tail'] for r in planted['ranks']]}")
        pname, worst, overall, planted_losses = "", 0.0, 0.0, None
    print(f"  planted: a model-parallel gang whose first layer leaves its "
          f"input gradients unsummed over \"model\" lies {overall:.4f} of "
          f"the update off one process's, worst {pname} {worst:.4f} (losses "
          f"{planted_losses}); {planted['seconds']:.1f} s {tag}", flush=True)
    if worst <= MODEL_PARAM_RTOL or overall <= MODEL_PARAMS_RTOL:
        bad.append("the model gang's parameter limits accept a layer "
                   "without its backward all-reduce over \"model\"")
    readings["planted_model_param_update_rel_err"] = overall
    readings["planted_model_worst"] = [pname, worst]
    pipe, ref = gangs["pipe"], alone["pipe"]
    ranks = []
    for rank, r in enumerate(pipe["ranks"]):
        try:
            ranks.append(json.loads((GANG_OUT / f"pipe{rank}.json")
                                    .read_text()))
        except (OSError, ValueError) as e:
            bad.append(f"pipe gang rank {rank}: exit {r['exit']}, {e}: "
                       f"{r['tail']!r}")
    pipe_errs = []
    if len(ranks) == 2:
        if ranks[0]["losses"] != ranks[1]["losses"]:
            bad.append(f"pipe gang: the ranks' losses differ: "
                       f"{[r['losses'] for r in ranks]}")
        losses = ranks[0]["losses"]
        pipe_errs = [abs(a - b) / abs(b) for a, b in zip(
            [losses[0]] + losses, [ref["sequential_loss"]] + ref["losses"])]
        if len(losses) != PIPE_STEPS or not all(e <= PIPE_RTOL
                                                for e in pipe_errs):
            bad.append(f"pipe gang: losses {losses} against one process's "
                       f"{ref['losses']} and logits_sequential's "
                       f"{ref['sequential_loss']} (relative {pipe_errs}, "
                       f"limit {PIPE_RTOL})")
    readings["pipe"] = {"ranks": ranks, "one_process": ref,
                        "rel_errs": pipe_errs, "seconds": pipe["seconds"]}
    print(f"  pipe gang (PipelinedLM, {PIPE_LAYERS} layers in 2 stages, "
          f"{PIPE_MICROBATCHES} microbatches, 2 ranks on card 0 over gloo, "
          f"{PIPE_STEPS} steps): losses {[r['losses'] for r in ranks]}; one "
          f"process {ref['losses']}, logits_sequential's loss "
          f"{ref['sequential_loss']} (relative "
          f"{[f'{e:.2e}' for e in pipe_errs]}, limit {PIPE_RTOL}); launches "
          f"{[r['launches'] for r in ranks]}; {pipe['seconds']:.1f} s {tag}",
          flush=True)
    _SEED_STATES.clear()
    print(f"  every gang at once and the references: "
          f"{time.time() - started:.1f} s {tag}", flush=True)
    if bad:
        fail("gang phase: " + "; ".join(bad))
    return {**readings, "launches": launches,
            "model_launches": model_launches}


# Phase 17: the physical control plane, through the card driver's loop
# (``tools/physical_drivers.py``). The payload is phase 6's 110M tier at its
# widths, cut to 4 layers, at batch 8. The agent registers as ``h100`` and
# the planner plans from phase 20's oracle, the payload's rate measured on
# this card under its own label; the jobs are sized as the card driver
# sizes them (``localize_jobs``: the oracle's rate x 0.5 x the training
# seconds, two payloads sharing the card), to ``PHYSICAL_JOB_EPOCHS``
# epochs of 1250 steps. Under the card's own rate the planner's priorities
# move only when a job finishes an epoch (three one-epoch jobs tie, and the
# first runs to its end): after a job's first epoch the planner stops it,
# and a lease it extended before then runs on for up to a round and a
# half, which the rest of the job must outlast (tests/physical_rotation.py;
# tests/test_torch_physical.py holds the rotation under a scripted clock).
PHYSICAL_OUT = ROOT / "_smoke_out" / "physical"
PHYSICAL_SLOTS = 2
PHYSICAL_JOBS = 3
PHYSICAL_WORKER_TYPE = "h100"
PHYSICAL_BATCH = 8
PHYSICAL_JOB_TYPE = f"Transformer (batch size {PHYSICAL_BATCH})"
PHYSICAL_LAYERS = 4
PHYSICAL_WIDTHS = ("--vocab_size 8192 --d_model 1024 --num_heads 8 "
                   f"--num_layers {PHYSICAL_LAYERS} --seq_len 2048 "
                   "--dtype bfloat16 --attention flash")
# The rounds' length: a fresh payload reaches its first lease 14-29 s after
# its dispatch on the card (two start together), so shorter rounds end
# attempts at their leases before they train; longer ones need longer jobs
# to rotate, and a job run on for more than about six rounds unbroken
# refreshes its lease too seldom for the scheduler's silence limit (1.5
# rounds) and is killed (ROADMAP.md, queue 3).
PHYSICAL_ROUND_S = 25.0
PHYSICAL_JOB_EPOCHS = 1.4
PHYSICAL_BUFFER_S = 30.0
PHYSICAL_TIMEOUT_S = 480.0
# The driver's limit on the whole smoke, and what the last phase leaves of
# it for the lines after the phases and the process's end.
SMOKE_LIMIT_S = 1200.0
EXIT_MARGIN_S = 60.0
# Phase 18 took 63.6-84.2 s on the card (PERF.md section 6, PR 15); phase
# 17's deadline leaves it this much.
FAILOVER_RESERVE_S = 100.0
# The phases that run to a deadline, in their order, with the seconds each
# reserves before the smoke's end (phase 17 takes what is left before 18).
LATE_PHASES = (("physical", 0.0), ("failover", FAILOVER_RESERVE_S))


def phase_deadlines(started: float, limit: float = SMOKE_LIMIT_S,
                    reserves=LATE_PHASES,
                    margin: float = EXIT_MARGIN_S) -> dict:
    """Each late phase's deadline (``time.time()``): the smoke's end less
    the exit margin, less what every phase after it reserves."""
    deadlines, later = {}, 0.0
    for name, reserve in reversed(reserves):
        deadlines[name] = started + limit - margin - later
        later += reserve
    return deadlines
_PHASES_LINE = re.compile(r"^PHASES (.*)$", re.M)
_LAUNCHES_LINE = re.compile(r"^LAUNCHES (\{.*\})$", re.M)
_ATTEMPT_FILE = re.compile(r"job=(\d+)_worker=\d+_round=(\d+)\.log\.stdout$")


def physical_attempts(run_dir: Path) -> dict:
    """{job: [(round, stdout text), ...]} from the dispatcher's files."""
    attempts: dict = {}
    for path in sorted(run_dir.glob("*.stdout")):
        m = _ATTEMPT_FILE.match(path.name)
        if m:
            attempts.setdefault(int(m.group(1)), []).append(
                (int(m.group(2)), path.read_text()))
    return {job: sorted(runs) for job, runs in attempts.items()}


def physical_jobs(oracle: dict) -> list:
    """Phase 17's jobs, sized by the card driver from ``oracle``:
    ``PHYSICAL_JOB_EPOCHS`` epochs each."""
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.data.workload_info import steps_per_epoch
    from shockwave_tpu_torch.tools.physical_drivers import localize_jobs

    rate = oracle[PHYSICAL_WORKER_TYPE][(PHYSICAL_JOB_TYPE, 1)]["null"]
    train_s = (PHYSICAL_JOB_EPOCHS
               * steps_per_epoch("Transformer", PHYSICAL_BATCH)
               / (0.5 * rate))
    jobs = [Job(job_type=PHYSICAL_JOB_TYPE, command="", total_steps=1)
            for _ in range(PHYSICAL_JOBS)]
    return localize_jobs(jobs, oracle, train_s, PHYSICAL_WORKER_TYPE,
                         PHYSICAL_WIDTHS)


def physical_shockwave_config(round_s: float) -> dict:
    """The planner's configuration in phase 17."""
    return {"num_gpus": PHYSICAL_SLOTS, "time_per_iteration": round_s,
            "future_rounds": 3, "lambda": 5.0, "k": 10.0, "speculate": True}


def run_physical_plane(device, card: str, oracle_path: Path,
                       deadline: float) -> dict:
    """Phase 17 (docstring, item 17). ``oracle_path`` is phase 20's
    oracle; ``deadline`` (``time.time()``) bounds every wait of the
    phase."""
    import logging
    import threading

    from shockwave_tpu_torch.core.ids import JobId
    from shockwave_tpu_torch.core.physical import PhysicalScheduler
    from shockwave_tpu_torch.data import read_throughputs
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.ops import eg_pdhg as kernel
    from shockwave_tpu_torch.tools.physical_drivers import (
        run_physical_cluster,
    )

    tag = f"[{card}]"
    print(f"physical plane phase {tag}:", flush=True)
    shutil.rmtree(PHYSICAL_OUT, ignore_errors=True)
    PHYSICAL_OUT.mkdir(parents=True)
    torch.cuda.empty_cache()
    round_s = PHYSICAL_ROUND_S
    oracle = read_throughputs(str(oracle_path))
    rate = oracle[PHYSICAL_WORKER_TYPE][(PHYSICAL_JOB_TYPE, 1)]["null"]
    jobs = physical_jobs(oracle)
    steps = jobs[0].total_steps
    print(f"  rounds of {round_s:.0f} s, {PHYSICAL_JOBS} jobs of {steps} "
          f"steps ({PHYSICAL_JOB_TYPE} at {PHYSICAL_LAYERS} layers, "
          f"{rate:.3f} steps/s alone in phase 20's oracle, "
          f"{PHYSICAL_JOB_EPOCHS} epochs), {deadline - time.time():.0f} s "
          f"left of the smoke's {SMOKE_LIMIT_S:.0f} s before phase 18's "
          f"reserve {tag}", flush=True)
    profiles = synthesize_profiles(jobs, oracle, PHYSICAL_WORKER_TYPE)
    errors: list = []

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(f"{record.name}: {record.getMessage()}")

    handler = Errors(level=logging.ERROR)
    logging.getLogger().addHandler(handler)
    previous_hook = threading.excepthook

    def hook(args):
        errors.append(f"thread {args.thread.name}: {args.exc_value!r}")
        previous_hook(args)

    threading.excepthook = hook
    kernel.reset_launch_counts()
    # Each attempt's start-up: dispatch to its first lease request; each
    # job's preemptions (it lost its slot at a round boundary).
    startups = []
    preempted_jobs: dict = {}
    held: dict = {}

    class TimedScheduler(PhysicalScheduler):
        def _init_job_rpc(self, job_id):
            now = self.get_current_timestamp()
            startups.append(now - self._dispatch_times.get(
                JobId(int(job_id)), now))
            return super()._init_job_rpc(job_id)

        def _round_observability(self, assignments, preempted=None):
            for key in preempted or ():
                preempted_jobs[str(key)] = preempted_jobs.get(str(key), 0) + 1
            return super()._round_observability(assignments,
                                                preempted=preempted)

    started = time.time()
    try:
        summary = run_physical_cluster(
            jobs, [0.0] * len(jobs), oracle, profiles, "shockwave_tpu_pdhg",
            str(PHYSICAL_OUT), PHYSICAL_WORKER_TYPE, dict(os.environ),
            PHYSICAL_SLOTS, round_s, 1.0, None, PHYSICAL_BUFFER_S,
            shockwave_config=physical_shockwave_config(round_s),
            device=str(device), worker_device="cuda",
            scheduler_cls=TimedScheduler,
            deadline=min(deadline, started + PHYSICAL_TIMEOUT_S),
            worker_log=str(PHYSICAL_OUT / "worker.log"),
            extra_summary=lambda sched, run_dir: held.update(sched=sched)
            or {})
    finally:
        threading.excepthook = previous_hook
        logging.getLogger().removeHandler(handler)
    loop_s = time.time() - started
    sched = held["sched"]

    bad = list(errors)
    if summary["timed_out"]:
        bad.append(f"the round loop ran on past {loop_s:.0f} s (the "
                   f"phase's limit {PHYSICAL_TIMEOUT_S} s, or the smoke's "
                   f"{SMOKE_LIMIT_S:.0f} s less the phases after it)")
    worker_rc = summary["worker_exit_code"]
    worker_text = (PHYSICAL_OUT / "worker.log").read_text()
    if worker_rc != 0 or "Traceback" in worker_text:
        bad.append(f"worker agent exit {worker_rc}: {worker_text[-2000:]}")
    job_ids = sorted(sched._job_completion_times)
    if len(sched._completed_jobs) != PHYSICAL_JOBS:
        bad.append(f"{len(sched._completed_jobs)} of {PHYSICAL_JOBS} jobs "
                   "completed")
    for job_id in job_ids:
        if sched._total_steps_run[job_id] < steps:
            bad.append(f"job {job_id} ran {sched._total_steps_run[job_id]} "
                       f"of {steps} steps")
    attempts = physical_attempts(PHYSICAL_OUT / "run")
    spans = {}
    for entry in sched._round_log:
        if entry.get("event") == "round":
            for key in entry["jobs"]:
                spans[key] = spans.get(key, 0) + 1
    for job_id in job_ids:
        if spans.get(str(job_id), 0) < 2:
            bad.append(f"job {job_id} held workers in "
                       f"{spans.get(str(job_id), 0)} round(s), not two")
    if sched.get_num_preemptions() < 1:
        bad.append("the scheduler preempted no job")
    for job, runs in sorted(attempts.items()):
        if len(runs) < 2:
            bad.append(f"job {job} ran in one attempt: it was never "
                       "stopped before its end and resumed")
    phases, flash = [], {}
    for job, runs in sorted(attempts.items()):
        for i, (round_id, text) in enumerate(runs):
            if not re.search(r"^\[Transformer\] steps=\d+ .* device=cuda$",
                             text, re.M):
                bad.append(f"job {job} round {round_id}: no summary line "
                           f"on cuda: {text[-500:]!r}")
            if i > 0 and "RESUMED from" not in text:
                bad.append(f"job {job} round {round_id} did not resume "
                           "from its checkpoint")
            m = _PHASES_LINE.search(text)
            if m:
                phases.append({k: float(v.rstrip("s")) for k, v in (
                    item.split("=") for item in m.group(1).split())})
            m = _LAUNCHES_LINE.search(text)
            if m:
                for name, n in json.loads(m.group(1)).items():
                    flash[name] = flash.get(name, 0) + n
    if len(attempts) != PHYSICAL_JOBS:
        bad.append(f"attempts of {len(attempts)} jobs in the run directory")
    a_launches = kernel.LAUNCHES["eg_pdhg"]
    if a_launches < 1:
        bad.append("kernel A launched no time in the scheduler's process")
    spec_stream = getattr(sched._shockwave, "_spec_stream", None)
    default = torch.cuda.default_stream(device).cuda_stream
    side = 0
    if spec_stream is not None and spec_stream.cuda_stream != default:
        side = kernel.LAUNCHES_BY_STREAM.get(spec_stream.cuda_stream, 0)
    if side < 1:
        bad.append("no speculative solve launched on the planner's own "
                   f"stream (streams {kernel.LAUNCHES_BY_STREAM}, default "
                   f"{default})")
    solves = [r["seconds"] for r in sched._shockwave.solve_records]
    mean_phases = {k: sum(p.get(k, 0.0) for p in phases) / len(phases)
                   for k in ("build", "restore", "first_step_compile",
                             "train", "save")} if phases else {}
    relaunch_s = sum(v for k, v in mean_phases.items() if k != "train")
    reading = {
        "round_s": round_s, "steps": steps, "oracle_rate": rate,
        "worker_type": PHYSICAL_WORKER_TYPE, "job_type": PHYSICAL_JOB_TYPE,
        "loop_s": loop_s, "rounds": sched._num_completed_rounds,
        "attempts": {j: [r for r, _ in runs] for j, runs in attempts.items()},
        "rounds_held": spans, "startup_s": startups,
        "preemptions": sched.get_num_preemptions(),
        "preempted_by_job": preempted_jobs,
        "lease_extensions": sched._num_lease_extensions,
        "makespan_s": sched.get_current_timestamp(),
        "avg_jct_s": sched.get_average_jct(),
        "solves": len(solves), "solve_s_mean":
        sum(solves) / len(solves) if solves else None,
        "solve_s_max": max(solves, default=None),
        "spec_stats": dict(sched._shockwave.spec_stats),
        "eg_pdhg_launches": a_launches, "side_stream_launches": side,
        "flash_launches": flash, "relaunch_phases_mean": mean_phases,
        "relaunch_s_mean": relaunch_s,
    }
    print(f"  {len(sched._completed_jobs)} jobs complete in "
          f"{sched._num_completed_rounds} rounds ({loop_s:.1f} s of round "
          f"loop; makespan {reading['makespan_s']:.1f} s, average JCT "
          f"{reading['avg_jct_s'] or 0:.1f} s); attempts "
          f"{reading['attempts']}, "
          f"{reading['preemptions']} preemptions (by job {preempted_jobs}; an "
          f"attempt that was not preempted ended with its lease), "
          f"{reading['lease_extensions']} lease extensions {tag}", flush=True)
    print(f"  planner: {len(solves)} solves, mean "
          f"{reading['solve_s_mean'] or 0:.4f} s, max "
          f"{reading['solve_s_max'] or 0:.4f} s; speculation "
          f"{reading['spec_stats']} (a finding, no claim) {tag}", flush=True)
    print(f"  payload relaunch, mean over {len(phases)} attempts: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in mean_phases.items())
          + f"; relaunch overhead {relaunch_s:.2f} s; dispatch to first "
          f"lease {', '.join(f'{x:.1f}' for x in startups)} s {tag}",
          flush=True)
    print(f"  launches: kernel A {a_launches} ({side} on the speculation "
          f"stream), flash {flash} {tag}", flush=True)
    if bad:
        fail("physical plane phase: " + "; ".join(bad))
    return reading


# Phase 18: the survivable control plane's failover drill
# (``shockwave_tpu_torch/tools/ha_smoke.py``'s hot-standby and cold-restart
# arms): both scheduler nodes are ``python -m shockwave_tpu_torch.ha.standby
# --device cuda --policy shockwave_tpu_pdhg`` subprocesses, the two agents
# ``runtime.worker --ha_dir --device cuda``, the payload the synthetic one.
FAILOVER_DIR = ROOT / "_smoke_out" / "failover"
FAILOVER_POLICY = "shockwave_tpu_pdhg"


def run_failover(device, card: str, deadline: float) -> dict:
    """Phase 18: each arm's leader is SIGKILLed by the seeded
    ``scheduler_crash`` after its first round; its successor must take
    the lease at epoch 2 on its own port with the crash's ``sched_fault``
    marker in its restored tail, lose no worker, complete all 6 jobs exactly once with their
    steps, dedup the first token resent across the failover (6 jobs
    admitted), and launch kernel A on the card after its restore; no
    node or agent may raise. ``deadline`` (``time.time()``) bounds every
    wait of both arms. Returns the readings."""
    from shockwave_tpu_torch.tools import ha_smoke

    tag = f"[{card}]"
    print(f"failover phase {tag}:", flush=True)
    shutil.rmtree(FAILOVER_DIR, ignore_errors=True)
    FAILOVER_DIR.mkdir(parents=True)
    arms, bad = {}, []
    for arm, hot in (("hot", True), ("cold", False)):
        started = time.time()
        try:
            report = ha_smoke.failover_arm(
                str(FAILOVER_DIR), arm, hot, device="cuda",
                policy=FAILOVER_POLICY, deadline=deadline)
        except (RuntimeError, TimeoutError, subprocess.TimeoutExpired) as e:
            fail(f"failover phase, {arm} arm: {e} (logs under "
                 f"{FAILOVER_DIR / arm})")
        report["arm_s"] = time.time() - started
        bad += ha_smoke.check_arm(report)
        succ = report["successor"]
        if succ.get("device") != "cuda:0":
            bad.append(f"{arm}: the successor planned on {succ.get('device')}")
        if succ.get("kernel_a_launches", 0) < 1:
            bad.append(f"{arm}: the successor launched kernel A "
                       f"{succ.get('kernel_a_launches')} times after its "
                       "restore")
        # A traceback in any node's or agent's log is a thread that raised.
        for log in sorted((FAILOVER_DIR / arm).glob("*.log")):
            text = log.read_text(errors="replace")
            if "Traceback (most recent call last)" in text:
                bad.append(f"{arm}: {log.name} holds a traceback")
        journal = succ["journal"]
        print(f"  {arm} arm: the leader SIGKILLed by the seeded crash, the "
              f"successor took epoch {succ['epoch']} in "
              f"{report['takeover_s']:.2f} s; restored at round "
              f"{succ['restored_round']} from a checkpoint and the tail "
              f"{succ['restored_tail']}, lost workers "
              f"{succ['lost_workers']}; jobs {succ['completed_jobs']} with "
              f"steps {succ['total_steps_run']}; the resent token "
              f"{report['retransmit_status']} (deduped "
              f"{succ['admission']['deduped_batches']}, admitted "
              f"{succ['admission']['admitted_jobs']}); journal last_lsn "
              f"{journal['last_lsn']} checkpoint seq {journal['seq']}; "
              f"kernel A {succ['kernel_a_launches']} launches after the "
              f"restore; makespan {succ['makespan_s']:.2f} s; arm "
              f"{report['arm_s']:.1f} s {tag}", flush=True)
        arms[arm] = {
            "takeover_s": report["takeover_s"],
            "arm_s": report["arm_s"],
            "lease_epoch": report["lease_epoch"],
            "leader_returncode": report["leader_returncode"],
            "makespan_s": succ["makespan_s"],
            "rounds": succ["round_id"],
            "restored_tail": succ["restored_tail"],
            "restored_round": succ["restored_round"],
            "journal": journal,
            "admission": {k: succ["admission"][k] for k in (
                "deduped_batches", "admitted_jobs", "accepted_jobs")},
            "kernel_a_launches": succ["kernel_a_launches"],
            "kernel_a_launches_by_stream": succ[
                "kernel_a_launches_by_stream"],
        }
    if bad:
        fail("failover phase: " + "; ".join(bad))
    return {"arms": arms, "policy": FAILOVER_POLICY,
            "launches": sum(a["kernel_a_launches"] for a in arms.values())}


def main() -> None:
    started = PROGRESS["started"] = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == [HOST_PHASES_FLAG]:
        from shockwave_tpu_torch.utils.device import resolve_device

        run_host_phases(sys.argv[2], resolve_device("cuda"), card_line())
        return
    try:
        from shockwave_tpu_torch.models import train
        from shockwave_tpu_torch.ops import _build
        from shockwave_tpu_torch.ops import flash_attention as fa
        from shockwave_tpu_torch.tools import bench_flash as bench
        from shockwave_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")

    device = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t0 = enter("2 (building the kernels)")
    libraries = _build.build_all(["flash_attention", *SOURCES])
    print(f"built kernels in {time.time() - t0:.1f} s (one nvcc each, "
          f"together: {', '.join(p.name for p in libraries.values())})",
          flush=True)
    usage = inspect_library(_build, libraries["flash_attention"])
    from shockwave_tpu_torch.tools.bench_sim import ptxas_usage

    for name in SOURCES:
        u = ptxas_usage(libraries[name])
        usage[(name, None)] = u
        for kernel, k in u.items():
            print(f"  {name} {kernel}: {k['REG']} registers, {k['STACK']} "
                  f"bytes of stack, {k['SPILL']} bytes of spill stores, "
                  f"{k['SMEM']} bytes of static shared memory (ptxas -v)")

    enter("3 (the kernels against their plain versions)")
    print("kernels against their plain versions:")
    B, S, H, D = bench.TRAIN_SHAPE
    # Seed 1 as well: on its inputs a few elements need the flip term.
    errors = check_kernels(fa, bench, "train-shape bf16", 1, B, S, H, H, D,
                           torch.bfloat16, None, device)[0]
    seed0, inputs, plain = check_kernels(
        fa, bench, "train-shape bf16", 0, B, S, H, H, D, torch.bfloat16,
        None, device)
    errors = {name: max(err, seed0[name]) for name, err in errors.items()}
    check_kernels(fa, bench, "gqa-window bf16 D=64", 0, 2, 512, 4, 2, 64,
                  torch.bfloat16, 200, device)
    check_kernels(fa, bench, "gqa-window bf16 D=128", 0, 1, 1024, 4, 1, 128,
                  torch.bfloat16, 333, device)
    check_kernels(fa, bench, "gqa-window f32", 0, 2, 512, 4, 2, 64,
                  torch.float32, 200, device)
    print("planted faults against the bf16 tolerance (all must fail it):")
    check_planted_faults(fa, bench, inputs, plain, H)
    del inputs, plain

    enter("4 (timing the kernels)")
    ms, sdpa_fwd, sdpa_bwd = bench.time_kernels(fa, B, S, H, D,
                                                torch.bfloat16, device)
    enter("5 (a small model)")
    check_small_model(device)
    enter("6 (the main path)")

    os.environ["SHOCKWAVE_PHASE_TIMINGS"] = "1"
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        first, launches = run_main_path(fa, train, 5, resume=False)
        if abs(first["losses"][0] - math.log(8192)) > 0.5:
            fail(f"first loss {first['losses'][0]} is not near ln 8192")
        resumed, resume_launches = run_main_path(fa, train, 2, resume=True)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady_s = first["phases"]["train"] / (first["steps"] - 1)
    print(f"110M tier: losses {first['losses']} then resumed "
          f"{resumed['losses']}")
    print(f"110M tier: {first['steps'] / first['elapsed_s']:.3f} steps/s "
          f"over all {first['steps']} steps, {1 / steady_s:.3f} steps/s "
          f"after the first ({B * S / steady_s:.0f} tokens/s); "
          f"peak memory {peak_gib:.2f} GiB; launches {launches}, "
          f"resume {resume_launches} [{card}]")

    ring_started = enter("7 (ring attention)")
    ring = run_ring(fa, bench, train, device, card, first["losses"])
    ring["phase_s"] = time.time() - ring_started
    print(f"ring phase: {ring['phase_s']:.1f} s [{card}]", flush=True)
    print(f"110M tier step [{card}]: ring ({RING_SHARDS} shards) "
          f"{ring['steps_per_s']:.3f} steps/s, peak {ring['peak_gib']:.2f} "
          f"GiB; flash {1 / steady_s:.3f} steps/s, peak {peak_gib:.2f} GiB",
          flush=True)

    oracle_started = enter("20 (the card's oracle)")
    oracle = run_oracle(fa, device, card, 1 / steady_s)
    oracle["phase_s"] = time.time() - oracle_started
    print(f"oracle phase: {oracle['phase_s']:.1f} s, the smoke's growth "
          f"[{card}]", flush=True)
    deadlines = phase_deadlines(started)
    host = start_host_phases()
    physical_started = enter("17 (the physical control plane)")
    physical = run_physical_plane(device, card, Path(oracle["path"]),
                                  deadlines["physical"])
    physical["phase_s"] = time.time() - physical_started
    print(f"physical plane phase: {physical['phase_s']:.1f} s, the smoke's "
          f"growth [{card}]", flush=True)
    simulation_started = enter("8 (simulation)")
    simulation = run_simulation(device)
    sharded_started = time.time()
    simulation["sharded"] = run_sharded(
        device, card, simulation["golden"]["shockwave_tpu_level"])
    simulation["sharded"]["phase_s"] = time.time() - sharded_started
    for run in simulation["golden"].values():
        run.pop("plans", None)
    simulation["phase_s"] = time.time() - simulation_started
    print(f"  (e) {simulation['sharded']['phase_s']:.1f} s, the smoke's "
          f"growth [{card}]", flush=True)
    first_order_started = enter("9 (kernels A and B)")
    first_order = run_first_order(device)
    first_order["phase_s"] = time.time() - first_order_started
    enter("11, 12's tier and 13 (their own processes)")
    host_readings, host_wait_s = finish_host_phases(host,
                                                    deadlines["failover"])
    gavel, library = host_readings["gavel"], host_readings["library"]
    cells_tier = host_readings["cells_tier"]
    tier = simulation["tier_2048"]
    print(f"  item 8's tier, cut to its first {tier['rounds']} rounds, "
          f"shockwave_tpu on 256 GPUs | {tier['makespan']:.3f} | "
          f"{tier['avg_jct']:.3f} | {tier['worst_ftf']:.3f} | "
          f"{tier['unfair_fraction']:.1f} (not paired with the whole max-min "
          f"run); phases 11 and 13 and phase 12's tier ran beside phase 17 "
          f"and were waited for {host_wait_s:.1f} s [{card}]", flush=True)
    cells_started = enter("12 (cells and what-if)")
    cells = run_cells(device, card, cells_tier)
    cells["phase_s"] = time.time() - cells_started
    print(f"cells and what-if phase: {cells['phase_s']:.1f} s, the smoke's "
          f"growth [{card}]", flush=True)
    cells["retimed_noncausal"] = retime_noncausal(fa, bench, ring, card)
    planner_started = enter("14 (the planner)")
    planner = run_planner(device, card, first_order.pop("windows"))
    planner["phase_s"] = time.time() - planner_started
    print(f"planner phase: {planner['phase_s']:.1f} s, the smoke's growth "
          f"[{card}]", flush=True)
    features_started = enter("15 (simulator features)")
    features = run_sim_features(device, card)
    features["phase_s"] = time.time() - features_started
    print(f"simulator features phase: {features['phase_s']:.1f} s, the "
          f"smoke's growth [{card}]", flush=True)
    telemetry_started = enter("16 (Ulysses and telemetry)")
    ulysses = run_ulysses(fa, train, device, card, first["losses"],
                          1 / steady_s, peak_gib)
    ulysses_s = time.time() - telemetry_started
    telemetry = run_telemetry(device, card, TELEMETRY_LOGS)
    telemetry["ulysses"] = ulysses
    telemetry["seconds"] = {"ulysses": ulysses_s,
                            "telemetry": time.time() - telemetry_started
                            - ulysses_s}
    telemetry["phase_s"] = time.time() - telemetry_started
    print(f"ulysses and telemetry phase: {telemetry['phase_s']:.1f} s "
          f"(ulysses {ulysses_s:.1f} s; fixture runs "
          f"{telemetry['fixture_run']['planes_on_s']:.1f} + "
          f"{telemetry['fixture_run']['planes_off_s']:.1f} s; replays "
          f"{sum(r['seconds'] for r in telemetry['replay'].values()):.1f} "
          f"s) [{card}]", flush=True)
    families_started = enter("19 (families)")
    families = run_families(fa, train, device, card)
    families["phase_s"] = time.time() - families_started
    print(f"families phase: {families['phase_s']:.1f} s, the smoke's growth "
          f"[{card}]", flush=True)
    chaos_started = enter("21 (chaos)")
    chaos = run_chaos(device, card)
    chaos["phase_s"] = time.time() - chaos_started
    print(f"chaos phase: {chaos['phase_s']:.1f} s, the smoke's growth "
          f"[{card}]", flush=True)
    soaks_started = enter("22 (soaks)")
    soaks = run_soaks(device, card)
    soaks["phase_s"] = time.time() - soaks_started
    print(f"soaks phase: {soaks['phase_s']:.1f} s, the smoke's growth "
          f"[{card}]", flush=True)
    gangs_started = enter("23 (gangs)")
    gangs = run_gangs(train, device, card)
    gangs["phase_s"] = time.time() - gangs_started
    print(f"gang phase: {gangs['phase_s']:.1f} s, the smoke's growth "
          f"[{card}]", flush=True)
    failover_started = enter("18 (failover)")
    failover = run_failover(device, card, deadlines["failover"])
    failover["phase_s"] = time.time() - failover_started
    print(f"failover phase: {failover['phase_s']:.1f} s, the smoke's growth "
          f"(phase 9's pdhg tier cut to "
          f"{first_order['tier_2048_pdhg']['rounds']} rounds took "
          f"{first_order['tier_2048_pdhg']['wall_s']:.1f} s) [{card}]",
          flush=True)

    backward_ms = ms["flash_dkv"][0] + ms["flash_dq"][0]
    kernels = []
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        bound_ms, bound_by = bound(name, B * H, B * H, S, D, torch.bfloat16,
                                   None)
        res = usage.get((name + "_bf16", D, True), {})
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            # The training shape's and the ring's causal hop shape's.
            "max_abs_err": max(errors[name],
                               ring["causal_max_abs_err"][name]),
            "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sdpa_fwd if name == "flash_fwd" else None,
            # The 5-step 110M run under Ulysses attention (phase 16):
            # each layer launches the kernel once a shard.
            "ulysses_launches": ulysses["launches"][name],
            # Phase 17's payloads, summed over their attempts.
            "physical_launches": physical["flash_launches"].get(name, 0),
            # Phase 19's 5-step MoE tier (one launch a layer a step).
            "moe_launches": families["moe"]["launches"].get(name, 0),
            # Phase 20's measurement of phase 17's payload.
            "oracle_launches": oracle["launches"].get(name, 0),
            # Phase 23's sequence-parallel gangs, both ranks, ring and
            # Ulysses.
            "gang_seq_launches": gangs["launches"].get(name, 0),
            # Phase 23's model-parallel gangs, both ranks, dense and MoE.
            "gang_model_launches": gangs["model_launches"].get(name, 0),
            "share_of_bound": bound_ms / ms[name][0],
            "registers": res.get("REG"), "local_bytes": res.get("LOCAL"),
        }
        if name != "flash_fwd":
            # SDPA's backward computes dq, dk and dv in one call.
            row["sdpa_backward_ms"] = sdpa_bwd
            row["backward_ms"] = backward_ms
        print(f"{name}: {ms[name][0]:.4f} ms (bound {bound_ms:.4f} ms by "
              f"{bound_by}, {100 * bound_ms / ms[name][0]:.1f}% of it; "
              f"plain {ms[name][1]:.3f} ms; SDPA "
              f"{'forward' if name == 'flash_fwd' else 'backward'} "
              f"{sdpa_fwd if name == 'flash_fwd' else sdpa_bwd:.4f} ms)")
        kernels.append(row)
    print(f"backward (flash_dkv + flash_dq): {backward_ms:.4f} ms; SDPA "
          f"backward {sdpa_bwd:.4f} ms ({backward_ms / sdpa_bwd:.2f}x) "
          f"[{card}]")
    hB, hS, hH, hD = bench.HOP_SHAPE
    nc_backward_ms = ring["ms"]["flash_dkv"][0] + ring["ms"]["flash_dq"][0]
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        t, t_plain = ring["ms"][name]
        bound_ms, bound_by = bound(name, hB * hH, hB * hH, hS, hD,
                                   torch.bfloat16, None, causal=False)
        res = usage.get((name + "_bf16", hD, False), {})
        row = {
            "name": name + "_nc", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": ring["launches"][name + "_nc"],
            "max_abs_err": ring["max_abs_err"][name], "ms": t,
            "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": ring["sdpa_fwd_ms"] if name == "flash_fwd"
            else None,
            "share_of_bound": bound_ms / t, "shape": list(bench.HOP_SHAPE),
            # Phase 23's ring gang: the second rank's live hop.
            "gang_seq_launches": gangs["launches"].get(name + "_nc", 0),
            "gang_model_launches": gangs["model_launches"].get(
                name + "_nc", 0),
            "registers": res.get("REG"), "local_bytes": res.get("LOCAL"),
        }
        if name != "flash_fwd":
            row["sdpa_backward_ms"] = ring["sdpa_bwd_ms"]
            row["backward_ms"] = nc_backward_ms
        print(f"{name} non-causal at the hop shape: {t:.4f} ms (bound "
              f"{bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / t:.1f}% of "
              f"it; plain {t_plain:.3f} ms; SDPA is_causal=False "
              f"{'forward' if name == 'flash_fwd' else 'backward'} "
              f"{ring['sdpa_fwd_ms'] if name == 'flash_fwd' else ring['sdpa_bwd_ms']:.4f}"
              f" ms) [{card}]")
        kernels.append(row)
    print(f"non-causal backward (flash_dkv + flash_dq) at the hop shape: "
          f"{nc_backward_ms:.4f} ms; SDPA backward {ring['sdpa_bwd_ms']:.4f} "
          f"ms [{card}]")
    for name, solver in (("eg_pdhg", "pdhg"), ("eg_relaxed", "relaxed")):
        rows = [r for r in first_order["timings"] if r["kernel"] == solver]
        # The row of the largest band the main path's instantiation (state
        # resident) takes and the plain version was timed at.
        row = [r for r in rows
               if r["resident"] and r["plain_ms"] is not None][-1]
        kernel = (f"{solver}_kernel<{row['levels']}, "
                  f"{'true' if row['resident'] else 'false'}>")
        res = usage[(name, None)].get(kernel, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": first_order["launches"][name],
            "max_abs_err": first_order["max_abs_err"][solver],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "jobs": row["jobs"],
            # Phase 21's chaos campaign: the ladder's degraded rounds and
            # their replays.
            "chaos_launches": chaos["launches"][name],
            # Phase 22's soaks: the streaming campaign's replans and
            # replays and the ingest pricing lanes (kernel A only).
            "soak_launches": soaks["launches"] if name == "eg_pdhg" else 0,
            "ms_before": row["ms_before"],
            "barriers": row["barriers"],
            "barriers_before": row["barriers_before"],
            "floor_ms": row["floor_ms"],
            "floor_ms_before": row["floor_ms_before"],
            "us_per_barrier": row["us_per_barrier"],
            "state_hbm_ms": row["state_hbm_ms"],
            "state_l2_ms": row["state_l2_ms"],
            "instantiation": kernel,
            "registers": res.get("REG"), "spill_bytes": res.get("SPILL"),
            "stack_bytes": res.get("STACK"),
            "bands": [{k: r[k] for k in (
                "jobs", "slots", "levels", "resident", "ms", "ms_before",
                "barriers", "barriers_before", "floor_ms", "floor_ms_before",
                "identical", "bound_ms", "plain_ms")} for r in rows],
        })
        if name == "eg_pdhg":
            # Phase 14's launches of kernel A: checkpointed pdhg runs,
            # repair solves, the speculative cells run, pdhg pools, duals.
            kernels[-1]["planner_launches"] = planner["launches"]
            # Phase 15's: the churned pdhg run and the pricing lanes.
            kernels[-1]["sim_features_launches"] = features["launches"]
            # Phase 17's, in the scheduler's process, and those of them
            # on the speculation stream.
            kernels[-1]["physical_launches"] = physical["eg_pdhg_launches"]
            kernels[-1]["physical_side_stream_launches"] = physical[
                "side_stream_launches"]
            # Phase 18's, in the successor nodes' processes after their
            # restores (the SIGKILLed leaders' are not counted).
            kernels[-1]["failover_launches"] = failover["launches"]
            # The lane grid (phase 12): launches on the cells tier and the
            # what-if CLI's, and the grid's time against its lanes one by
            # one at 8, 65 and 1024 lanes.
            grids = [cells["quality_ab"]["grid"]] + [
                cells["whatif"][g]["grid"] for g in ("b", "a")]
            kernels[-1]["lane_grid"] = {
                "cells_tier_launches": cells["tier"]["launches"],
                "lanes_per_launch": cells["tier"]["lanes_per_launch"],
                "whatif_launches": {g: cells["whatif"][g]["launches"]
                                    for g in ("a", "b")},
                # The lane meshes: the quality A/B's lanes over card 0 in
                # 2 and 4 places, what-if grid (a)'s over 4.
                "mesh_launches": {
                    "quality_ab": cells["quality_ab"]["mesh_launches"],
                    "whatif_a": cells["whatif"][WHATIF_MESH_GRID][
                        "mesh_launches"]},
                "grids": [{k: grid[k] for k in (
                    "lanes", "slots", "ms", "one_by_one_ms", "bound_ms",
                    "bound_by", "max_cycles")} for grid in grids],
            }
        print(f"{name}: {row['ms']:.4f} ms at {row['jobs']} jobs ({kernel}; "
              f"sequential {row['ms_before']:.4f} ms; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}; "
              f"{row['barriers']} block barriers against "
              f"{row['barriers_before']}, floor {row['floor_ms']:.4f} ms; "
              f"plain {row['plain_ms']:.1f} ms; no PyTorch call computes "
              f"it) [{card}]")
    print(f"chip_smoke: all phases in {time.time() - started:.1f} s")
    # Each phase's seconds and the parts the smoke's budget turns on
    # (phase 16's growth against the cut depth of phases 8(d) and 9(d)),
    # on one line near the end of the output.
    seconds_line = json.dumps({"seconds": {
        "total": time.time() - started, "ring": ring["phase_s"],
        "simulation": simulation["phase_s"],
        "simulation_8c": simulation.get("check_s"),
        "simulation_8d": simulation.get("timing_s"),
        "simulation_8e": simulation["sharded"]["phase_s"],
        "first_order": first_order["phase_s"],
        "first_order_9d": first_order["timing_s"],
        "gavel": gavel["phase_s"], "cells": cells["phase_s"],
        "library": library["phase_s"], "cells_tier": cells_tier["phase_s"],
        "host_phases_wait": host_wait_s,
        "planner": planner["phase_s"],
        "sim_features": features["phase_s"],
        "telemetry": telemetry["phase_s"],
        "physical": physical["phase_s"],
        "failover": failover["phase_s"], "families": families["phase_s"],
        "oracle": oracle["phase_s"], "chaos": chaos["phase_s"],
        "soaks": soaks["phase_s"], "gangs": gangs["phase_s"],
        "first_order_tier": first_order["tier_2048_pdhg"]["wall_s"], **{
            f"telemetry_{k}": v for k, v in telemetry["seconds"].items()}},
        "card": card})
    for run in (simulation["tier_2048"], *simulation["golden"].values()):
        run.pop("records", None)
    print(json.dumps({"simulation": simulation, "card": card}))
    print(json.dumps({"first_order": first_order, "card": card}))
    print(json.dumps({"gavel": gavel, "card": card}))
    print(json.dumps({"cells": cells, "card": card}, default=str))
    print(json.dumps({"library": library, "card": card}))
    print(json.dumps({"planner": planner, "card": card}, default=str))
    print(json.dumps({"sim_features": features, "card": card}, default=str))
    print(json.dumps({"telemetry": telemetry, "card": card}, default=str))
    print(json.dumps({"physical": physical, "card": card}, default=str))
    print(json.dumps({"failover": failover, "card": card}, default=str))
    print(json.dumps({"families": families, "card": card}))
    print(json.dumps({"oracle": oracle, "card": card}))
    print(json.dumps({"chaos": chaos, "card": card}, default=str))
    print(json.dumps({"soaks": soaks, "card": card}, default=str))
    print(json.dumps({"gangs": gangs, "card": card}, default=str))
    print(json.dumps({"ring": {k: v for k, v in ring.items() if k != "ms"},
                      "card": card}))
    print(seconds_line)
    print(json.dumps({"kernels": kernels, "card": card,
                      "train_steps_per_s": 1 / steady_s,
                      "train_tokens_per_s": B * S / steady_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        print(f"chip_smoke: FAILED {where()}", file=sys.stderr, flush=True)
        raise
