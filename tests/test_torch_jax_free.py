"""The port runs with JAX and the JAX package unimportable, and its
sources import neither; its control plane runs with ``grpc`` and
``google.protobuf`` unimportable too, and no source imports them.

The module names are matched exactly: ``shockwave_tpu_torch`` starts with
the string ``shockwave_tpu`` but is not the JAX package.
"""

import ast
import json
import os
import select
import shlex
import subprocess
import sys
import uuid
from pathlib import Path

import pytest

from shockwave_tpu_torch.tools import bench_sim

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu",
             "grpc")

_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
from shockwave_tpu_torch.models import train
args = ["--model", "Transformer", "--batch_size", "2", "--vocab_size", "64",
        "--d_model", "32", "--num_heads", "2", "--num_layers", "1",
        "--seq_len", "128", "--attention", "flash", "--device", "cpu",
        "--checkpoint_dir", sys.argv[1]]
train.main(args + ["-n", "2"])
train.main(args + ["-n", "1"])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


_SIM_SCRIPT = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
policy = sys.argv[1] if len(sys.argv) > 1 else "shockwave_tpu_level"
sys.argv = ["simulate", "-t", "traces/small_12_dynamic.trace", "-p",
            policy, "-c", "v100=8", "--time_per_iteration",
            "120", "--device", "cpu", "--no_profile_cache"]
runpy.run_module("shockwave_tpu_torch.simulate", run_name="__main__")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_simulate_cli_runs_with_jax_blocked():
    """``python -m shockwave_tpu_torch.simulate`` on the golden trace with
    JAX and the JAX package unimportable prints the golden makespan
    (tests/test_golden.py) and leaves no module of either loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _SIM_SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Makespan: 13456.422 s" in proc.stdout
    assert "Average JCT: 5658.689 s" in proc.stdout
    assert "Worst FTF: 2.029" in proc.stdout
    assert "LEAKED []" in proc.stdout


@pytest.mark.parametrize("policy", ["shockwave_tpu_pdhg",
                                    "shockwave_tpu_relaxed"])
def test_first_order_simulate_cli_runs_with_jax_blocked(policy):
    """The PDHG and relaxed backends (their kernels' plain versions on the
    CPU) through ``python -m shockwave_tpu_torch.simulate`` with JAX and
    the JAX package unimportable: the JAX package's golden metrics, and no
    module of either loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _SIM_SCRIPT, policy], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    golden = bench_sim.GOLDEN_FIRST_ORDER[policy]
    assert f"Makespan: {golden['makespan']:.3f} s" in proc.stdout
    assert f"Average JCT: {golden['avg_jct']:.3f} s" in proc.stdout
    assert f"Worst FTF: {golden['worst_ftf']:.3f}" in proc.stdout
    assert "LEAKED []" in proc.stdout


_MODULE_SCRIPT = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
module, sys.argv = sys.argv[1], [sys.argv[1], *sys.argv[2:]]
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:  # a CLI that exits with its status
    if e.code:
        raise
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""

# Gavel's round path through the simulate CLI: the golden baseline on
# the 12-job trace, and a perf policy on the 220-job trace on the
# heterogeneous cluster (v100:p100:k80 counts, 4 GPUs a server).
GAVEL_CLI = {
    "max_min_fairness": (
        ["-t", "traces/small_12_dynamic.trace", "-p", "max_min_fairness",
         "-c", "v100=8"], bench_sim.GOLDEN_GAVEL["max_min_fairness"]),
    "fifo_perf": (
        ["-t", "traces/generated_220_dynamic.trace", "-p", "fifo_perf",
         "-c", "16:16:16", "--num_gpus_per_server", "4:4:4"],
        bench_sim.HETERO["fifo_perf"]),
}


# _MODULE_SCRIPT with the native greedy reported unavailable, as on a
# host with no C++ compiler.
_NO_NATIVE_SCRIPT = _MODULE_SCRIPT.replace(
    "module, sys.argv =",
    "from shockwave_tpu_torch import native\n"
    "native.available = lambda: False\n"
    "module, sys.argv =")


def _run_blocked(module: str, *args: str, script: str = _MODULE_SCRIPT) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", script, module, *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LEAKED []" in proc.stdout
    return proc.stdout


@pytest.mark.parametrize("policy", sorted(GAVEL_CLI))
def test_gavel_simulate_cli_runs_with_jax_blocked(policy):
    """``python -m shockwave_tpu_torch.simulate`` under a Gavel policy with
    JAX and the JAX package unimportable prints the JAX package's metrics
    (the allocation LPs on the host) and leaves no module of either
    loaded."""
    args, expected = GAVEL_CLI[policy]
    out = _run_blocked("shockwave_tpu_torch.simulate", *args,
                       "--time_per_iteration", "120", "--device", "cpu",
                       "--no_profile_cache")
    assert f"Makespan: {expected['makespan']:.3f} s" in out
    assert f"Average JCT: {expected['avg_jct']:.3f} s" in out
    assert f"Worst FTF: {expected['worst_ftf']:.3f}" in out
    if "rounds" in expected:
        assert f"Rounds: {expected['rounds']}; allocations: " in out


@pytest.mark.parametrize("policy", ["shockwave", "gandiva",
                                    "max_min_fairness_packed"])
def test_library_simulate_cli_runs_with_jax_blocked(policy):
    """``python -m shockwave_tpu_torch.simulate`` on the golden trace under
    the exact MILP, Gandiva and packed max-min (the scheduler's pair
    machinery) with JAX and the JAX package unimportable prints the JAX
    package's metrics (``bench_sim.GOLDEN_LIBRARY``) and leaves no module
    of either loaded; under ``shockwave`` every MILP solve ends optimal
    within its gap. ``--seed 0`` seeds Gandiva's pairs (without it they
    are unseeded, in both packages' CLIs)."""
    out = _run_blocked("shockwave_tpu_torch.simulate", "-t",
                       "traces/small_12_dynamic.trace", "-p", policy, "-c",
                       "v100=8", "--time_per_iteration", "120", "--seed",
                       "0", "--device", "cpu", "--no_profile_cache")
    expected = bench_sim.GOLDEN_LIBRARY[policy]
    assert f"Makespan: {expected['makespan']:.3f} s" in out
    assert f"Average JCT: {expected['avg_jct']:.3f} s" in out
    assert f"Worst FTF: {expected['worst_ftf']:.3f}" in out
    if policy == "shockwave":
        assert (f"Rounds: {expected['rounds']}; solves by backend: "
                "{'reference': 16}") in out
        assert "MILP solves by HiGHS status (0 optimal within the gap, " \
            "1 time limit): {0: 32}" in out
    else:
        assert f"Rounds: {expected['rounds']}; allocations: " in out


def test_figure9_runner_runs_with_jax_blocked(tmp_path):
    """The Figure-9 runner (``tools/scale_experiments.py``) with JAX and
    the JAX package unimportable: a max-min cell of Figure 9 with the JAX
    package's metrics, and no module of either loaded."""
    out = _run_blocked("shockwave_tpu_torch.tools.scale_experiments",
                       "--device", "cpu", "--policies", "max_min_fairness",
                       "--num_gpus", "256", "--out", str(tmp_path))
    expected = bench_sim.FIGURE9[("max_min_fairness", 256)]
    assert f"makespan={expected['makespan']:.3f}s" in out
    assert f"avg_jct={expected['avg_jct']:.3f}s" in out
    assert (tmp_path / "summary.json").exists()


def test_cells_simulate_cli_runs_with_jax_blocked():
    """``simulate -p shockwave_tpu_pdhg --cells 2 --device cpu`` on the
    golden trace (the cells market, its lanes kernel A's plain version)
    with JAX and the JAX package unimportable: the JAX package's metrics
    (``bench_sim.GOLDEN_CELLS``) in its rounds, no module of either
    loaded."""
    out = _run_blocked("shockwave_tpu_torch.simulate", "-t",
                       "traces/small_12_dynamic.trace", "-p",
                       "shockwave_tpu_pdhg", "-c", "v100=8",
                       "--time_per_iteration", "120", "--cells", "2",
                       "--device", "cpu", "--no_profile_cache")
    golden = bench_sim.GOLDEN_CELLS
    assert f"Makespan: {golden['makespan']:.3f} s" in out
    assert f"Average JCT: {golden['avg_jct']:.3f} s" in out
    assert f"Worst FTF: {golden['worst_ftf']:.3f}" in out
    assert f"Rounds: {golden['rounds']}; solves by backend: {{'cells'" in out


def test_sharded_simulate_cli_runs_with_jax_blocked():
    """``simulate -p shockwave_tpu_sharded --device cpu`` on the golden
    trace (the level solve over a one-place solve mesh) with JAX and the
    JAX package unimportable: the level backend's golden metrics, every
    solve sharded, no module of either loaded."""
    out = _run_blocked("shockwave_tpu_torch.simulate",
                       *_golden_args("shockwave_tpu_sharded"))
    golden = bench_sim.GOLDEN["shockwave_tpu_level"]
    assert f"Makespan: {golden['makespan']:.3f} s" in out
    assert f"Average JCT: {golden['avg_jct']:.3f} s" in out
    assert f"Worst FTF: {golden['worst_ftf']:.3f}" in out
    assert "solves by backend: {'sharded':" in out


_MESH_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
from shockwave_tpu_torch.cells import batched
from shockwave_tpu_torch.parallel.mesh import make_solve_mesh
from shockwave_tpu_torch.solver import eg_level, eg_sharded
from shockwave_tpu_torch.tools import bench_sim
from shockwave_tpu_torch.whatif import Scenario, ScenarioBatch, solve_scenarios
problem = bench_sim.seeded_problem(40, num_gpus=8)
counts, _ = eg_sharded.solve_level_sharded(
    problem, mesh=make_solve_mesh(["cpu"] * 4), device="cpu")
assert np.array_equal(counts, eg_level.solve_level_counts(problem, "cpu")[0])
cells = [bench_sim.seeded_problem(12, num_gpus=4, seed=s) for s in range(4)]
meshed = batched.solve_cells_pdhg(
    cells, mesh=make_solve_mesh(["cpu"] * 2, "cells"), device="cpu")[0]
alone = batched.solve_cells_pdhg(cells, device="cpu")[0]
assert all(np.array_equal(a, b) for a, b in zip(meshed, alone))
batch = ScenarioBatch(problem, [Scenario(num_gpus=g) for g in (4, 6, 8, 10)])
meshed = solve_scenarios(
    batch, mesh=make_solve_mesh(["cpu"] * 4, "scenarios"), device="cpu")[0]
alone = solve_scenarios(batch, device="cpu")[0]
assert all(np.array_equal(a, b) for a, b in zip(meshed, alone))
print("MESHES OK")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_mesh_paths_run_with_jax_blocked():
    """The sharded level solve over a four-place mesh, the cells' lanes
    over two places and the what-if lanes over four, with JAX and the
    JAX package unimportable: counts equal to the one-device solve's,
    lanes to the meshless call's, no module of either loaded."""
    out = _run_blocked("", script=_MESH_SCRIPT)
    assert "MESHES OK" in out


def test_whatif_sweep_runs_with_jax_blocked(tmp_path):
    """``tools.whatif sweep`` on round 91 of the committed decision log
    (written by the JAX package, read by the port's recorder) with JAX
    and the JAX package unimportable: every lane audited equal to its
    one-lane solve, no module of either loaded."""
    report = tmp_path / "sweep.json"
    out = _run_blocked("shockwave_tpu_torch.tools.whatif", "sweep", "--log",
                       "results/flight_recorder/decisions.jsonl", "--round",
                       "91", "--capacity", "2,4", "--device", "cpu",
                       "--out", str(report))
    assert "12 jobs x 3 scenarios on cpu" in out
    assert "bit_identical=True" in out
    assert report.exists()


def _golden_args(policy: str, gpus: int = 8) -> list:
    return ["-t", "traces/small_12_dynamic.trace", "-p", policy, "-c",
            f"v100={gpus}", "--time_per_iteration", "120", "--device", "cpu",
            "--no_profile_cache"]


def _assert_metrics(out: str, expected: dict) -> None:
    assert f"Makespan: {expected['makespan']:.3f} s" in out
    assert f"Average JCT: {expected['avg_jct']:.3f} s" in out
    assert f"Worst FTF: {expected['worst_ftf']:.3f}" in out
    assert f"Rounds: {expected['rounds']}; solves by backend: " in out


def test_speculate_cli_runs_with_jax_blocked():
    """``simulate --speculate`` (the two-cell market under pdhg on the
    golden trace) with JAX and the JAX package unimportable: the JAX
    package's metrics and hit / repair / miss counts
    (``bench_sim.PLANNER``), no module of either loaded."""
    out = _run_blocked("shockwave_tpu_torch.simulate",
                       *_golden_args("shockwave_tpu_pdhg"), "--cells", "2",
                       "--speculate")
    expected = bench_sim.PLANNER["speculate_golden_cells"]
    _assert_metrics(out, expected)
    assert f"Speculation: {expected['spec_stats']}; exposed planning " in out


def test_checkpoint_cli_saves_then_resumes_with_jax_blocked(tmp_path):
    """``simulate --checkpoint_threshold 6 --checkpoint_file F`` saves and
    runs on; the same command with only ``--checkpoint_file F`` resumes
    from F; both print the golden metrics in its rounds, with JAX and the
    JAX package unimportable."""
    ckpt = tmp_path / "golden.ckpt"
    saving = _run_blocked("shockwave_tpu_torch.simulate",
                          *_golden_args("shockwave_tpu_level"),
                          "--checkpoint_threshold", "6",
                          "--checkpoint_file", str(ckpt))
    assert ckpt.exists()
    resumed = _run_blocked("shockwave_tpu_torch.simulate",
                           *_golden_args("shockwave_tpu_level"),
                           "--checkpoint_file", str(ckpt))
    expected = dict(bench_sim.GOLDEN["shockwave_tpu_level"], rounds=113)
    for out in (saving, resumed):
        _assert_metrics(out, expected)


def test_hetero_pools_cli_runs_with_jax_blocked(tmp_path):
    """``"hetero_pools": true`` in ``--config`` on the JAX package's A/B
    (the 120-job trace on v100:8 p100:4 k80:4) with JAX and the JAX
    package unimportable: the JAX package's run
    (``bench_sim.PLANNER["pools_120"]``)."""
    config = tmp_path / "pools.json"
    config.write_text('{"hetero_pools": true}')
    out = _run_blocked("shockwave_tpu_torch.simulate", "-t",
                       "traces/generated_120_dynamic.trace", "-p",
                       "shockwave_tpu", "-c", "v100=8,p100=4,k80=4",
                       "--time_per_iteration", "120", "--config",
                       str(config), "--device", "cpu", "--no_profile_cache")
    _assert_metrics(out, bench_sim.PLANNER["pools_120"])


def test_greedy_fallback_cli_runs_with_jax_blocked():
    """The level backend on the golden trace on 5 GPUs, where placement
    drops grants, with the native greedy unavailable, so the PyTorch
    greedy is the fallback, and JAX and the JAX package unimportable: the
    JAX package's run under the same patch."""
    out = _run_blocked("shockwave_tpu_torch.simulate",
                       *_golden_args("shockwave_tpu_level",
                                     bench_sim.GREEDY_FALLBACK_GPUS),
                       script=_NO_NATIVE_SCRIPT)
    _assert_metrics(out, bench_sim.PLANNER["greedy_fallback_golden"])


def test_fault_plan_and_round_log_cli_run_with_jax_blocked(tmp_path):
    """``simulate --fault-plan P --round_log L`` on the golden trace under
    the level backend, with a seeded churn plan (crashes, reclaims,
    re-adds, a solver timeout, two scheduler kills through the HA codec),
    with JAX and the JAX package unimportable: every event applied and
    recovered, the round log written, no module of either loaded."""
    from shockwave_tpu_torch.runtime import faults

    churn = faults.generate_churn_plan(
        3, horizon_s=13000.0, num_workers=8, target_events=14,
        solver_faults=1, scheduler_faults=2)
    plan = tmp_path / "plan.json"
    plan.write_text(churn.to_json())
    n = len(churn.events)
    log = tmp_path / "log.jsonl"
    out = _run_blocked("shockwave_tpu_torch.simulate",
                       *_golden_args("shockwave_tpu_level"),
                       "--fault-plan", str(plan), "--round_log", str(log))
    assert f"Faults: {n} applied, {n} recovered, 0 unrecovered" in out
    assert f"Wrote {log}" in out
    assert log.read_text().count('"event": "round"') > 50


def test_estimation_cli_runs_with_jax_blocked():
    """``simulate -p max_min_fairness_packed --profiling_percentage 0.5
    --num_reference_models 4`` on the golden trace (online throughput
    estimation, its ALS on the CPU) with JAX and the JAX package
    unimportable: the pinned run (``bench_sim.SIM_FEATURES``)."""
    out = _run_blocked("shockwave_tpu_torch.simulate", "-t",
                       "traces/small_12_dynamic.trace", "-p",
                       "max_min_fairness_packed", "-c", "v100=8",
                       "--time_per_iteration", "120",
                       "--profiling_percentage", "0.5",
                       "--num_reference_models", "4", "--device", "cpu",
                       "--no_profile_cache")
    expected = bench_sim.SIM_FEATURES["estimate_p0.5_r4"]
    assert f"Makespan: {expected['makespan']:.3f} s" in out
    assert f"Average JCT: {expected['avg_jct']:.3f} s" in out
    assert f"Worst FTF: {expected['worst_ftf']:.3f}" in out


def test_whatif_price_runs_with_jax_blocked(tmp_path):
    """``tools.whatif price`` on round 91 of the committed decision log with
    JAX and the JAX package unimportable: the JAX package's decision
    (``bench_sim.PRICING["log"]``), no module of either loaded."""
    import json

    report = tmp_path / "price.json"
    b = bench_sim.PRICING_LOG_BURST
    out = _run_blocked("shockwave_tpu_torch.tools.whatif", "price", "--log",
                       "results/flight_recorder/decisions.jsonl", "--round",
                       str(bench_sim.PRICING_LOG_ROUND), "--burst-jobs",
                       str(b["jobs"]), "--burst-scale", str(b["scale"]),
                       "--burst-duration", str(b["duration"]), "--device",
                       "cpu", "--out", str(report))
    expected = bench_sim.PRICING["log"]
    assert f"marginal price says {expected['action']}" in out
    decision = json.loads(report.read_text())["priced_decision"]
    assert bench_sim.decision_misses(decision, expected) == []


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN or module.split(".")[:2] == ["google",
                                                          "protobuf"]


def test_train_cli_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[Transformer] steps=2 loss=" in proc.stdout
    assert "[Transformer] steps=1 loss=" in proc.stdout
    assert "LEAKED []" in proc.stdout
    assert (tmp_path / "train_state.pt").exists()


_FAMILIES_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
from shockwave_tpu_torch.models import train
base = ["--batch_size", "2", "--device", "cpu", "-n", "2"]
for family in train.FAMILIES:
    train.main(["--model", family] + base)
small = ["--model", "Transformer", "--vocab_size", "64", "--d_model", "32",
         "--num_heads", "2", "--num_layers", "2", "--seq_len", "128"]
train.main(small + base + ["--num_experts", "2", "--remat",
                           "--logit_chunk", "64", "--attention", "flash"])
orbax = ["--ckpt_backend", "orbax", "--checkpoint_dir", sys.argv[1]]
train.main(["--model", "Recommendation"] + base + orbax)
train.main(["--model", "Recommendation"] + base + orbax)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_every_family_and_option_runs_with_jax_blocked(tmp_path):
    """Every family of the training program, the MoE MLP with remat and
    the chunked head, and the directory checkpoint (saved, then resumed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _FAMILIES_SCRIPT, str(tmp_path)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    for family in ("Transformer", "ResNet-18", "ResNet-50", "LM",
                   "Recommendation", "A3C", "CycleGAN"):
        assert f"[{family}] steps=2 loss=" in proc.stdout, family
    assert proc.stdout.count("[Transformer] steps=2") == 2
    assert f"RESUMED from {tmp_path / 'orbax_state'} at step 2" in proc.stdout
    assert "LEAKED []" in proc.stdout


_RING_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
from shockwave_tpu_torch.models import train
train.main(["--model", "Transformer", "--batch_size", "2", "--vocab_size",
            "64", "--d_model", "32", "--num_heads", "2", "--num_layers", "1",
            "--seq_len", "128", "--attention", "ring", "--seq_parallel", "1",
            "--device", "cpu", "-n", "2"])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_ring_train_cli_runs_with_jax_blocked():
    """``train --attention ring --seq_parallel 1 --device cpu`` (ring
    attention over a one-device mesh) with JAX and the JAX package
    unimportable, leaving no module of either loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _RING_SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[Transformer] steps=2 loss=" in proc.stdout
    assert "LEAKED []" in proc.stdout


def test_ulysses_train_cli_runs_with_jax_blocked():
    """``train --attention ulysses --device cpu`` (Ulysses attention over a
    one-device mesh) with JAX and the JAX package unimportable, leaving no
    module of either loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    script = _RING_SCRIPT.replace('"ring", "--seq_parallel"',
                                  '"ulysses", "--seq_parallel"')
    assert '"ulysses"' in script
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[Transformer] steps=2 loss=" in proc.stdout
    assert "LEAKED []" in proc.stdout


def test_telemetry_cli_and_recorder_cli_run_with_jax_blocked(tmp_path):
    """``simulate`` with every plane on (``--metrics-out``, ``--trace-out``,
    ``--decision-log``, ``--watchdog``) on the golden trace under the
    level backend, then ``obs.recorder summary`` and ``replay --device
    cpu`` of the log it wrote, with JAX and the JAX package unimportable:
    the golden metrics, the three dumps written, every plan replayed
    exactly, no module of either loaded."""
    import json

    m, t, d = (tmp_path / n for n in ("m.json", "t.json", "d.jsonl"))
    out = _run_blocked("shockwave_tpu_torch.simulate",
                       *_golden_args("shockwave_tpu_level"),
                       "--metrics-out", str(m), "--trace-out", str(t),
                       "--decision-log", str(d), "--watchdog")
    _assert_metrics(out, dict(bench_sim.GOLDEN["shockwave_tpu_level"],
                              rounds=113))
    assert "Scheduler health:" in out
    assert json.loads(m.read_text())["schema"] == "shockwave-metrics-v1"
    assert json.loads(t.read_text())["traceEvents"]
    summary = json.loads(_run_blocked(
        "shockwave_tpu_torch.obs.recorder", "summary", str(d)
    ).split("LEAKED")[0])
    assert summary["plans"] == 16 and summary["backends"] == {"level": 16}
    replayed = _run_blocked("shockwave_tpu_torch.obs.recorder", "replay",
                            str(d), "--device", "cpu")
    assert "replayed 16 plan record(s): 16 exact, 0 diverged" in replayed


# The control plane's CLIs with gRPC and protobuf unimportable as well.
_PLANE_SCRIPT = """
import runpy, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu",
           "grpc", "google.protobuf")
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
module, sys.argv = sys.argv[1], [sys.argv[1], *sys.argv[2:]]
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:  # a CLI that exits with its status
    if e.code:
        raise
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and any(
    m == b or m.startswith(b + ".") for b in BLOCKED))
print("LEAKED", leaked)
"""


def test_physical_plane_clis_run_with_jax_and_grpc_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.run_physical`` and ``python -m
    shockwave_tpu_torch.runtime.worker --device cpu`` on localhost with
    ``jax``, the JAX package, ``grpc`` and ``google.protobuf`` all
    unimportable: two jobs of the synthetic payload submitted through the
    SubmitJobs stream run over two rounds to completion, and neither
    process loaded any of them."""
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.data.trace import write_trace
    from shockwave_tpu_torch.runtime.testing import free_port

    assert "grpc" in _PLANE_SCRIPT and "google.protobuf" in _PLANE_SCRIPT
    trace = tmp_path / "two.trace"
    jobs = [Job(job_type="ResNet-18 (batch size 32)", command="python3 x.py",
                num_steps_arg="-n", total_steps=steps) for steps in (90, 60)]
    write_trace(str(trace), jobs, [0.0, 0.3])
    sched_port, worker_port = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    sched = subprocess.Popen(
        [sys.executable, "-c", _PLANE_SCRIPT,
         "shockwave_tpu_torch.run_physical", "-t", str(trace), "-p", "fifo",
         "--port", str(sched_port), "--expected_workers", "2",
         "--time_per_iteration", "2", "--device", "cpu", "--payload",
         "synthetic", "--payload_args", "--steps_per_sec 50",
         "--max_rounds", "20", "--completion_buffer_seconds", "10",
         "--worker_timeout", "120"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # The agent registers once the scheduler listens (a loaded host can
    # take longer to import the scheduler than the agent's retries last).
    ready, _, _ = select.select([sched.stdout], [], [], 240)
    listening = sched.stdout.readline() if ready else ""
    if "Scheduler listening" not in listening:
        sched.kill()
        raise AssertionError(f"the scheduler did not start: {listening!r} "
                             f"{sched.stderr.read()[-4000:]}")
    worker = subprocess.Popen(
        [sys.executable, "-c", _PLANE_SCRIPT,
         "shockwave_tpu_torch.runtime.worker", "-t", "v100", "-n", "2",
         "-a", "127.0.0.1", "-s", str(sched_port), "-p", str(worker_port),
         "--device", "cpu", "--run_dir", str(tmp_path / "run"),
         "--checkpoint_dir", str(tmp_path / "ckpt")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        sched_out, sched_err = sched.communicate(timeout=240)
        worker_out, worker_err = worker.communicate(timeout=60)
    finally:
        for proc in (sched, worker):
            if proc.poll() is None:
                proc.kill()
    assert sched.returncode == 0, sched_err[-4000:]
    assert worker.returncode == 0, worker_err[-4000:]
    assert "Completed jobs: 2 of 2" in sched_out
    assert "LEAKED []" in sched_out and "LEAKED []" in worker_out
    assert len(list((tmp_path / "run").glob("*.stdout"))) >= 2


# Every Python process of a drill (the scheduler nodes, the agents, the
# payloads) started with this directory first on its path: a
# sitecustomize marks the blocked modules missing, and at exit each
# process writes the blocked modules it holds to leaked-<pid>.json.
_SITECUSTOMIZE = """
import atexit, json, os, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu",
           "grpc", "google.protobuf")
for name in BLOCKED:
    sys.modules[name] = None

def _report():
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".") for b in BLOCKED))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"leaked-{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(leaked, f)

atexit.register(_report)
"""


# A wall-clock drill (3 s rounds, a 2 s lease): the repo's bounded retry
# for load-sensitive runs, as tests/test_torch_runtime.py's.
@pytest.mark.wallclock_retry
def test_ha_drill_runs_with_jax_and_grpc_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.tools.ha_smoke --arms cold`` with
    every process it starts blocked from ``jax``, the JAX package,
    ``grpc`` and ``google.protobuf``: the leader (``python -m
    shockwave_tpu_torch.ha.standby``) is SIGKILLed by the seeded crash, a
    cold restart resumes from the journal and completes every job, and no
    process that exited loaded a blocked module."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(blocker), str(ROOT)]))
    out = tmp_path / "ha"
    proc = subprocess.run(
        [sys.executable, "-c", _PLANE_SCRIPT,
         "shockwave_tpu_torch.tools.ha_smoke", "--device", "cpu",
         "--arms", "cold", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "[ha_smoke] PASS" in proc.stdout and "LEAKED []" in proc.stdout
    report = json.loads((out / "ha_smoke.json").read_text())
    succ = report["cold_restart"]["successor"]
    assert succ["took_over"] and succ["epoch"] == 2
    assert succ["completed_jobs"] == [0, 1, 2, 3, 4, 5]
    leaks = [json.loads(f.read_text()) for f in blocker.glob("leaked-*")]
    # The restart node, both agents and the payloads at least.
    assert len(leaks) >= 4 and all(leak == [] for leak in leaks), leaks


def test_measure_throughput_runs_with_jax_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.tools.measure_throughput --device
    cpu`` measures a row and writes its oracle with JAX and the JAX
    package unimportable."""
    out = tmp_path / "oracle.json"
    stdout = _run_blocked(
        "shockwave_tpu_torch.tools.measure_throughput", "--families",
        "Recommendation", "--batch_sizes", "512", "--device", "cpu",
        "--steps", "2", "--warmup", "1", "-o", str(out))
    assert "Recommendation (batch size 512):" in stdout
    assert "('Recommendation (batch size 512)', 1)" in json.loads(
        out.read_text())["h100"]


def test_chaos_soak_runs_with_jax_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.tools.chaos_soak --smoke --device
    cpu`` holds every invariant with JAX and the JAX package
    unimportable."""
    stdout = _run_blocked("shockwave_tpu_torch.tools.chaos_soak", "--smoke",
                          "--device", "cpu", "--out", str(tmp_path))
    assert "OK: 81 faults, 0 lost jobs" in stdout
    assert json.loads((tmp_path / "chaos_smoke.json").read_text())["ok"]


def test_streaming_soak_runs_with_jax_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.tools.streaming_soak --smoke
    --device cpu`` holds every invariant with JAX and the JAX package
    unimportable."""
    stdout = _run_blocked("shockwave_tpu_torch.tools.streaming_soak",
                          "--smoke", "--device", "cpu", "--out",
                          str(tmp_path))
    assert "OK: 106 events (82 faults + 24 admissions)" in stdout
    assert json.loads((tmp_path / "churn_smoke.json").read_text())["ok"]


# _SITECUSTOMIZE that also reports whether the process loaded torch and
# whether it is an ingest submitter (which sets its wire mode's variable).
_SITECUSTOMIZE_TORCH = _SITECUSTOMIZE.replace(
    "        json.dump(leaked, f)",
    "        json.dump({'leaked': leaked, 'torch': 'torch' in sys.modules,\n"
    "                   'submitter': 'SHOCKWAVE_WIRE_COLUMNAR' in os.environ},"
    " f)")


# A wall-clock campaign under the smoke's rate floor and p99 budget.
@pytest.mark.wallclock_retry
def test_ingest_soak_runs_with_jax_and_grpc_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.tools.ingest_soak --smoke --device
    cpu`` (the parity gate, the fleet, the pricing phase) with every
    process blocked from ``jax``, the JAX package, ``grpc`` and
    ``google.protobuf``; the submitter processes import no torch
    either."""
    assert "'torch' in sys.modules" in _SITECUSTOMIZE_TORCH
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_SITECUSTOMIZE_TORCH)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(blocker), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", _PLANE_SCRIPT,
         "shockwave_tpu_torch.tools.ingest_soak", "--smoke", "--device",
         "cpu", "--out", str(tmp_path / "out")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "parity: 24 batches byte-identical acks" in proc.stdout
    assert "OK: 3000 jobs" in proc.stdout and "LEAKED []" in proc.stdout
    reports = [json.loads(f.read_text()) for f in blocker.glob("leaked-*")]
    children = [r for r in reports if r["submitter"]]
    assert len(children) == 2 and not any(r["torch"] for r in children)
    assert all(r["leaked"] == [] for r in reports), reports


def test_profile_ingest_runs_with_jax_blocked(tmp_path):
    out = tmp_path / "profile.json"
    _run_blocked("shockwave_tpu_torch.tools.profile_ingest", "-o", str(out),
                 "--batches", "4", "--batch-size", "64", "--repeats", "1")
    stages = json.loads(out.read_text())["stages"]
    assert set(stages) == {"encode_scalar", "encode_columnar",
                           "decode_scalar", "decode_columnar_legacy",
                           "decode_columnar_frame", "ledger", "ack_encode"}


def test_a_seq_and_moe_gang_runs_with_jax_blocked(tmp_path):
    """Two ranks of ``python -m shockwave_tpu_torch.models.train
    --seq_parallel 2 --attention ring --num_experts 2`` over gloo with
    ``jax`` and the JAX package unimportable in both."""
    from shockwave_tpu_torch.runtime.testing import free_port

    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(blocker), str(ROOT)]))
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shockwave_tpu_torch.models.train", "--model",
         "Transformer", "-n", "2", "--batch_size", "2", "--vocab_size", "64",
         "--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--seq_len", "64", "--attention", "ring", "--seq_parallel", "2",
         "--num_experts", "2", "--device", "cpu", "--distributed_addr",
         addr, "--num_workers", "2", "--worker_rank", str(rank)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "MESH backend=gloo" in out and "GANG rank=" in out
    leaks = [json.loads(f.read_text()) for f in blocker.glob("leaked-*")]
    assert len(leaks) == 2 and all(leak == [] for leak in leaks), leaks


def _blocked_ranks(tmp_path, commands):
    """``commands`` (one a rank) run with the blocker installed; each exit
    code and output, and the leaks the ranks reported."""
    blocker = tmp_path / "blocker"
    blocker.mkdir(parents=True)
    (blocker / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(blocker), str(ROOT)]))
    procs = [subprocess.Popen(command, cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for command in commands]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    leaks = [json.loads(f.read_text()) for f in blocker.glob("leaked-*")]
    return [p.returncode for p in procs], outs, leaks


def test_a_model_parallel_gang_runs_with_jax_blocked(tmp_path):
    """Two ranks of ``python -m shockwave_tpu_torch.models.train
    --model_parallel 2 --num_experts 2`` over gloo (heads, MLP, vocabulary
    and experts split over "model"), writing and then resuming its
    checkpoint of whole parameters, with ``jax`` and the JAX package
    unimportable in both."""
    from shockwave_tpu_torch.runtime.testing import free_port

    for steps in ("2", "1"):
        addr = f"127.0.0.1:{free_port()}"
        codes, outs, leaks = _blocked_ranks(tmp_path / steps, [
            [sys.executable, "-m", "shockwave_tpu_torch.models.train",
             "--model", "Transformer", "-n", steps, "--batch_size", "2",
             "--vocab_size", "64", "--d_model", "32", "--num_heads", "2",
             "--num_layers", "1", "--seq_len", "64", "--num_experts", "2",
             "--model_parallel", "2", "--device", "cpu", "--checkpoint_dir",
             str(tmp_path / "ckpt"), "--distributed_addr", addr,
             "--num_workers", "2", "--worker_rank", str(rank)]
            for rank in range(2)])
        for code, out in zip(codes, outs):
            assert code == 0, out[-3000:]
            assert "'model': 2" in out and "GANG rank=" in out
            assert ("RESUMED" in out) == (steps == "1")
        assert len(leaks) == 2 and all(leak == [] for leak in leaks), leaks


_PIPE_SCRIPT = """
import datetime, sys
import torch
import torch.distributed as dist
from shockwave_tpu_torch.models.transformer import TransformerConfig
from shockwave_tpu_torch.parallel.mesh import make_process_mesh
from shockwave_tpu_torch.parallel.pipeline import PipelinedLM
rank, addr = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
cfg = TransformerConfig(vocab_size=64, d_model=16, num_heads=2, num_layers=2,
                        d_ff=32, max_len=12)
tokens = torch.randint(0, 64, (4, 13),
                       generator=torch.Generator().manual_seed(0))
whole = PipelinedLM(cfg, 2, 2).init(torch.Generator().manual_seed(0), tokens)
model = PipelinedLM(cfg, 2, 2, make_process_mesh(pipe_parallel=2))
params = model.shard_params(whole)
for key in ("embedding", "ln_f_scale", "ln_f_bias", "positional"):
    params[key].requires_grad_()
loss = model.loss(params, tokens)
loss.backward()
model.sum_replicated_gradients(params)
alone = PipelinedLM(cfg, 2, 2).loss(whole, tokens)
print("PIPE", rank, float(loss), float(alone))
dist.destroy_process_group()
"""


def test_the_pipeline_runs_with_jax_blocked(tmp_path):
    """``parallel/pipeline.py``'s ``PipelinedLM`` over a two-rank pipe
    gang (one stage a rank) and in one process, with ``jax`` and the JAX
    package unimportable: the same loss on both ranks and alone."""
    from shockwave_tpu_torch.runtime.testing import free_port

    addr = f"127.0.0.1:{free_port()}"
    codes, outs, leaks = _blocked_ranks(tmp_path, [
        [sys.executable, "-c", _PIPE_SCRIPT, str(rank), addr]
        for rank in range(2)])
    losses = set()
    for code, out in zip(codes, outs):
        assert code == 0, out[-3000:]
        line = [l for l in out.splitlines() if l.startswith("PIPE ")][0]
        gang, alone = line.split()[2:]
        assert abs(float(gang) - float(alone)) <= 1e-6 * abs(float(alone))
        losses.add(gang)
    assert len(losses) == 1
    assert len(leaks) == 2 and all(leak == [] for leak in leaks), leaks


# A wall-clock run of real payloads (a few seconds a round).
@pytest.mark.wallclock_retry
def test_card_driver_with_a_gang_runs_with_jax_and_grpc_blocked(tmp_path):
    """``python -m shockwave_tpu_torch.run_physical --driver card --device
    cpu`` on a singleton and a two-rank gang, with every process it starts
    (the agent, the payloads, both gang ranks over gloo) blocked from
    ``jax``, the JAX package, ``grpc`` and ``google.protobuf``: both jobs
    complete, and no process that exited loaded a blocked module."""
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.data.throughputs import stringify_throughputs
    from shockwave_tpu_torch.data.trace import write_trace

    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    trace = tmp_path / "two.trace"
    write_trace(str(trace), [
        Job(job_type="Recommendation (batch size 512)", command="x",
            num_steps_arg="-n", total_steps=100),
        Job(job_type="Recommendation (batch size 1024)", command="x",
            num_steps_arg="-n", total_steps=100, scale_factor=2)],
        [0.0, 0.0])
    oracle = tmp_path / "oracle.json"
    oracle.write_text(json.dumps(stringify_throughputs({"h100": {
        (f"Recommendation (batch size {bs})", sf): {"null": 20.0 * sf}
        for bs in (512, 1024) for sf in (1, 2)}})))
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(blocker), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", _PLANE_SCRIPT,
         "shockwave_tpu_torch.run_physical", "--driver", "card", "--trace",
         str(trace), "--oracle", str(oracle), "--device", "cpu",
         "--policy", "shockwave_tpu", "--round_s", "6", "--train_s", "2",
         "--time_scale", "1", "--max_rounds", "20", "--out",
         str(tmp_path / "out")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "LEAKED []" in proc.stdout
    summary = json.loads(
        (tmp_path / "out" / "shockwave_tpu" / "summary.json").read_text())
    assert summary["completed_jobs"] == 2 and summary["worker_type"] == "h100"
    gang = list((tmp_path / "out" / "shockwave_tpu" / "run").glob(
        "job=1_*.stdout"))
    assert len(gang) == 2 and all(
        "GANG rank=" in p.read_text() for p in gang)
    leaks = [json.loads(f.read_text()) for f in blocker.glob("leaked-*")]
    # The driver, the agent, the singleton and both ranks at least.
    assert len(leaks) >= 5 and all(leak == [] for leak in leaks), leaks


def test_kill_stale_workloads_runs_with_jax_and_grpc_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _PLANE_SCRIPT,
         "shockwave_tpu_torch.tools.kill_stale_workloads", "--pattern",
         f"no-such-process-{uuid.uuid4().hex}"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "No stale workload processes." in out.stdout
    assert "LEAKED []" in out.stdout


@pytest.mark.parametrize("trace", ["small_12_dynamic.trace",
                                   "generated_220_dynamic.trace"])
def test_localize_jobs_gives_every_family_the_training_program(trace):
    """``--payload train`` accepts every job of both traces: each runs
    the port's training program for its family at its batch size."""
    from shockwave_tpu_torch.data import parse_trace
    from shockwave_tpu_torch.data.workload_info import parse_job_type
    from shockwave_tpu_torch.run_physical import localize_jobs

    jobs, _ = parse_trace(str(ROOT / "traces" / trace))
    types = [parse_job_type(job.job_type) for job in jobs]
    localize_jobs(jobs, "train", "--device cpu")
    for job, (family, batch_size) in zip(jobs, types):
        assert job.command.endswith(
            f"-m shockwave_tpu_torch.models.train --model {family} "
            f"--batch_size {batch_size} --device cpu")
    # Both traces hold the Transformer, LM, Recommendation and both ResNets.
    assert len({family for family, _ in types}) == 5


def test_a_golden_trace_resnet_payload_runs_with_jax_blocked(tmp_path):
    """The command ``localize_jobs`` gives the golden trace's first
    ResNet-18 job, run for 2 steps with a checkpoint, with ``jax``, the
    JAX package, ``grpc`` and ``google.protobuf`` unimportable."""
    from shockwave_tpu_torch.data import parse_trace
    from shockwave_tpu_torch.run_physical import localize_jobs

    jobs, _ = parse_trace(str(ROOT / "traces" / "small_12_dynamic.trace"))
    job = next(j for j in jobs if j.job_type.startswith("ResNet-18"))
    localize_jobs([job], "train", "--device cpu")
    argv = shlex.split(job.command)
    assert argv[1:3] == ["-m", "shockwave_tpu_torch.models.train"]
    out = subprocess.run(
        [sys.executable, "-c", _PLANE_SCRIPT, argv[2], *argv[3:],
         job.num_steps_arg, "2", "--checkpoint_dir", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT),
                           OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[ResNet-18] steps=2 loss=" in out.stdout
    assert "device=cpu" in out.stdout
    assert "LEAKED []" in out.stdout
    assert (tmp_path / "train_state.pt").exists()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "shockwave_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for walked in ("simulate.py", "tools/scale_experiments.py",
                   "policies/lp_backend.py", "policies/water_filling.py",
                   "cells/planner.py", "cells/batched.py",
                   "whatif/scenario.py", "obs/recorder.py",
                   "tools/whatif.py", "solver/eg_milp.py",
                   "policies/gandiva.py", "policies/allox.py",
                   "policies/strategy_proof.py",
                   "policies/max_min_fairness_packed.py",
                   "policies/speculation.py", "solver/eg_greedy.py",
                   "solver/duals.py", "data/generate.py",
                   "runtime/faults.py", "ha/codec.py",
                   "core/throughput_estimator.py",
                   "ops/matrix_completion.py", "whatif/pricing.py",
                   "data/job_table.py", "data/spot_prices.py",
                   "utils/fileio.py", "parallel/ulysses.py",
                   "analysis/sanitize.py", "obs/sketch.py",
                   "obs/history.py", "obs/metrics.py", "obs/trace.py",
                   "obs/propagate.py", "obs/spantree.py",
                   "obs/calibration.py", "obs/watchdog.py",
                   "obs/explain.py", "obs/fleet.py", "obs/__init__.py",
                   "run_physical.py", "core/physical.py",
                   "runtime/admission.py", "runtime/dispatcher.py",
                   "runtime/iterator.py", "runtime/lease.py",
                   "runtime/retry.py", "runtime/synthetic.py",
                   "runtime/testing.py", "runtime/worker.py",
                   "runtime/rpc/wiring.py", "runtime/rpc/scheduler_server.py",
                   "runtime/rpc/scheduler_client.py",
                   "runtime/rpc/worker_server.py",
                   "runtime/rpc/worker_client.py",
                   "runtime/rpc/iterator_client.py",
                   "runtime/rpc/submitter_client.py",
                   "runtime/protobuf/wire.py",
                   "runtime/protobuf/fastwire.py",
                   "runtime/protobuf/common_pb2.py",
                   "runtime/protobuf/enums_pb2.py",
                   "runtime/protobuf/iterator_to_scheduler_pb2.py",
                   "runtime/protobuf/scheduler_to_worker_pb2.py",
                   "runtime/protobuf/worker_to_scheduler_pb2.py",
                   "runtime/protobuf/telemetry_pb2.py",
                   "runtime/protobuf/explain_pb2.py",
                   "runtime/protobuf/admission_pb2.py",
                   "ha/journal.py", "ha/election.py", "ha/frontdoor.py",
                   "ha/standby.py", "tools/ha_smoke.py",
                   "tools/kill_stale_workloads.py", "models/resnet.py",
                   "models/layers.py", "models/small_models.py",
                   "models/convert.py", "solver/eg_sharded.py",
                   "parallel/mesh.py", "solver/eg_pdhg.py"):
        assert ROOT / "shockwave_tpu_torch" / walked in files
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert bad == []


def test_guard_matches_module_names_exactly():
    assert _forbidden("shockwave_tpu") and _forbidden("shockwave_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert _forbidden("grpc") and _forbidden("google.protobuf.descriptor")
    assert not _forbidden("shockwave_tpu_torch.ops")
    assert not _forbidden("jaxtyping") and not _forbidden("grpcio_extra")


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line on a host
    without a card, and in a directory that holds nothing else of the
    repo."""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (alone, alone / "chip_smoke.py")):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
