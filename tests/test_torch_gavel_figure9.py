"""The port's Figure-9 runner against the JAX package's, on the CPU.

The 220-job trace on 64 GPUs (4 a server, 120 s rounds) through
``shockwave_tpu_torch.tools.scale_experiments.run_cell`` gives the
metrics of the JAX package's ``scripts/replicate/scale_experiments.py::
run_cell`` under ``max_min_fairness``, ``shockwave_tpu``,
``finish_time_fairness`` and ``max_min_fairness_water_filling``, within
1e-3 and in the same number of rounds. The constants ``chip_smoke.py``
holds the card's runs to (``bench_sim.FIGURE9`` at 128 and 256 GPUs, and
``TIER_2048_MMF``) are held to live runs of the JAX package, and the
runner's command line writes its summary.
"""

import importlib.util
import json
import os
import pickle

import pytest
import scipy

from shockwave_tpu_torch.tools import bench_sim, scale_experiments
from gavel_reference import ref_run
from test_torch_gavel_simulate import METRICS

_spec = importlib.util.spec_from_file_location(
    "ref_scale_experiments",
    bench_sim.ROOT / "scripts" / "replicate" / "scale_experiments.py")
ref_scale = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_scale)


def test_runner_keeps_the_reference_configuration():
    assert scale_experiments.SHOCKWAVE_CONFIG == ref_scale.SHOCKWAVE_CONFIG
    assert scale_experiments.DEFAULT_SIZES == ref_scale.DEFAULT_SIZES
    assert scale_experiments.TRACE == bench_sim.TRACE_220
    assert os.path.samefile(scale_experiments.TRACE, ref_scale.FALLBACK_TRACE)
    assert scale_experiments.DEFAULT_POLICIES == ref_scale.DEFAULT_POLICIES


@pytest.mark.parametrize("policy", [
    p for p, gpus in bench_sim.FIGURE9 if gpus == 64])
def test_figure9_at_64_gpus_equals_the_reference(policy):
    got = scale_experiments.run_cell(bench_sim.TRACE_220, policy, 64,
                                     device="cpu")
    ref = ref_scale.run_cell(str(bench_sim.TRACE_220), policy, 64, 120)
    assert bench_sim.check_run(got, {k: ref[k] for k in METRICS}) == []
    assert got["rounds"] == ref["rounds"]
    assert got["unfair_fraction"] == ref["unfair_fraction"]
    assert bench_sim.check_run(ref, bench_sim.pinned(
        "FIGURE9", (policy, 64), scipy.__version__)) == []
    if policy.startswith("shockwave"):
        assert got["allocations"] == 0 and got["solves"]
    else:
        assert got["allocations"] > 0 and got["solves"] == {}


@pytest.mark.parametrize("policy, gpus", [
    cell for cell in bench_sim.FIGURE9 if cell[1] != 64])
def test_pinned_figure9_cells_are_the_references(policy, gpus):
    ref = ref_scale.run_cell(str(bench_sim.TRACE_220), policy, gpus, 120)
    assert bench_sim.check_run(ref, bench_sim.pinned(
        "FIGURE9", (policy, gpus), scipy.__version__)) == []


def test_pinned_2048_job_max_min_tier_is_the_references():
    ref = ref_run(bench_sim.TRACE_2048, "max_min_fairness", 256)
    assert bench_sim.check_run(ref, bench_sim.pinned(
        "TIER_2048_MMF", None, scipy.__version__)) == []


def test_runner_cli_writes_the_summary(tmp_path):
    """The summary holds this sweep's cells only, and a cell's pickle from
    another setting (here another seed) is run again, not reused."""
    argv = ["--out", str(tmp_path), "--policies", "max_min_fairness",
            "--num_gpus", "128", "--device", "cpu"]
    stale = {k: 0 for k in scale_experiments.SUMMARY_KEYS}
    stale.update(trace_file=str(scale_experiments.TRACE),
                 round_duration=120.0, seed=1, gpus_per_server=4)
    for name in ("max_min_fairness_128gpus", "fifo_64gpus"):
        with open(tmp_path / f"{name}.pickle", "wb") as f:
            pickle.dump(stale, f)
    out = scale_experiments.main(argv)
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary == json.loads(json.dumps(out))
    assert list(summary["results"]) == ["max_min_fairness_128gpus"]
    assert scale_experiments.main(argv) == out  # the cell is reused now
    cell = summary["results"]["max_min_fairness_128gpus"]
    assert bench_sim.check_run(cell, bench_sim.pinned(
        "FIGURE9", ("max_min_fairness", 128), scipy.__version__)) == []
    assert cell["allocations"] > 0
    assert sorted(cell) == sorted(scale_experiments.SUMMARY_KEYS)
