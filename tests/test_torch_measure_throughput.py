"""The port's throughput harness (``tools/measure_throughput.py``) against
the JAX package's ``scripts/profiling/measure_throughput.py``, and the
card's committed oracle (``results/measured_oracle_h100.json``).

The slope, the pair's clamp and the gang extrapolation run in both
packages under one scripted clock: each fake step advances it by its
family's scripted cost, each sync by a scripted jitter, so both harnesses
time the same steps and must write the same oracle file.
"""

import importlib.util
import json
import math
import types
from pathlib import Path

import pytest
import torch

from shockwave_tpu.data.throughputs import read_throughputs as jax_read
from shockwave_tpu_torch.data.default_oracle import _FAMILY_BATCH_SIZES
from shockwave_tpu_torch.data.throughputs import read_throughputs
from shockwave_tpu_torch.tools import measure_throughput as port

ROOT = Path(__file__).resolve().parent.parent
ORACLE = ROOT / "results" / "measured_oracle_h100.json"


def _jax_harness():
    path = ROOT / "scripts" / "profiling" / "measure_throughput.py"
    spec = importlib.util.spec_from_file_location("jax_measure_throughput",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class ScriptedClock:
    """``time.time`` of both harnesses: steps and syncs advance it."""

    def __init__(self, jitter=(0.0,)):
        self.now = 1000.0
        self.jitter = list(jitter)
        self.syncs = 0

    def time(self):
        return self.now

    def sync_cost(self):
        cost = self.jitter[self.syncs % len(self.jitter)]
        self.syncs += 1
        return cost


class Loss:
    """A loss whose fetch costs the clock a scripted sync (``float`` for
    the JAX harness, ``.item()`` for the port's)."""

    def __init__(self, clock):
        self.clock = clock
        self.is_cuda = False

    def __float__(self):
        self.clock.now += self.clock.sync_cost()
        return 1.0

    def item(self):
        return float(self)


def _stepper(clock, cost):
    def one_step():
        clock.now += cost
        return Loss(clock)

    return one_step


def _patch(monkeypatch, module, clock):
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=clock.time))


@pytest.mark.parametrize("cost,jitter,steps", [
    (0.01, (0.1,), 30),            # slope at the first n
    (0.0002, (0.1, 0.12, 0.09), 30),  # n grows 4x until the slope clears
    (1e-6, (0.2, 0.05), 4000),     # the cap: the plain-rate fallback
])
def test_slope_matches_the_jax_harness(monkeypatch, capsys, cost, jitter,
                                       steps):
    jax_mt = _jax_harness()
    rates = []
    for module in (jax_mt, port):
        clock = ScriptedClock(jitter)
        _patch(monkeypatch, module, clock)
        rates.append(module.measure_isolated(_stepper(clock, cost), 5, steps))
    assert rates[0] == rates[1]
    if steps == 4000:  # the warning is the same too
        out = capsys.readouterr().out
        assert out.count("[warn] slope signal below jitter") == 2


def test_pair_rate_matches_the_jax_harness(monkeypatch):
    jax_mt = _jax_harness()
    rates = []
    for module in (jax_mt, port):
        clock = ScriptedClock((0.1, 0.11))
        _patch(monkeypatch, module, clock)
        rates.append(module.measure_pair(_stepper(clock, 0.004),
                                         _stepper(clock, 0.006), 2, 30))
    assert rates[0] == rates[1]
    assert rates[1][0] == rates[1][1]


# Scripted step costs a family (seconds).
COSTS = {"ResNet-18": 0.02, "Recommendation": 0.003}


def _write_both(monkeypatch, tmp_path, pair_rate=None):
    """Both harnesses' ``main`` over ResNet-18 at 16 and 32 and
    Recommendation at 512, with pairs, under the scripted clock (each
    built step a closure over it); ``pair_rate`` replaces every pair's
    measured rate. Returns the two files' JSON."""
    jax_mt = _jax_harness()
    out = {}
    for name, module in (("jax", jax_mt), ("port", port)):
        clock = ScriptedClock((0.1, 0.12))
        _patch(monkeypatch, module, clock)
        monkeypatch.setattr(
            module, "build_step",
            lambda family, bs, *a, **k: _stepper(clock,
                                                 COSTS[family] * bs / 16))
        if pair_rate is not None:
            monkeypatch.setattr(module, "measure_pair",
                                lambda *a, **k: (pair_rate, pair_rate))
        args = types.SimpleNamespace(
            families=["ResNet-18", "Recommendation"],
            batch_sizes=[16, 32, 512], warmup=3, steps=30, pairs=True,
            worker_type="h100", measured_scale_factors_only=False,
            output=str(tmp_path / f"{name}.json"), payload_args="",
            device="cpu")
        if name == "jax":
            import jax

            monkeypatch.setattr(jax, "devices", lambda: [types.SimpleNamespace(
                platform="cpu", device_kind="cpu")])
        module.main(args)
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    return out


def test_oracle_file_matches_the_jax_harness(monkeypatch, tmp_path):
    """Isolated rates, pairs and the gang extrapolation: the same file."""
    out = _write_both(monkeypatch, tmp_path)
    assert out["jax"] == out["port"]
    entries = out["port"]["h100"]
    assert len(entries) == 3 * 4  # 3 rows x 4 scale factors
    iso = entries["('ResNet-18 (batch size 16)', 1)"]["null"]
    assert entries["('ResNet-18 (batch size 16)', 2)"]["null"] == \
        pytest.approx(iso * 2 * 0.92)


def test_pair_rates_are_clamped_as_the_jax_harness(monkeypatch, tmp_path):
    """A pair rate above a side's isolated rate is clamped to it, in both
    harnesses alike."""
    out = _write_both(monkeypatch, tmp_path, pair_rate=1e6)
    assert out["jax"] == out["port"]
    entries = out["port"]["h100"]
    for key, entry in entries.items():
        for other, value in entry.items():
            if other != "null":
                assert value[0] == entry["null"]


def test_a_tiny_oracle_reads_alike_in_both_packages(tmp_path):
    """The port measures two small rows on the CPU and writes the oracle;
    both packages' readers parse it to equal dicts."""
    path = tmp_path / "tiny.json"
    args = port.build_parser().parse_args(
        ["--families", "Recommendation", "A3C", "--batch_sizes", "512", "4",
         "--device", "cpu", "--steps", "2", "--warmup", "1", "-o",
         str(path)])
    oracle = port.main(args)
    ours, theirs = read_throughputs(str(path)), jax_read(str(path))
    assert ours == theirs == oracle
    assert sorted(ours["h100"]) == sorted(
        (f"{f} (batch size {bs})", sf) for f, bs in
        (("Recommendation", 512), ("A3C", 4)) for sf in (1, 2, 4, 8))
    assert all(entry["null"] > 0 for entry in ours["h100"].values())


def test_payload_args_reach_the_built_step():
    """``--payload_args`` builds the payload the drivers launch: a step of
    the Transformer at the flags' widths."""
    step = port.build_step("Transformer", 2, "cpu",
                           "--vocab_size 64 --d_model 32 --num_heads 2 "
                           "--num_layers 1 --seq_len 16")
    loss = step()
    assert isinstance(loss, torch.Tensor) and math.isfinite(loss.item())
    assert abs(loss.item() - math.log(64)) < 1.0


# -- the card's committed oracle (counterpart of tests/test_measured_oracle.py)

needs_oracle = pytest.mark.skipif(not ORACLE.exists(),
                                  reason="the card's oracle is not committed")


@needs_oracle
def test_committed_oracle_parses_and_is_sane():
    t = read_throughputs(str(ORACLE))
    assert t == jax_read(str(ORACLE))
    assert list(t) == ["h100"]
    isolated = {k: v["null"] for k, v in t["h100"].items()}
    assert len(isolated) >= 28
    # Every family at every batch size of the table, 4 scale factors.
    for family, sizes in _FAMILY_BATCH_SIZES.items():
        for bs in sizes:
            for sf in (1, 2, 4, 8):
                assert (f"{family} (batch size {bs})", sf) in isolated
    for key, tput in isolated.items():
        assert tput > 0 and math.isfinite(tput), key
        job_type, sf = key
        if (job_type, 2 * sf) in isolated:
            assert isolated[(job_type, 2 * sf)] > tput


@needs_oracle
@pytest.mark.parametrize("policy", ["max_min_fairness", "shockwave_tpu"])
def test_committed_oracle_drives_a_simulation(policy):
    """The port's simulator on an h100-only cluster from the card's oracle
    (an h100 has no spot price and no synthetic speed): every job
    completes, and Shockwave's planner sees partial progress."""
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.data.workload_info import steps_per_epoch
    from shockwave_tpu_torch.policies import get_policy

    oracle = read_throughputs(str(ORACLE))
    jobs = []
    for job_type in ["ResNet-18 (batch size 32)", "LM (batch size 20)",
                     "Recommendation (batch size 1024)",
                     "Transformer (batch size 64)"]:
        model = job_type.split(" (")[0]
        bs = int(job_type.rstrip(")").split("size ")[1])
        jobs.append(Job(job_type=job_type, mode="static",
                        total_steps=steps_per_epoch(model, bs) * 20))
    profiles = synthesize_profiles(jobs, oracle, worker_type="h100")
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = {"future_rounds": 10, "lambda": 5.0, "k": 10.0, "num_gpus": 2,
              "time_per_iteration": 120}
    sched = Scheduler(
        get_policy(policy, device="cpu", seed=0), throughputs=oracle, seed=0,
        time_per_iteration=120, profiles=profiles,
        shockwave_config=config if policy.startswith("shockwave") else None)
    progress = []
    if sched._shockwave is not None:
        real = sched._shockwave.set_progress

        def spy(job_id, num_epochs):
            progress.append(int(num_epochs))
            return real(job_id, num_epochs)

        sched._shockwave.set_progress = spy
    makespan = sched.simulate({"h100": 2}, [0.0] * len(jobs), jobs)
    assert makespan > 0
    assert all(t is not None for t in sched._job_completion_times.values())
    if sched._shockwave is not None:
        assert any(0 < e for e in progress), progress
