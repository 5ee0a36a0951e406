"""Marginal-price admission in the port (``whatif/pricing.py``) against the
JAX package's on the same seeded problems: the burst rows, the welfare,
the pricer's decisions and its fallbacks, lane-amortized batches (their
solves lanes of one launch of kernel A, here its plain version) and the
``price`` subcommand of the what-if CLI (tests/test_whatif.py's
TestPricing, TestLaneAmortizedPricing and TestCLI)."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from shockwave_tpu.core.job import Job as RefJob
from shockwave_tpu.solver.eg_problem import EGProblem as RefProblem
from shockwave_tpu.whatif import pricing as ref_pricing
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.solver.eg_problem import EGProblem
from shockwave_tpu_torch.tools import bench_sim
from shockwave_tpu_torch.whatif import pricing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(ROOT, "results", "flight_recorder", "decisions.jsonl")


def _fields(seed, num_jobs=10, num_gpus=4, future_rounds=8):
    rng = np.random.default_rng(seed)
    total = rng.integers(5, 40, num_jobs).astype(float)
    completed = np.floor(total * rng.uniform(0, 0.8, num_jobs))
    epoch_dur = rng.uniform(60, 900, num_jobs)
    incumbent = (rng.random(num_jobs) < 0.3).astype(np.float64)
    return dict(
        priorities=rng.uniform(0.5, 10.0, num_jobs),
        completed_epochs=completed, total_epochs=total,
        epoch_duration=epoch_dur,
        remaining_runtime=(total - completed) * epoch_dur,
        nworkers=rng.choice([1, 1, 2], num_jobs).astype(float),
        num_gpus=num_gpus, round_duration=120.0,
        future_rounds=future_rounds, regularizer=10.0,
        log_bases=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0]),
        switch_cost=rng.uniform(20.0, 60.0, num_jobs) * incumbent,
        incumbent=incumbent)


def _contended(num_jobs=6, num_gpus=2):
    """tests/test_whatif.py::contended_problem: every incumbent wants the
    whole window on a saturated fleet."""
    return dict(
        priorities=np.ones(num_jobs),
        completed_epochs=np.full(num_jobs, 2.0),
        total_epochs=np.full(num_jobs, 20.0),
        epoch_duration=np.full(num_jobs, 60.0),
        remaining_runtime=np.full(num_jobs, 18 * 60.0),
        nworkers=np.ones(num_jobs), num_gpus=num_gpus, round_duration=120.0,
        future_rounds=8, regularizer=1e-3,
        log_bases=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0]),
        switch_cost=np.zeros(num_jobs), incumbent=np.ones(num_jobs))


def _burst(job_cls, n=4, scale=2, duration=4000.0):
    return [job_cls(job_type="ResNet-18 (batch size 32)", command="x",
                    total_steps=100, scale_factor=scale, mode="static",
                    duration=duration) for _ in range(n)]


BURSTS = {
    "heavy": dict(n=6, scale=2),
    "light": dict(n=1, scale=1, duration=100.0),
    "medium": dict(n=3, scale=2),
    "window": dict(n=2, scale=1, duration=None),
}


def _provider(problem):
    holder = {"problem": problem, "keys": [], "s0": None}
    return lambda: holder


def _pricers(fields, **kwargs):
    ours = pricing.AdmissionPricer(_provider(EGProblem(**fields)),
                                   device="cpu", **kwargs)
    ref = ref_pricing.AdmissionPricer(_provider(RefProblem(**fields)),
                                      **kwargs)
    return ours, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_burst_problem_rows_are_the_reference(burst, seed):
    fields = _fields(seed)
    ours = pricing.burst_problem(EGProblem(**fields),
                                 _burst(Job, **BURSTS[burst]))
    ref = ref_pricing.burst_problem(RefProblem(**fields),
                                    _burst(RefJob, **BURSTS[burst]))
    assert ours.num_jobs == ref.num_jobs
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b)
        else:
            assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_welfare_is_the_reference(seed):
    fields = _fields(seed, num_jobs=12)
    problem = EGProblem(**fields)
    rng = np.random.default_rng(seed + 10)
    for _ in range(4):
        s = rng.uniform(0, 8, problem.num_jobs)
        rows = (rng.random(problem.num_jobs) < 0.6).astype(float)
        norm = float(rng.integers(1, 200))
        assert pricing._welfare(problem, s, rows, norm) == pytest.approx(
            ref_pricing._welfare(RefProblem(**fields), s, rows, norm),
            rel=1e-12, abs=1e-12)
    assert pricing._EPS == 1e-6


def _within(got, ref):
    return bench_sim.decision_misses(got.as_record(), ref.as_record())


@pytest.mark.parametrize("threshold", [0.0, 1e-3, float("inf")])
@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_decisions_are_the_reference(burst, threshold):
    """Each decision is the JAX package's: the same action and reason,
    the welfare delta within kernel A's limit."""
    ours, ref = _pricers(_contended(), threshold=threshold, budget_s=600.0)
    got = ours.price(_burst(Job, **BURSTS[burst]))
    want = ref.price(_burst(RefJob, **BURSTS[burst]))
    assert _within(got, want) == []
    if threshold == 0.0 and burst == "heavy":
        assert got.action == "reject" and got.welfare_delta < 0


def test_budget_overrun_falls_back_and_opens_the_circuit():
    calls = {"n": 0}
    holder = {"problem": EGProblem(**_contended()), "s0": None}

    def provider():
        calls["n"] += 1
        return holder

    pricer = pricing.AdmissionPricer(provider, threshold=0.0, budget_s=0.0,
                                     device="cpu")
    for _ in range(pricing._CIRCUIT_OPEN_AFTER):
        decision = pricer.price(_burst(Job))
        assert (decision.action, decision.reason) == (
            "fallback", "budget_exceeded")
        assert decision.welfare_delta is not None
    before = calls["n"]
    decisions = [pricer.price(_burst(Job))
                 for _ in range(pricing._CIRCUIT_PROBE_EVERY)]
    assert all(d.action == "fallback" for d in decisions)
    assert any(d.reason == "circuit_open" for d in decisions)
    assert calls["n"] - before <= 1
    assert (pricing._CIRCUIT_OPEN_AFTER, pricing._CIRCUIT_PROBE_EVERY) == (
        ref_pricing._CIRCUIT_OPEN_AFTER, ref_pricing._CIRCUIT_PROBE_EVERY)


def test_fallbacks_are_the_reference():
    def boom():
        raise RuntimeError("planner exploded")

    for provider, jobs, reason in (
            (lambda: None, _burst(Job), "no_planner_state"),
            (boom, _burst(Job), "error:RuntimeError"),
            (_provider(EGProblem(**_contended())), [], "empty_batch")):
        decision = pricing.AdmissionPricer(provider, device="cpu").price(
            jobs)
        assert (decision.action, decision.reason) == ("fallback", reason)
    assert pricing.DEFAULT_PRICING_THRESHOLD == (
        ref_pricing.DEFAULT_PRICING_THRESHOLD)
    assert pricing.DEFAULT_PRICING_BUDGET_S == (
        ref_pricing.DEFAULT_PRICING_BUDGET_S)
    assert pricing.DEFAULT_PRICING_MAX_CYCLES == (
        ref_pricing.DEFAULT_PRICING_MAX_CYCLES)


def _bursts(job_cls):
    return [_burst(job_cls, **BURSTS[name]) for name in
            ("heavy", "light", "medium")]


def test_single_burst_batches_are_bit_identical_to_price():
    """A one-burst batch prices the problem ``price`` prices, in the same
    two lanes: its delta and verdict are the same bits."""
    problem = EGProblem(**_contended())
    for jobs in _bursts(Job):
        lane = pricing.AdmissionPricer(
            _provider(problem), threshold=0.0, budget_s=600.0,
            device="cpu").price_batch([jobs])[0]
        alone = pricing.AdmissionPricer(
            _provider(problem), threshold=0.0, budget_s=600.0,
            device="cpu").price(jobs)
        assert lane.as_record() == dict(alone.as_record(),
                                        solve_s=lane.as_record()["solve_s"])
        assert lane.welfare_delta == alone.welfare_delta
        assert lane.burst_welfare == alone.burst_welfare


def test_batch_verdicts_and_lanes_are_the_reference():
    """Co-batched bursts get the sequential verdicts and the JAX package's
    batch decisions; every lane of the launch equals its one-lane
    launch."""
    ours, ref = _pricers(_contended(), threshold=0.0, budget_s=600.0)
    batched = ours.price_batch(_bursts(Job), audit=True)
    ref_batched = ref.price_batch(_bursts(RefJob))
    sequential = [ours.price(jobs) for jobs in _bursts(Job)]
    assert [d.action for d in batched] == [d.action for d in sequential]
    assert all(_within(a, b) == [] for a, b in zip(batched, ref_batched))
    assert all(d.welfare_delta < 0 for d in batched)
    assert ours.last_batch_audit["audited"] == 4
    assert ours.last_batch_audit["bit_identical"] is True


def test_batch_budget_empty_and_error_lanes():
    pricer = pricing.AdmissionPricer(_provider(EGProblem(**_contended())),
                                     threshold=0.0, budget_s=0.0,
                                     device="cpu")
    decisions = pricer.price_batch(_bursts(Job))
    assert all(d.reason == "budget_exceeded" for d in decisions)
    assert all(d.welfare_delta is not None for d in decisions)
    assert pricer._consecutive_overruns == 1
    pricer = pricing.AdmissionPricer(_provider(EGProblem(**_contended())),
                                     threshold=0.0, budget_s=600.0,
                                     device="cpu")
    decisions = pricer.price_batch([[], _burst(Job, n=1)])
    assert (decisions[0].action, decisions[0].reason) == (
        "fallback", "empty_batch")
    assert decisions[1].action in ("accept", "reject")
    assert pricer.price_batch([]) == []

    def boom():
        raise RuntimeError("planner exploded")

    failed = pricing.AdmissionPricer(boom, device="cpu").price_batch(
        _bursts(Job))
    assert all(d.reason == "error:RuntimeError" for d in failed)


def test_collector_convoys_concurrent_price_calls():
    class Counting:
        def __init__(self):
            self.dispatches = []

        def price_batch(self, bursts, audit=False):
            if not self.dispatches:
                time.sleep(0.1)
            self.dispatches.append(len(bursts))
            return [pricing.PricingDecision(
                action="accept", reason="priced",
                welfare_delta=float(len(jobs))) for jobs in bursts]

    inner = Counting()
    collector = pricing.PricingCollector(inner, max_lanes=32)
    results = {}
    barrier = threading.Barrier(8)

    def worker(k):
        barrier.wait()
        results[k] = collector.price(_burst(Job, n=k + 1))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(results[k].welfare_delta == float(k + 1) for k in range(8))
    assert sum(inner.dispatches) == 8 and len(inner.dispatches) < 8
    assert collector.price(_burst(Job, n=2)).welfare_delta == 2.0
    assert inner.dispatches[-1] == 1


def test_price_cli_on_the_committed_log_is_the_reference(tmp_path):
    """``tools.whatif price`` on round 91 of the committed decision log
    with tests/test_whatif.py's burst: the JAX package's decision
    (``bench_sim.PRICING["log"]``), quota-only accepting."""
    from shockwave_tpu_torch.tools import whatif as cli

    out = str(tmp_path / "price.json")
    b = bench_sim.PRICING_LOG_BURST
    assert cli.main(["price", "--log", LOG, "--round",
                     str(bench_sim.PRICING_LOG_ROUND), "--burst-jobs",
                     str(b["jobs"]), "--burst-scale", str(b["scale"]),
                     "--burst-duration", str(b["duration"]), "--device",
                     "cpu", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert bench_sim.decision_misses(report["priced_decision"],
                                     bench_sim.PRICING["log"]) == []
    assert report["quota_only_decision"] == "accept"
    assert report["base"]["jobs"] == 12 and report["round"] == 91
