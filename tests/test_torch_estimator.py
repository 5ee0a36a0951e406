"""Online throughput estimation in the port
(``shockwave_tpu_torch/ops/matrix_completion.py``,
``core/throughput_estimator.py`` and the scheduler's estimation branch)
against the JAX package's on the same seeded inputs.

The JAX package starts its ALS from ``jax.random.PRNGKey(0)`` normals,
which the port cannot draw: given the JAX package's start, the port's ALS
is held to the JAX function at rtol 1e-4 and atol 1e-5; from its own
start (a ``torch.Generator`` seeded 0) it is held to the reference's
contract (tests/test_throughput_estimator.py:80-96)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.core.throughput_estimator import (
    ThroughputEstimator as RefEstimator,
)
from shockwave_tpu.data.default_oracle import generate_oracle as ref_oracle
from shockwave_tpu.ops import matrix_completion as ref_mc
from shockwave_tpu_torch.core.throughput_estimator import ThroughputEstimator
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.job_table import build_job_table
from shockwave_tpu_torch.ops import matrix_completion as mc
from shockwave_tpu_torch.tools import bench_sim

sys.path.insert(0, str(Path(__file__).resolve().parent))

WORKER_TYPES = ["k80", "p100", "v100"]


def jax_start(m: int, n: int, k: int):
    """The JAX package's ALS start: PRNGKey(0) split into two normals."""
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.normal(ku, (m, k), jnp.float32) * 0.1),
            np.asarray(jax.random.normal(kv, (n, k), jnp.float32) * 0.1))


def low_rank(seed, m, n, r, observed=0.7):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.2, 1.0, (m, r)) @ rng.uniform(0.2, 1.0, (n, r)).T / r
    mask = (rng.uniform(size=X.shape) < observed).astype(np.float32)
    return X.astype(np.float32), mask


@pytest.mark.parametrize("m, n, k, seed", [(12, 15, 3, 0), (9, 24, 8, 1),
                                           (5, 12, 4, 2), (25, 75, 10, 3)])
def test_als_from_the_reference_start_is_the_reference(m, n, k, seed):
    X, mask = low_rank(seed, m, n, min(3, k))
    ref = np.asarray(ref_mc.masked_als(jnp.asarray(X * mask),
                                       jnp.asarray(mask), k=k))
    ours = mc.masked_als(X * mask, mask, k=k, start=jax_start(m, n, k),
                         device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == (m, n)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_own_start_recovers_a_low_rank_matrix():
    """tests/test_throughput_estimator.py:81-89 on the port's start."""
    X, mask = low_rank(0, 12, 15, 3)
    est = mc.complete(X * mask, mask, k=3, device="cpu")
    assert np.abs(est - X)[mask == 0].mean() < 0.08


def test_own_start_preserves_observed_entries():
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (6, 6))
    mask = np.ones_like(X)
    mask[2, 3] = 0
    out = mc.complete(X * mask, mask, k=3, device="cpu")
    np.testing.assert_array_equal(out[mask == 1], X[mask == 1])
    assert 0.0 <= out[2, 3] <= 1.0


def test_default_start_is_seeded_and_on_the_host():
    a = mc.default_start(5, 7, 3)
    b = mc.default_start(5, 7, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (5, 3) and a[1].shape == (7, 3)
    assert a[0].device.type == "cpu" and a[0].dtype == torch.float32


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ThroughputEstimator(generate_oracle(), WORKER_TYPES,
                            [(t.model, 1) for t in build_job_table()], 4,
                            0.5, device="cuda")


def _estimators(p: float, r: int, seed: int):
    job_types = [(t.model, 1) for t in build_job_table()]
    ours = ThroughputEstimator(generate_oracle(), WORKER_TYPES, job_types,
                               r, p, seed=seed, device="cpu")
    ref = RefEstimator(ref_oracle(), WORKER_TYPES, job_types, r, p,
                       seed=seed)
    return ours, ref, job_types


@pytest.mark.parametrize("p, r, seed", [(0.2, 4, 4), (0.5, 8, 4),
                                        (0.8, 12, 7)])
def test_reference_rows_and_profiled_subsets_are_the_reference(p, r, seed):
    ours, ref, job_types = _estimators(p, r, seed)
    assert ours._reference_job_types == ref._reference_job_types
    np.testing.assert_array_equal(ours._normalized_throughputs,
                                  ref._normalized_throughputs)
    np.testing.assert_array_equal(ours._reference_throughputs,
                                  ref._reference_throughputs)
    assert ours.get_reference_throughputs() == ref.get_reference_throughputs()
    for job_type in job_types[:8]:
        assert ours._profile_job(job_type) == ref._profile_job(job_type)


def _matching(est, module, job_type, monkeypatch):
    """``est``'s match of ``job_type`` and the cosine distance of its
    completed row to each reference type's (None when fully profiled)."""
    seen = []
    real = module.complete

    def completing(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(np.asarray(out, np.float32))
        return out

    monkeypatch.setattr(module, "complete", completing)
    match = est.match_job_to_reference_job(job_type)
    monkeypatch.setattr(module, "complete", real)
    if not seen:
        return match, None
    m = seen[0]
    return match, {ref: module.cosine_distance(m[i], m[-1])
                   for i, ref in enumerate(est._reference_job_types)}


@pytest.mark.parametrize("p, r, seed", [(0.2, 4, 4), (0.5, 8, 4)])
def test_matches_from_the_reference_start_are_the_reference(
        p, r, seed, monkeypatch):
    """Given the JAX package's ALS start, each job type is matched to the
    JAX package's reference type, in the same draws, but where two
    reference types are a near-tie: there the JAX package's own distances
    to both picks lie within 2e-5 (float32 noise of the completion), and
    the port's completion is within 5e-5 of the JAX package's."""
    from shockwave_tpu.core import throughput_estimator as ref_module
    from shockwave_tpu_torch.core import throughput_estimator as module

    monkeypatch.setattr(mc, "default_start", jax_start)
    ours, ref, job_types = _estimators(p, r, seed)
    flips = 0
    for job_type in job_types:
        match, _ = _matching(ours, module, job_type, monkeypatch)
        ref_match, ref_dist = _matching(ref, ref_module, job_type,
                                        monkeypatch)
        if match != ref_match:
            flips += 1
            assert abs(ref_dist[match] - ref_dist[ref_match]) < 2e-5
    assert ours._rng.getstate() == ref._rng.getstate()
    assert flips <= 2


def test_estimation_runs_from_the_reference_start_are_the_reference(
        monkeypatch):
    """Given the JAX package's ALS start, the six sweep cells are the JAX
    package's runs (results/sim_features/jax_reference.json.gz) in every
    printed digit, match and round-log record."""
    import sim_features_reference as sim_ref

    monkeypatch.setattr(mc, "default_start", jax_start)
    ref = sim_ref.load(sim_ref.JAX_REFERENCE)["runs"]
    parted = []
    for key, args, kwargs in bench_sim.sim_feature_runs():
        if not key.startswith("estimate_p"):
            continue
        r = bench_sim.run_trace(*args, "cpu", **kwargs)
        if sim_ref.compare_run(key, r, ref[key]):
            parted.append(key)
    assert parted == []


@pytest.mark.parametrize("p, r, seed", [(0.5, 8, 4)])
def test_matches_from_the_own_start_are_reference_types(p, r, seed):
    """From the port's own start every match is one of the reference
    types, and the random draws stay in step with the JAX package's."""
    ours, ref, job_types = _estimators(p, r, seed)
    for job_type in job_types:
        match = ours.match_job_to_reference_job(job_type)
        ref.match_job_to_reference_job(job_type)
        assert match in ours._reference_job_types
    assert ours._rng.getstate() == ref._rng.getstate()


@pytest.mark.parametrize("p, r", bench_sim.ESTIMATOR_SWEEP)
def test_estimator_sweep_cells_equal_their_pins(p, r):
    """The six cells of results/estimator_sweep.json (the golden trace on
    8 v100s under max_min_fairness_packed) through the port's scheduler,
    its ALS on the CPU from its own start: the pinned metrics in their
    rounds, matches and round log (``bench_sim.check_features``)."""
    key = f"estimate_p{p}_r{r}"
    (args, kwargs), = [(a, k) for name, a, k in bench_sim.sim_feature_runs()
                       if name == key]
    result = bench_sim.run_trace(*args, "cpu", **kwargs)
    assert bench_sim.check_features(result, key) == []


def test_estimation_sees_estimates_and_runs_at_the_oracle():
    """tests/test_throughput_estimator.py's integration: under the packed
    max-min policy with estimation on, every single-GPU job is matched to
    a reference type, a pair that has not run carries the estimate (the
    matched types' co-located fractions times the jobs' own isolated
    throughputs), and a pair that ran carries the oracle's."""
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.policies import get_policy

    jobs, arrivals = bench_sim.trace_jobs(bench_sim.GOLDEN_TRACE)
    oracle = generate_oracle()
    sched = Scheduler(get_policy("max_min_fairness_packed"),
                      throughputs=oracle, seed=0, time_per_iteration=120,
                      profiling_percentage=0.5, num_reference_models=12,
                      device="cpu")
    checked = {"estimated": 0, "measured": 0}

    def keys_of(pair):
        return [sched._jobs[s].job_type_key() for s in pair.singletons()]

    real_update = sched._update_throughput

    def updating(job_id, worker_type, steps, times):
        real_update(job_id, worker_type, steps, times)
        if job_id.is_pair and all(s in sched._jobs
                                  for s in job_id.singletons()):
            keys = keys_of(job_id)
            assert sched._throughputs[job_id][worker_type] == list(
                oracle[worker_type][keys[0]][keys[1]])
            checked["measured"] += 1

    real_admit = sched.add_job

    def admitting(job, timestamp=None):
        job_id = real_admit(job, timestamp)
        for pair, per_type in sched._throughputs.items():
            if not (pair.is_pair and job_id.overlaps_with(pair)):
                continue
            a, b = pair.singletons()
            if a in sched._reference_job_map and (
                    b in sched._reference_job_map):
                refs = [sched._reference_job_map[a],
                        sched._reference_job_map[b]]
                fractions = sched._reference_throughputs["v100"][
                    refs[0]][refs[1]]
                assert per_type["v100"] == [
                    f * oracle["v100"][k]["null"]
                    for f, k in zip(fractions, keys_of(pair))]
                checked["estimated"] += 1
        return job_id

    sched._update_throughput = updating
    sched.add_job = admitting
    sched.simulate({"v100": 4}, arrivals, jobs)
    assert sched._estimate_throughputs
    assert {j.integer for j in sched._reference_job_map} == {
        i for i, job in enumerate(jobs) if job.scale_factor == 1}
    for ref_type in sched._reference_job_map.values():
        assert ref_type in sched._throughput_estimator._reference_job_types
    assert checked["estimated"] > 0 and checked["measured"] > 0
