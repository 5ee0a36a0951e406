"""The port's Gavel policy library against the JAX package's, on the CPU.

Each ported policy's ``get_allocation`` gets the same seeded inputs (one
worker type and three; scale factors 1, 2 and 4; priority weights that
differ) as its counterpart in the JAX package, twice in a row (the
stateful policies, FIFO and finish-time fairness, carry state from the
first call into the second), and the two allocations must be equal in
every bit. Both packages hand HiGHS the same programs, so where a program
has many optima (max-min with every throughput 1) they still return the
same vertex. The LP backends and the base machinery are held to the JAX
package's the same way. Then the single-policy contracts of
tests/test_policies.py and tests/test_simulator.py, run on the port.
"""

import random
import time

import numpy as np
import pytest

from shockwave_tpu.core.ids import JobId as RefJobId
from shockwave_tpu.policies import _ALL_POLICY_NAMES
from shockwave_tpu.policies import base as ref_base
from shockwave_tpu.policies import get_policy as ref_get_policy
from shockwave_tpu.policies import lp_backend as ref_lp
from shockwave_tpu_torch import policies
from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.core.scheduler import Scheduler
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.profiles import synthesize_profiles
from shockwave_tpu_torch.data.workload_info import steps_per_epoch
from shockwave_tpu_torch.policies import base, get_policy, lp_backend

CLUSTERS = {
    "one_type": {"v100": 8},
    "three_types": {"v100": 4, "p100": 4, "k80": 8},
}
# The arguments of each family, in the order the scheduler passes them
# (core/scheduler.py::_compute_allocation).
ARGS = {
    "fifo": ("tputs", "sf", "cluster"),
    "fifo_perf": ("tputs", "sf", "cluster"),
    "isolated": ("tputs", "sf", "cluster"),
    "max_sum_throughput_perf": ("tputs", "sf", "cluster"),
    "max_min_fairness": ("tputs", "sf", "pw", "cluster"),
    "max_min_fairness_perf": ("tputs", "sf", "pw", "cluster"),
    "max_min_fairness_water_filling": ("tputs", "sf", "pw", "cluster"),
    "max_min_fairness_water_filling_perf": ("tputs", "sf", "pw", "cluster"),
    "finish_time_fairness": ("tputs", "sf", "pw", "tss", "steps", "cluster"),
    "finish_time_fairness_perf": ("tputs", "sf", "pw", "tss", "steps",
                                  "cluster"),
    "min_total_duration": ("tputs", "sf", "steps", "cluster"),
    "min_total_duration_perf": ("tputs", "sf", "steps", "cluster"),
}


def seeded_state(seed: int, cluster: dict, num_jobs: int = 7) -> dict:
    """Seeded policy inputs keyed by integer job id (numpy draws)."""
    rng = np.random.default_rng(seed)
    types = sorted(cluster)
    return {
        "tputs": {i: {wt: float(rng.uniform(0.5, 20.0)) for wt in types}
                  for i in range(num_jobs)},
        "sf": {i: int(rng.choice([1, 2, 4])) for i in range(num_jobs)},
        "pw": {i: float(rng.choice([0.5, 1.0, 2.0, 3.0]))
               for i in range(num_jobs)},
        "tss": {i: float(rng.uniform(0.0, 5000.0)) for i in range(num_jobs)},
        "steps": {i: int(rng.integers(500, 20000)) for i in range(num_jobs)},
        "cluster": dict(cluster),
    }


def next_state(state: dict, seed: int) -> dict:
    """The state one allocation later: job 0 done, the others progressed."""
    rng = np.random.default_rng(seed + 1000)
    out = {k: ({i: v for i, v in d.items() if i != 0} if k != "cluster"
               else dict(d)) for k, d in state.items()}
    for i in out["steps"]:
        out["steps"][i] = max(1, out["steps"][i] - int(rng.integers(0, 400)))
        out["tss"][i] += 120.0
    return out


def keyed(state: dict, job_id) -> dict:
    """``state`` with its job dicts keyed by ``job_id`` (a package's JobId)."""
    return {k: (dict(d) if k == "cluster" else
                {job_id(i): v for i, v in d.items()})
            for k, d in state.items()}


def as_matrix(allocation: dict) -> np.ndarray:
    jobs = sorted(allocation, key=lambda j: j[0])
    types = sorted(allocation[jobs[0]])
    return np.array([[allocation[j][wt] for wt in types] for j in jobs])


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("name", sorted(ARGS))
def test_allocations_equal_the_reference_in_every_bit(name, cluster):
    port, ref = get_policy(name, device="cpu", seed=0), ref_get_policy(
        name, seed=0)
    assert port.name == ref.name
    state = seeded_state(3, CLUSTERS[cluster])
    for step in range(2):
        got = port.get_allocation(
            *[keyed(state, JobId)[k] for k in ARGS[name]])
        want = ref.get_allocation(
            *[keyed(state, RefJobId)[k] for k in ARGS[name]])
        assert np.array_equal(as_matrix(got), as_matrix(want)), (name, step)
        state = next_state(state, step)


def _program(seed: int, m: int = 6, n: int = 3):
    rng = np.random.default_rng(seed)
    coeffs = rng.uniform(0.1, 10.0, size=(m, n))
    sf = np.tile(rng.choice([1.0, 2.0, 4.0], size=(m, 1)), (1, n))
    num_workers = [int(w) for w in rng.integers(2, 9, size=n)]
    return coeffs, sf, num_workers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lp_backend_equals_the_reference(seed):
    coeffs, sf, num_workers = _program(seed)
    assert np.array_equal(lp_backend.max_min_lp(coeffs, sf, num_workers),
                          ref_lp.max_min_lp(coeffs, sf, num_workers))
    for scale in (0.05, 50.0):  # one feasible, one infeasible
        rates = scale * coeffs.sum(axis=1)
        got = lp_backend.feasibility_lp(rates, coeffs, sf, num_workers)
        want = ref_lp.feasibility_lp(rates, coeffs, sf, num_workers)
        assert (got is None) == (want is None) == (scale > 1)
        assert got is None or np.array_equal(got, want)
    extra = -np.eye(coeffs.size)[:2]
    rhs = np.array([-0.25, -0.25])
    assert np.array_equal(
        lp_backend.max_sum_lp(coeffs, sf, num_workers, extra, rhs),
        ref_lp.max_sum_lp(coeffs, sf, num_workers, extra, rhs))
    A, b = base.constraint_matrices(sf, num_workers)
    rows = lp_backend._per_job_rows(coeffs)
    assert np.array_equal(rows, ref_lp._per_job_rows(coeffs))
    zero_mask = np.zeros(coeffs.size, dtype=bool)
    zero_mask[::4] = True
    for got, want in (
            (lp_backend.max_min_lp_general(rows, A, b, zero_mask),
             ref_lp.max_min_lp_general(rows, A, b, zero_mask)),
            (lp_backend.max_sum_lp_general(coeffs.reshape(-1), A, b,
                                           zero_mask),
             ref_lp.max_sum_lp_general(coeffs.reshape(-1), A, b, zero_mask))):
        assert np.array_equal(got, want)
        assert np.all(got[zero_mask] == 0)


def test_base_machinery_equals_the_reference():
    _, sf, num_workers = _program(4)
    for got, want in zip(base.constraint_matrices(sf, num_workers),
                         ref_base.constraint_matrices(sf, num_workers)):
        assert np.array_equal(got, want)

    tputs = {JobId(0): {"v100": 3.0, "k80": 1.0}}
    assert base.canonical_throughputs(tputs) == {
        JobId(0): {"v100": 3.0, "k80": 3.0}}
    with pytest.raises(ValueError, match="v100"):
        base.canonical_throughputs({JobId(0): {"p100": 1.0, "k80": 2.0}})


def test_registry_covers_the_reference_vocabulary():
    ported = set(policies.get_available_policies())
    assert ported.isdisjoint(policies._NOT_PORTED)
    assert set(_ALL_POLICY_NAMES) <= ported | set(policies._NOT_PORTED)


@pytest.mark.parametrize("name", policies._NOT_PORTED)
def test_names_not_ported_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_policy(name, device="cpu")


# -- single-policy contracts (tests/test_policies.py) -----------------------

def validity(alloc, scale_factors, cluster_spec):
    """Base-polytope validity: capacity per type; each job's share <= 1."""
    per_type = {wt: 0.0 for wt in cluster_spec}
    for job_id, shares in alloc.items():
        for wt, v in shares.items():
            assert v >= -1e-6
            per_type[wt] += v * scale_factors[job_id]
        assert sum(shares.values()) <= 1.0 + 1e-4, job_id
    for wt in per_type:
        assert per_type[wt] <= cluster_spec[wt] + 1e-4, (wt, per_type[wt])


def simple_throughputs(m=3, v=4.0, k=1.0):
    return {JobId(i): {"v100": v, "k80": k} for i in range(m)}


CLUSTER = {"v100": 2, "k80": 2}


class TestFinishTimeFairness:
    def args(self, m=2):
        tputs = simple_throughputs(m)
        sf = {JobId(i): 1 for i in range(m)}
        pw = {JobId(i): 1.0 for i in range(m)}
        tss = {JobId(i): 100.0 for i in range(m)}
        steps = {JobId(i): 1000 for i in range(m)}
        return tputs, sf, pw, tss, steps, CLUSTER

    def test_identical_jobs_get_equal_allocations(self):
        pol = get_policy("finish_time_fairness_perf")
        tputs, sf, pw, tss, steps, cluster = self.args()
        alloc = pol.get_allocation(tputs, sf, pw, tss, steps, cluster)
        validity(alloc, sf, cluster)
        a0 = sum(alloc[JobId(0)].values())
        a1 = sum(alloc[JobId(1)].values())
        assert a0 == pytest.approx(a1, abs=0.05)

    def test_base_variant_uses_v100_throughputs(self):
        pol = get_policy("finish_time_fairness")
        tputs, sf, pw, tss, steps, cluster = self.args()
        alloc = pol.get_allocation(tputs, sf, pw, tss, steps, cluster)
        validity(alloc, sf, cluster)

    def test_state_accumulates_between_rounds(self):
        pol = get_policy("finish_time_fairness_perf")
        tputs, sf, pw, tss, steps, cluster = self.args()
        pol.get_allocation(tputs, sf, pw, tss, steps, cluster)
        steps2 = {j: s - 100 for j, s in steps.items()}
        pol.get_allocation(tputs, sf, pw, tss, steps2, cluster)
        assert all(v > 0 for v in pol._cumulative_isolated_time.values())


def test_min_total_duration_fast_jobs_finish_within_bound():
    pol = get_policy("min_total_duration_perf")
    tputs = simple_throughputs(2)
    sf = {JobId(i): 1 for i in range(2)}
    steps = {JobId(i): 1000 for i in range(2)}
    alloc = pol.get_allocation(tputs, sf, steps, CLUSTER)
    validity(alloc, sf, CLUSTER)
    # 2 jobs, 2 v100s at 4 steps/s: both can run flat out on a v100.
    for i in range(2):
        rate = sum(tputs[JobId(i)][wt] * alloc[JobId(i)][wt] for wt in CLUSTER)
        assert rate >= 3.0


def test_max_sum_throughput_capacity_flows_to_fastest_jobs():
    pol = get_policy("max_sum_throughput_perf")
    tputs = {
        JobId(0): {"v100": 10.0, "k80": 1.0},
        JobId(1): {"v100": 1.0, "k80": 0.5},
        JobId(2): {"v100": 1.0, "k80": 0.5},
    }
    sf = {JobId(i): 1 for i in range(3)}
    alloc = pol.get_allocation(tputs, sf, CLUSTER)
    validity(alloc, sf, CLUSTER)
    assert alloc[JobId(0)]["v100"] == pytest.approx(1.0, abs=1e-4)


class TestWaterFilling:
    def test_equal_jobs_equal_levels(self):
        pol = get_policy("max_min_fairness_water_filling_perf")
        tputs = simple_throughputs(4)
        sf = {JobId(i): 1 for i in range(4)}
        pw = {JobId(i): 1.0 for i in range(4)}
        alloc = pol.get_allocation(tputs, sf, pw, CLUSTER)
        validity(alloc, sf, CLUSTER)
        shares = [sum(alloc[JobId(i)].values()) for i in range(4)]
        assert max(shares) - min(shares) < 0.05

    def test_water_filling_improves_unsaturated_jobs(self):
        # Job 0 is held by its own share cap; the others rise above the
        # plain max-min level, to about one v100 each.
        pol = get_policy("max_min_fairness_water_filling_perf")
        tputs = {JobId(0): {"v100": 1.0}, JobId(1): {"v100": 10.0},
                 JobId(2): {"v100": 10.0}}
        sf = {JobId(i): 1 for i in range(3)}
        pw = {JobId(i): 1.0 for i in range(3)}
        cluster = {"v100": 3}
        alloc = pol.get_allocation(tputs, sf, pw, cluster)
        validity(alloc, sf, cluster)
        assert sum(alloc[JobId(1)].values()) > 0.9
        assert sum(alloc[JobId(2)].values()) > 0.9

    def test_entity_fairness_reweighting(self):
        pol = get_policy("max_min_fairness_water_filling_perf")
        pol._priority_reweighting_policies = {0: "fairness", 1: "fairness"}
        tputs = simple_throughputs(3)
        sf = {JobId(i): 1 for i in range(3)}
        pw = {JobId(i): 1.0 for i in range(3)}
        alloc = pol.get_allocation(
            tputs, sf, pw, CLUSTER, entity_weights={0: 1.0, 1: 1.0},
            entity_to_job_mapping={0: [JobId(0)], 1: [JobId(1), JobId(2)]})
        validity(alloc, sf, CLUSTER)
        # Entity 0 (one job) gets at least as much as each of entity 1's
        # two jobs.
        assert (sum(alloc[JobId(0)].values())
                >= sum(alloc[JobId(1)].values()) - 0.05)

    def test_hierarchical_mixed_policy_stress(self):
        """10 entities with mixed fifo/fairness reweighting over 300 jobs
        on a 3x64 heterogeneous cluster, with the level and saturation
        invariants and the runtime bound of tests/test_policies.py."""
        rnd = random.Random(0)
        num_entities, num_jobs = 10, 300
        worker_types = ["k80", "p100", "v100"]
        cluster = {wt: 64 for wt in worker_types}
        prp, e2j, ew, pw, tputs, sf = {}, {}, {}, {}, {}, {}
        for i in range(num_entities):
            ent = f"entity{i}"
            prp[ent] = ["fifo", "fairness"][rnd.randint(0, 1)]
            e2j[ent] = []
            ew[ent] = rnd.randint(1, 5)
        for i in range(num_jobs):
            ths = sorted(rnd.random() for _ in worker_types)
            tputs[JobId(i)] = dict(zip(worker_types, ths))
            sf[JobId(i)] = 2 ** rnd.randint(0, 2)
            ent = f"entity{rnd.randint(0, num_entities - 1)}"
            w = rnd.randint(1, 5)
            if prp[ent] == "fifo":
                w = 1.0
            pw[JobId(i)] = w
            e2j[ent].append(JobId(i))

        pol = get_policy("max_min_fairness_water_filling_perf")
        pol._priority_reweighting_policies = prp
        t0 = time.time()
        alloc = pol.get_allocation(tputs, sf, pw, cluster, entity_weights=ew,
                                   entity_to_job_mapping=e2j)
        assert time.time() - t0 < 120.0
        assert set(alloc) == set(tputs)
        validity(alloc, sf, cluster)
        # 561 workers requested, 192 there: every worker in use.
        for wt in worker_types:
            used = sum(alloc[j][wt] * sf[j] for j in alloc)
            assert used > 64 * 0.98, (wt, used)
        # Within each fifo entity the earliest job gets at least as much
        # time share as any later one.
        for ent, jobs in e2j.items():
            if prp[ent] != "fifo" or len(jobs) < 2:
                continue
            first = min(jobs)
            first_share = sum(alloc[first].values())
            for j in jobs:
                if j != first:
                    assert first_share >= sum(alloc[j].values()) - 0.05


# -- single-policy contracts (tests/test_simulator.py) ----------------------

def tiny_trace(num_jobs=4, epochs=3, arrival_gap=0.0):
    """The ResNet-18 jobs of tests/test_simulator.py::tiny_trace."""
    jobs = [Job(job_type="ResNet-18 (batch size 32)",
                command="python3 main.py --data_dir=%s/cifar10 "
                        "--batch_size 32",
                num_steps_arg="--num_steps",
                total_steps=steps_per_epoch("ResNet-18", 32) * epochs)
            for _ in range(num_jobs)]
    return jobs, [i * arrival_gap for i in range(num_jobs)]


def run_sim(policy_name, jobs, arrivals, cluster, seed=0):
    """tests/test_simulator.py::run_sim on the port."""
    oracle = generate_oracle()
    sched = Scheduler(get_policy(policy_name, device="cpu", seed=seed),
                      throughputs=oracle, seed=seed, time_per_iteration=120,
                      profiles=synthesize_profiles(jobs, oracle))
    makespan = sched.simulate(dict(cluster), list(arrivals), list(jobs))
    return sched, makespan


def test_fifo_orders_by_arrival():
    jobs, arrivals = tiny_trace(num_jobs=3, epochs=2, arrival_gap=1.0)
    sched, _ = run_sim("fifo", jobs, arrivals, cluster={"v100": 1})
    jct = sched._job_completion_times
    # With one GPU, earlier-arriving jobs finish first under FIFO.
    finish = {j: sched._per_job_start_timestamps[j] + jct[j] for j in jct}
    assert finish[JobId(0)] < finish[JobId(1)] < finish[JobId(2)]


def test_max_min_fairness_shares_cluster():
    # More jobs than GPUs: every job finishes and none starves.
    jobs, arrivals = tiny_trace(num_jobs=8, epochs=2)
    sched, _ = run_sim("max_min_fairness", jobs, arrivals, cluster={"v100": 2})
    assert len(sched._job_completion_times) == 8
    ftf_list, _ = sched.get_finish_time_fairness()
    assert len(ftf_list) == 8
    assert max(ftf_list) < 10.0


def test_isolated_allocation_matrix():
    pol = get_policy("isolated")
    throughputs = {JobId(i): {"v100": 10.0, "k80": 2.0} for i in range(4)}
    sf = {JobId(i): 1 for i in range(4)}
    alloc = pol.get_allocation(throughputs, sf, {"v100": 4, "k80": 4})
    for j in alloc:
        assert sum(alloc[j].values()) <= 1.0 + 1e-9
        for v in alloc[j].values():
            assert v >= 0


def test_max_min_lp_matches_closed_form():
    # 2 jobs, 1 worker type, equal throughputs: the fair split is 0.5 each.
    pol = get_policy("max_min_fairness_perf")
    throughputs = {JobId(0): {"v100": 4.0}, JobId(1): {"v100": 4.0}}
    sf = {JobId(0): 1, JobId(1): 1}
    pw = {JobId(0): 1.0, JobId(1): 1.0}
    alloc = pol.get_allocation(throughputs, sf, pw, {"v100": 1})
    assert alloc[JobId(0)]["v100"] == pytest.approx(0.5, abs=1e-6)
    assert alloc[JobId(1)]["v100"] == pytest.approx(0.5, abs=1e-6)


def test_scheduler_rejects_shockwave_without_config():
    with pytest.raises(ValueError, match="shockwave_config"):
        Scheduler(get_policy("shockwave_tpu", device="cpu"),
                  throughputs=generate_oracle())
    # A Gavel policy needs none.
    Scheduler(get_policy("fifo", seed=0), throughputs=generate_oracle())


def test_finish_time_fairness_matches_hand_computed_reference_math():
    """rho = JCT / (isolated duration x max(1, jobs / GPUs)), unfair when
    rho > 1.1, as tests/test_simulator.py pins it, with a job shorter than
    a round carrying the round-quantization floor."""
    sched = Scheduler(get_policy("fifo", seed=0), throughputs=generate_oracle(),
                      seed=0, time_per_iteration=120.0)
    sched.register_worker("v100", num_gpus=2)
    sched._num_jobs_in_trace = 3
    sched._job_completion_times = {JobId(0): 600.0, JobId(1): 450.0,
                                   JobId(2): 120.0}
    sched._profiles = {0: {"duration_every_epoch": [200.0, 200.0]},
                       1: {"duration_every_epoch": [300.0]},
                       2: {"duration_every_epoch": [10.0]}}
    # contention max(1, 3/2) = 1.5: rho 600/600, 450/450, 120/15.
    ftf_list, unfair_fraction = sched.get_finish_time_fairness()
    assert ftf_list == [1.0, 1.0, 8.0]
    assert unfair_fraction == pytest.approx(100.0 / 3.0)
    # At 4 GPUs the contention floor is 1 and the long jobs cross 1.1
    # with unchanged JCTs.
    sched.register_worker("v100", num_gpus=2)
    ftf_list, unfair_fraction = sched.get_finish_time_fairness()
    assert ftf_list == [1.5, 1.5, 12.0]
    assert unfair_fraction == pytest.approx(100.0)
