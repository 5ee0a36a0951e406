"""The port's Gavel policy library against the JAX package's, on the CPU.

Each ported policy's ``get_allocation`` gets the same seeded inputs (one
worker type and three; scale factors 1, 2 and 4; priority weights that
differ) as its counterpart in the JAX package, twice in a row (the
stateful policies, FIFO, finish-time fairness, Gandiva and AlloX, carry
state from the first call into the second), and the two allocations must
be equal in every bit. The packed policies get the pairs of jobs of one
scale factor with their co-located throughputs from the port's oracle
(``data/default_oracle.generate_oracle``), as the scheduler gives them;
AlloX gets single-GPU jobs; strategy-proof max-min returns its discount
factors beside the allocation, and both must be equal. Both packages hand HiGHS the same programs, so where a program
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
    "max_sum_throughput_normalized_by_cost_perf": ("tputs", "sf", "cluster"),
    "max_sum_throughput_normalized_by_cost_perf_SLOs": ("tputs", "sf",
                                                        "cluster"),
    "max_min_fairness_strategy_proof": ("tputs", "sf", "pw", "cluster"),
    "allox": ("tputs", "sf", "tss", "steps", "cluster"),
    "fifo_packed": ("tputs", "sf", "cluster"),
    "gandiva": ("tputs", "sf", "cluster"),
    "max_min_fairness_packed": ("tputs", "sf", "pw", "cluster"),
    "max_min_fairness_water_filling_packed": ("tputs", "sf", "pw",
                                              "cluster"),
    "finish_time_fairness_packed": ("tputs", "sf", "pw", "tss", "steps",
                                    "cluster"),
    "min_total_duration_packed": ("tputs", "sf", "steps", "cluster"),
    "max_sum_throughput_normalized_by_cost_packed_SLOs": ("tputs", "sf",
                                                          "cluster"),
}
# The SLO programs' keyword arguments, as the scheduler passes them.
KWARGS = {
    "max_sum_throughput_normalized_by_cost_perf_SLOs": {
        "SLOs": "slos", "num_steps_remaining": "steps"},
    "max_sum_throughput_normalized_by_cost_packed_SLOs": {
        "SLOs": "slos", "num_steps_remaining": "steps"},
}
PACKED = {name for name in ARGS if name.endswith("packed")
          or name in ("gandiva",
                      "max_sum_throughput_normalized_by_cost_packed_SLOs")}


def seeded_state(seed: int, cluster: dict, num_jobs: int = 7,
                 packed: bool = False, scale_factors=(1, 2, 4)) -> dict:
    """Seeded policy inputs keyed by integer job id, or by a pair of ids
    for the pairs (numpy draws). Packed inputs draw each job's type from
    the oracle, with its isolated throughput there and each pair of one
    scale factor with its co-located throughputs
    (``Scheduler._populate_job_combination_metadata``)."""
    rng = np.random.default_rng(seed)
    types = sorted(cluster)
    sf = {i: int(rng.choice(scale_factors)) for i in range(num_jobs)}
    if packed:
        oracle = generate_oracle()
        keys = sorted(k for k in oracle["v100"] if k[1] == 1)
        kinds = {i: keys[int(rng.integers(len(keys)))][0]
                 for i in range(num_jobs)}
        tputs = {i: {wt: oracle[wt][(kinds[i], sf[i])]["null"]
                     for wt in types} for i in range(num_jobs)}
        for i in range(num_jobs):
            for j in range(i + 1, num_jobs):
                if sf[i] == sf[j]:
                    tputs[(i, j)] = {wt: list(oracle[wt][(kinds[i], sf[i])]
                                              .get((kinds[j], sf[j]),
                                                   [0.0, 0.0]))
                                     for wt in types}
    else:
        tputs = {i: {wt: float(rng.uniform(0.5, 20.0)) for wt in types}
                 for i in range(num_jobs)}
    steps = {i: int(rng.integers(500, 20000)) for i in range(num_jobs)}
    return {
        "tputs": tputs,
        "sf": sf,
        "pw": {i: float(rng.choice([0.5, 1.0, 2.0, 3.0]))
               for i in range(num_jobs)},
        "tss": {i: float(rng.uniform(0.0, 5000.0)) for i in range(num_jobs)},
        "steps": steps,
        # A deadline for every other job, some out of reach.
        "slos": {i: float(steps[i] / rng.uniform(0.5, 15.0))
                 for i in range(0, num_jobs, 2)},
        "cluster": dict(cluster),
    }


def next_state(state: dict, seed: int) -> dict:
    """The state one allocation later: job 0 done (with its pairs), the
    others progressed."""
    rng = np.random.default_rng(seed + 1000)
    out = {k: ({i: v for i, v in d.items()
                if i != 0 and not (isinstance(i, tuple) and 0 in i)}
               if k != "cluster" else dict(d)) for k, d in state.items()}
    for i in out["steps"]:
        out["steps"][i] = max(1, out["steps"][i] - int(rng.integers(0, 400)))
        out["tss"][i] += 120.0
    return out


def keyed(state: dict, job_id) -> dict:
    """``state`` with its job dicts keyed by ``job_id`` (a package's JobId)."""
    def key(i):
        return job_id(*i) if isinstance(i, tuple) else job_id(i)

    return {k: (dict(d) if k == "cluster" else
                {key(i): v for i, v in d.items()})
            for k, d in state.items()}


def as_matrix(allocation: dict) -> np.ndarray:
    jobs = sorted(allocation, key=lambda j: tuple(j))
    types = sorted(allocation[jobs[0]])
    return np.array([[allocation[j][wt] for wt in types] for j in jobs])


def allocate(policy, name: str, state: dict, job_id):
    """``policy``'s allocation of ``state`` as a matrix (and strategy-proof
    max-min's discount factors beside it)."""
    inputs = keyed(state, job_id)
    out = policy.get_allocation(
        *[inputs[k] for k in ARGS[name]],
        **{kw: inputs[k] for kw, k in KWARGS.get(name, {}).items()})
    if isinstance(out, tuple):
        return as_matrix(out[0]), out[1]
    return as_matrix(out), None


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("name", sorted(ARGS))
def test_allocations_equal_the_reference_in_every_bit(name, cluster):
    port, ref = get_policy(name, device="cpu", seed=0), ref_get_policy(
        name, seed=0)
    assert port.name == ref.name
    state = seeded_state(3, CLUSTERS[cluster], packed=name in PACKED,
                         scale_factors=(1,) if name == "allox"
                         else (1, 2, 4))
    if name in PACKED:
        assert any(isinstance(i, tuple) for i in state["tputs"])
    for step in range(2):
        got, got_extra = allocate(port, name, state, JobId)
        want, want_extra = allocate(ref, name, state, RefJobId)
        assert np.array_equal(got, want), (name, step)
        assert np.array_equal(got_extra, want_extra), (name, step)
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

    # The packed half: combinations of singles and same-scale pairs, a
    # mixed-scale pair (zero effective scale factor), priority weights.
    state = seeded_state(5, CLUSTERS["three_types"], packed=True)
    state["tputs"][(0, 1)] = {wt: [1.5, 2.5] for wt in state["cluster"]}
    state["sf"].update({0: 1, 1: 2})
    got_in, want_in = keyed(state, JobId), keyed(state, RefJobId)
    port, ref = base.PolicyWithPacking(), ref_base.PolicyWithPacking()
    got_m, got_index = port.flatten(got_in["tputs"], state["cluster"],
                                    priority_weights=got_in["pw"])
    want_m, want_index = ref.flatten(want_in["tputs"], state["cluster"],
                                     priority_weights=want_in["pw"])
    assert np.array_equal(got_m, want_m)
    assert port._num_workers == ref._num_workers
    job_ids, singles, types, relevant = got_index
    assert [tuple(j) for j in job_ids] == [tuple(j) for j in want_index[0]]
    assert [tuple(j) for j in singles] == [tuple(j) for j in want_index[1]]
    assert types == want_index[2]
    assert {s.integer: v for s, v in relevant.items()} == {
        s.integer: v for s, v in want_index[3].items()}
    C, W = len(job_ids), len(types)
    got_sf = port.scale_factors_array(got_in["sf"], job_ids, C, W)
    want_sf = ref.scale_factors_array(want_in["sf"], want_index[0], C, W)
    assert np.array_equal(got_sf, want_sf)
    assert not got_sf[[tuple(j) for j in job_ids].index((0, 1))].any()
    for got, want in zip(
            base.packed_constraint_matrices(got_sf, port._num_workers,
                                            singles, relevant),
            ref_base.packed_constraint_matrices(want_sf, ref._num_workers,
                                                want_index[1],
                                                want_index[3])):
        assert np.array_equal(got, want)
    x = np.random.default_rng(0).random((C, W))
    assert {tuple(j): v for j, v in port.unflatten(x, got_index).items()} == {
        tuple(j): v for j, v in ref.unflatten(x, want_index).items()}
    assert JobId(4, 2).as_tuple() == RefJobId(4, 2).as_tuple() == (2, 4)


def test_fifo_packing_mode_equals_the_reference():
    """FIFO's packing mode (``fifo_packed``) over four calls as jobs come
    and go: queued jobs pair with running ones where the pair's
    normalized throughput beats the threshold, a pair whose member leaves
    frees its partner, and every allocation equals the JAX package's."""
    rng = np.random.default_rng(11)
    tputs = {i: {"v100": float(rng.uniform(2.0, 6.0))} for i in range(6)}
    for i in range(6):
        for j in range(i + 1, 6):
            tputs[(i, j)] = {"v100": [float(tputs[i]["v100"] * f) for f in
                                      rng.uniform(0.55, 1.0, 2)]}
    state = {"tputs": tputs, "sf": {i: 1 for i in range(6)},
             "cluster": {"v100": 2}}
    port = get_policy("fifo_packed", device="cpu")
    ref = ref_get_policy("fifo_packed")
    packed_calls = 0
    for step in range(4):
        got = port.get_allocation(*[keyed(state, JobId)[k]
                                    for k in ARGS["fifo_packed"]])
        want = ref.get_allocation(*[keyed(state, RefJobId)[k]
                                    for k in ARGS["fifo_packed"]])
        assert np.array_equal(as_matrix(got), as_matrix(want)), step
        packed_calls += any(j.is_pair and v["v100"] == 1.0
                            for j, v in got.items())
        # The oldest job finishes: it and its pairs leave.
        gone = min(i for i in state["tputs"] if not isinstance(i, tuple))
        state["tputs"] = {i: v for i, v in state["tputs"].items()
                          if i != gone and not (isinstance(i, tuple)
                                                and gone in i)}
        state["sf"].pop(gone)
    assert packed_calls >= 2


def test_registry_covers_the_reference_vocabulary():
    ported = set(policies.get_available_policies())
    assert set(_ALL_POLICY_NAMES) <= ported
    allox = get_policy("allox_alpha=0.5")
    assert allox.name == ref_get_policy("allox_alpha=0.5").name
    assert allox._alpha == 0.5


def test_the_sharded_policy_is_the_references():
    """``shockwave_tpu_sharded``, the last name of the JAX package's
    vocabulary to be ported, builds the sharded backend under the
    reference's name."""
    policy = get_policy("shockwave_tpu_sharded", device="cpu")
    assert policy.name == ref_get_policy("shockwave_tpu_sharded").name
    assert policy.backend == "sharded"


# -- single-policy contracts (tests/test_policies.py) -----------------------

def validity(alloc, scale_factors, cluster_spec):
    """Base-polytope validity: capacity per type; each single job's share
    (over every combination it is in) <= 1."""
    per_type = {wt: 0.0 for wt in cluster_spec}
    per_single = {}
    for job_id, shares in alloc.items():
        sf = max(scale_factors[s] for s in job_id.singletons())
        for wt, v in shares.items():
            assert v >= -1e-6
            per_type[wt] += v * sf
        for s in job_id.singletons():
            per_single[s] = per_single.get(s, 0.0) + sum(shares.values())
    for wt in per_type:
        assert per_type[wt] <= cluster_spec[wt] + 1e-4, (wt, per_type[wt])
    for s, total in per_single.items():
        assert total <= 1.0 + 1e-4, (s, total)


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


class TestPackedPolicies:
    """tests/test_policies.py's packed variants, Gandiva and the packed
    max-min contracts (:60, :97, :187, :330, :354) on the port."""

    @staticmethod
    def two_jobs_and_their_pair():
        tputs = simple_throughputs(2)
        tputs[JobId(0, 1)] = {"v100": [2.5, 2.5], "k80": [0.6, 0.6]}
        sf = {JobId(i): 1 for i in range(2)}
        return tputs, sf

    def test_finish_time_fairness_packed_is_valid(self):
        tputs, sf = self.two_jobs_and_their_pair()
        pw = {JobId(i): 1.0 for i in range(2)}
        tss = {JobId(i): 100.0 for i in range(2)}
        steps = {JobId(i): 1000 for i in range(2)}
        alloc = get_policy("finish_time_fairness_packed").get_allocation(
            tputs, sf, pw, tss, steps, CLUSTER)
        validity(alloc, sf, CLUSTER)

    def test_min_total_duration_packed_is_valid(self):
        tputs, sf = self.two_jobs_and_their_pair()
        steps = {JobId(i): 1000 for i in range(2)}
        alloc = get_policy("min_total_duration_packed").get_allocation(
            tputs, sf, steps, CLUSTER)
        validity(alloc, sf, CLUSTER)

    def test_water_filling_packed_is_valid(self):
        tputs, sf = self.two_jobs_and_their_pair()
        pw = {JobId(i): 1.0 for i in range(2)}
        alloc = get_policy(
            "max_min_fairness_water_filling_packed").get_allocation(
            tputs, sf, pw, CLUSTER)
        validity(alloc, sf, CLUSTER)

    def test_gandiva_undersubscribed_does_not_pack(self):
        tputs = simple_throughputs(2)
        tputs[JobId(0, 1)] = {"v100": [2.0, 2.0], "k80": [0.5, 0.5]}
        sf = {JobId(i): 1 for i in range(2)}
        alloc = get_policy("gandiva", seed=0).get_allocation(tputs, sf,
                                                             CLUSTER)
        validity(alloc, sf, CLUSTER)
        assert sum(alloc[JobId(0, 1)].values()) == 0.0

    def test_gandiva_oversubscribed_packs_jobs(self):
        m = 6
        tputs = simple_throughputs(m)
        for i in range(m):
            for j in range(i + 1, m):
                tputs[JobId(i, j)] = {"v100": [3.0, 3.0], "k80": [0.8, 0.8]}
        sf = {JobId(i): 1 for i in range(m)}
        alloc = get_policy("gandiva", seed=0).get_allocation(tputs, sf,
                                                             CLUSTER)
        validity(alloc, sf, CLUSTER)
        assert sum(sum(alloc[j].values()) for j in alloc if j.is_pair) > 0.0

    def test_max_min_packed_uses_beneficial_packing(self):
        m = 4
        tputs = {JobId(i): {"v100": 4.0} for i in range(m)}
        for i in range(m):
            for j in range(i + 1, m):
                # Packing is nearly free: each gets 90% of isolated.
                tputs[JobId(i, j)] = {"v100": [3.6, 3.6]}
        sf = {JobId(i): 1 for i in range(m)}
        pw = {JobId(i): 1.0 for i in range(m)}
        cluster = {"v100": 2}
        alloc = get_policy("max_min_fairness_packed").get_allocation(
            tputs, sf, pw, cluster)
        validity(alloc, sf, cluster)
        assert sum(sum(alloc[j].values()) for j in alloc if j.is_pair) > 0.5

    def test_max_min_packed_agrees_with_unpacked_when_packing_is_useless(
            self):
        m = 3
        tputs_plain = {JobId(i): {"v100": 4.0} for i in range(m)}
        tputs = dict(tputs_plain)
        for i in range(m):
            for j in range(i + 1, m):
                tputs[JobId(i, j)] = {"v100": [0.0, 0.0]}
        sf = {JobId(i): 1 for i in range(m)}
        pw = {JobId(i): 1.0 for i in range(m)}
        cluster = {"v100": 2}
        packed = get_policy("max_min_fairness_packed").get_allocation(
            tputs, sf, pw, cluster)
        plain = get_policy("max_min_fairness_perf").get_allocation(
            tputs_plain, sf, pw, cluster)
        validity(packed, sf, cluster)
        for i in range(m):
            assert sum(packed[JobId(i)].values()) == pytest.approx(
                sum(plain[JobId(i)].values()), abs=0.05)


class TestAlloxAndStrategyProof:
    """tests/test_policies.py's AlloX (:154) and strategy-proof (:340)
    contracts on the port."""

    def test_allox_assigns_jobs_to_their_best_workers(self):
        tputs = {JobId(0): {"v100": 10.0, "k80": 1.0},
                 JobId(1): {"v100": 10.0, "k80": 5.0}}
        sf = {JobId(i): 1 for i in range(2)}
        tss = {JobId(0): 200.0, JobId(1): 100.0}
        steps = {JobId(i): 1000 for i in range(2)}
        cluster = {"v100": 1, "k80": 1}
        alloc = get_policy("allox").get_allocation(tputs, sf, tss, steps,
                                                   cluster)
        validity(alloc, sf, cluster)
        assert sum(1 for j in alloc if sum(alloc[j].values()) > 0.99) == 2
        # Job 1 gains 5x on a k80 against job 0's 1x: job 0 takes the v100.
        assert alloc[JobId(0)]["v100"] == 1.0
        assert alloc[JobId(1)]["k80"] == 1.0

    def test_allox_rejects_multi_gpu_jobs(self):
        with pytest.raises(ValueError, match="scale factor 1"):
            get_policy("allox").get_allocation(
                {JobId(0): {"v100": 1.0}}, {JobId(0): 2}, {JobId(0): 0.0},
                {JobId(0): 100}, {"v100": 2})

    def test_strategy_proof_returns_allocation_and_discounts(self):
        tputs = simple_throughputs(3)
        sf = {JobId(i): 1 for i in range(3)}
        pw = {JobId(i): 1.0 for i in range(3)}
        alloc, discounts = get_policy(
            "max_min_fairness_strategy_proof").get_allocation(
            tputs, sf, pw, CLUSTER)
        validity(alloc, sf, CLUSTER)
        assert len(discounts) == 3
        # Identical jobs, identical discounts, about <= 1.
        assert np.allclose(discounts, discounts[0], rtol=0.05)
        assert np.all(discounts <= 1.05)

    def test_strategy_proof_names_a_leave_one_out_without_allocation(self):
        """One job alone: its leave-one-out sub-problem has no jobs, so no
        allocation. The port raises naming it; the JAX package fails on
        the missing result (an AttributeError)."""
        args = ({0: {"v100": 4.0}}, {0: 1}, {0: 1.0}, {"v100": 2})
        with pytest.raises(RuntimeError, match="without job 0"):
            get_policy("max_min_fairness_strategy_proof").get_allocation(
                *[{JobId(k): v for k, v in a.items()} if i < 3 else a
                  for i, a in enumerate(args)])
        with pytest.raises(AttributeError):
            ref_get_policy("max_min_fairness_strategy_proof").get_allocation(
                *[{RefJobId(k): v for k, v in a.items()} if i < 3 else a
                  for i, a in enumerate(args)])


class TestSLOs:
    """tests/test_policies.py's throughput-sum SLO contracts (:107-151,
    :394-475) on the port."""

    def test_slo_constraint_reserves_rate(self):
        tputs = {JobId(0): {"v100": 10.0, "k80": 1.0},
                 JobId(1): {"v100": 1.0, "k80": 0.5}}
        sf = {JobId(i): 1 for i in range(2)}
        cluster = {"v100": 1, "k80": 0}
        alloc = get_policy(
            "max_sum_throughput_normalized_by_cost_perf_SLOs").get_allocation(
            tputs, sf, cluster, SLOs={JobId(1): 2000.0},
            num_steps_remaining={JobId(0): 1000, JobId(1): 1000})
        validity(alloc, sf, cluster)
        # 1000 steps in 2000 s: rate 0.5, half the v100.
        assert alloc[JobId(1)]["v100"] >= 0.5 - 1e-4

    def test_infeasible_slos_are_dropped(self):
        alloc = get_policy(
            "max_sum_throughput_normalized_by_cost_perf_SLOs").get_allocation(
            {JobId(0): {"v100": 1.0}}, {JobId(0): 1}, {"v100": 1},
            SLOs={JobId(0): 1.0}, num_steps_remaining={JobId(0): 10**6})
        assert alloc is not None

    def test_pruning_keeps_meetable_deadlines_enforceable(self):
        pol = get_policy("max_sum_throughput_normalized_by_cost_perf_SLOs")
        tputs = {0: {"v100": 10.0}, 1: {"v100": 1.0}}
        sf = {0: 1, 1: 1}
        cluster = {"v100": 1}
        assert pol.get_allocation(tputs, sf, cluster)[1]["v100"] < 1e-6
        a = pol.get_allocation(tputs, sf, cluster, SLOs={1: 100.0},
                               num_steps_remaining={1: 80.0})
        assert a[1]["v100"] >= 0.8 - 1e-6
        # A doomed job must not drop job 1's constraint.
        tputs[2] = {"v100": 1.0}
        sf[2] = 1
        a = pol.get_allocation(tputs, sf, cluster, SLOs={1: 100.0, 2: 1.0},
                               num_steps_remaining={1: 80.0, 2: 1e9})
        assert a[1]["v100"] >= 0.8 - 1e-6
        assert a[2]["v100"] < 1e-6

    def test_pruning_accounts_for_the_scale_factor_cap(self):
        a = get_policy(
            "max_sum_throughput_normalized_by_cost_perf_SLOs").get_allocation(
            {0: {"v100": 10.0}, 1: {"v100": 1.0}, 2: {"v100": 10.0}},
            {0: 1, 1: 1, 2: 4}, {"v100": 2}, SLOs={1: 100.0, 2: 1.0},
            num_steps_remaining={1: 80.0, 2: 8.0})
        assert a[1]["v100"] >= 0.8 - 1e-6

    def test_bound_allows_splitting_across_types(self):
        a = get_policy(
            "max_sum_throughput_normalized_by_cost_perf_SLOs").get_allocation(
            {0: {"v100": 10.0, "p100": 9.0}, 1: {"v100": 100.0, "p100": 1.0}},
            {0: 2, 1: 1}, {"v100": 1, "p100": 2}, SLOs={0: 10.0},
            num_steps_remaining={0: 93.0})
        assert 10.0 * a[0]["v100"] + 9.0 * a[0]["p100"] >= 9.3 - 1e-6, a

    def test_packed_slo_policy_runs_and_prunes(self):
        pol = get_policy("max_sum_throughput_normalized_by_cost_packed_SLOs")
        tputs = {JobId(0): {"v100": 10.0}, JobId(1): {"v100": 1.0}}
        sf = {JobId(0): 1, JobId(1): 1}
        cluster = {"v100": 1}
        assert pol.get_allocation(tputs, sf, cluster) is not None
        a = pol.get_allocation(tputs, sf, cluster,
                               SLOs={JobId(1): 100.0, JobId(0): 1.0},
                               num_steps_remaining={JobId(1): 80.0,
                                                    JobId(0): 1e9})
        assert a[JobId(1)]["v100"] >= 0.8 - 1e-6, a


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
