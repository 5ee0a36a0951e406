"""The port's sharded level solve against the JAX package's, on the CPU.

Every case of tests/test_sharded_solver.py but the slow 16384-job one:
the port's counts, from a one-process solve mesh that holds the CPU in P
places, equal in every bit the JAX package's one-device
``solve_level_counts`` (and in one case its ``solve_level_sharded`` on
the 8-device host mesh the conftest gives JAX); objectives within 1e-5
relative. Then the backend: ``shockwave_tpu_sharded`` against
``shockwave_tpu_level`` in both packages, and the ``tpu`` dispatch to
the sharded solve with the threshold lowered and several devices visible.
"""

import os

import numpy as np
import pytest
import torch

import bench
from shockwave_tpu.solver import eg_jax, eg_sharded as ref_sharded
from shockwave_tpu.solver.eg_problem import EGProblem
from shockwave_tpu_torch.parallel import mesh as meshes
from shockwave_tpu_torch.policies import get_available_policies, get_policy
from shockwave_tpu_torch.policies import shockwave
from shockwave_tpu_torch.policies.shockwave import ShockwavePlanner
from shockwave_tpu_torch.solver import eg_level, eg_sharded
from test_torch_solver import port_problem

PLACES = (1, 2, 4, 8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps them
    from oversubscribing the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(places: int):
    return meshes.make_solve_mesh([CPU] * places)


def sharded_counts(problem: EGProblem, places: int = 8):
    return eg_sharded.solve_level_sharded(
        port_problem(problem), mesh=cpu_mesh(places), device="cpu")


@pytest.mark.parametrize(
    "num_jobs,future_rounds,num_gpus,seed",
    [(100, 20, 64, 0), (256, 16, 48, 1), (100, 20, 64, 5)],
)
def test_counts_match_single_device(num_jobs, future_rounds, num_gpus, seed):
    p = bench.make_problem(num_jobs=num_jobs, future_rounds=future_rounds,
                           num_gpus=num_gpus, seed=seed)
    c_ref, obj_ref = eg_jax.solve_level_counts(p)
    c_port, _ = eg_level.solve_level_counts(port_problem(p), "cpu")
    np.testing.assert_array_equal(c_port, c_ref)
    for places in PLACES:
        c_sh, obj_sh = sharded_counts(p, places)
        np.testing.assert_array_equal(c_sh, c_ref)
        assert obj_sh == pytest.approx(obj_ref, rel=1e-5)


def test_counts_match_the_jax_sharded_solve():
    """The JAX package's own sharded solve, on its 8-device host mesh."""
    import jax

    assert len(jax.devices()) == 8
    p = bench.make_problem(num_jobs=100, future_rounds=20, num_gpus=64,
                           seed=0)
    c_ref, obj_ref = ref_sharded.solve_level_sharded(p)
    c_sh, obj_sh = sharded_counts(p, 8)
    np.testing.assert_array_equal(c_sh, c_ref)
    assert obj_sh == pytest.approx(obj_ref, rel=1e-5)


def tie_heavy_problem(J: int = 512) -> EGProblem:
    """All jobs identical: every marginal density ties
    (tests/test_sharded_solver.py:41-67)."""
    return EGProblem(
        priorities=np.full(J, 2.0),
        completed_epochs=np.full(J, 3.0),
        total_epochs=np.full(J, 10.0),
        epoch_duration=np.full(J, 100.0),
        remaining_runtime=np.full(J, 700.0),
        nworkers=np.full(J, 2.0),
        num_gpus=64,
        round_duration=120.0,
        future_rounds=10,
        regularizer=1.0,
        log_bases=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0]),
    )


@pytest.mark.parametrize("places", PLACES)
def test_tie_heavy_identical_jobs(places):
    """The cross-shard tie split reproduces the one-device flat-index
    prefix, and wastes no budget past one gang width."""
    p = tie_heavy_problem()
    c_ref, _ = eg_jax.solve_level_counts(p)
    c_sh, _ = sharded_counts(p, places)
    np.testing.assert_array_equal(c_sh, c_ref)
    used = float(np.sum(c_sh * p.nworkers))
    budget = float(p.num_gpus * p.future_rounds)
    assert used <= budget + 1e-6
    assert used > budget - 2.0 * np.max(p.nworkers)


def test_mesh_sizes_agree():
    """Same counts from 1-, 2-, 4- and 8-place meshes (one place is the
    collectives' degenerate case)."""
    p = bench.make_problem(num_jobs=200, future_rounds=15, num_gpus=64,
                           seed=2)
    counts = [sharded_counts(p, places)[0] for places in PLACES]
    for c in counts[1:]:
        np.testing.assert_array_equal(c, counts[0])
    np.testing.assert_array_equal(counts[0],
                                  eg_jax.solve_level_counts(p)[0])


@pytest.mark.parametrize("devices", [
    ["cpu", "cpu:0"],
    ["cpu", "cpu:0", "cpu", "cpu:0"],
    ["cpu:0", "cpu:0", "cpu:0", "cpu", "cpu", "cpu", "cpu", "cpu"],
], ids=["two", "alternating", "blocks"])
def test_places_on_distinct_devices_agree(devices):
    """Places on two device objects (``cpu`` and ``cpu:0``) form two
    groups, so the collectives go across groups in shard order, as they
    would across cards."""
    p = bench.make_problem(num_jobs=200, future_rounds=15, num_gpus=64,
                           seed=2)
    shards = eg_sharded._Shards([torch.device(d) for d in devices])
    assert len(shards.groups) == 2
    c_sh, obj_sh = eg_sharded.solve_level_sharded(
        port_problem(p), mesh=meshes.make_solve_mesh(devices), device="cpu")
    c_ref, obj_ref = eg_jax.solve_level_counts(p)
    np.testing.assert_array_equal(c_sh, c_ref)
    assert obj_sh == pytest.approx(obj_ref, rel=1e-5)


@pytest.mark.parametrize("places", [2, 8])
def test_no_sort_sees_more_than_one_shard(places, monkeypatch):
    """Every sort of the sharded solve sees at most ``slots / P x R``
    cells along its sorted dimension."""
    p = bench.make_problem(num_jobs=200, future_rounds=15, num_gpus=64,
                           seed=2)
    slots = eg_level.num_slots_for(p.num_jobs)
    widest = []
    for owner, name in ((torch, "argsort"), (torch, "sort"),
                        (torch, "msort"), (torch, "topk"),
                        (torch.Tensor, "argsort"), (torch.Tensor, "sort"),
                        (torch.Tensor, "msort"), (torch.Tensor, "topk")):
        real = getattr(owner, name)

        def spy(x, *args, _real=real, **kwargs):
            dim = kwargs.get("dim", args[0] if args and isinstance(
                args[0], int) and _real.__name__ not in ("topk",) else -1)
            widest.append(x.shape[dim] if x.dim() else 1)
            return _real(x, *args, **kwargs)

        monkeypatch.setattr(owner, name, spy)
    c_sh, _ = sharded_counts(p, places)
    monkeypatch.undo()
    assert widest, "the sharded solve sorted nothing"
    assert max(widest) <= slots // places * p.future_rounds
    np.testing.assert_array_equal(c_sh, eg_jax.solve_level_counts(p)[0])


def test_end_to_end_schedule_matches_single_device():
    """``solve_eg_level_sharded`` shares the one-device host tail, so
    equal counts give the same schedule as the JAX package's sharded and
    one-device solves."""
    p = bench.make_problem(num_jobs=128, future_rounds=12, num_gpus=32,
                           seed=4)
    Y_ref = ref_sharded.solve_eg_level_sharded(p)
    np.testing.assert_array_equal(Y_ref, eg_jax.solve_eg_level(p))
    Y = eg_sharded.solve_eg_level_sharded(port_problem(p), mesh=cpu_mesh(8),
                                          device="cpu")
    np.testing.assert_array_equal(Y, Y_ref)
    assert Y.shape == (p.num_jobs, p.future_rounds)
    per_round = (Y * p.nworkers[:, None]).sum(axis=0)
    assert (per_round <= p.num_gpus + 1e-6).all()


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_degenerate_problems_match_single_device(seed):
    """tests/test_sharded_solver.py's fuzz: gangs wider than the cluster,
    finished jobs and fully duplicated rows whose densities tie across
    shards; counts equal in every bit to the one-device solve."""
    rng = np.random.default_rng(100 + seed)
    J = int(rng.integers(70, 128))
    priorities = rng.uniform(0.1, 40.0, J)
    total = rng.integers(1, 60, J).astype(float)
    completed = np.floor(total * rng.uniform(0, 1.0, J))
    done = rng.random(J) < 0.15
    completed[done] = total[done]
    epoch_dur = rng.uniform(30, 3000, J)
    nworkers = rng.choice(
        [1, 2, 4, 8, 64], J, p=[0.5, 0.2, 0.15, 0.1, 0.05]
    ).astype(float)
    num_gpus = int(rng.integers(8, 48))
    dup = int(rng.integers(0, J - 20))
    block = slice(dup, dup + 10)
    for arr in (priorities, total, completed, epoch_dur, nworkers):
        arr[block] = arr[dup]
    p = EGProblem(
        priorities=priorities,
        completed_epochs=completed,
        total_epochs=total,
        epoch_duration=epoch_dur,
        remaining_runtime=(total - completed) * epoch_dur,
        nworkers=nworkers,
        num_gpus=num_gpus,
        round_duration=120.0,
        future_rounds=int(rng.choice([10, 20])),
        regularizer=float(rng.choice([0.0, 10.0])),
        log_bases=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0]),
    )
    c_ref, obj_ref = eg_jax.solve_level_counts(p)
    for places in (2, 8):
        c_sh, obj_sh = sharded_counts(p, places)
        np.testing.assert_array_equal(c_sh, c_ref)
        assert obj_sh == pytest.approx(obj_ref, rel=1e-5, abs=1e-6)
        assert not np.any(c_sh[p.nworkers > p.num_gpus] > 0)


def _tiny_run(package: str, policy_name: str):
    """tests/test_sharded_solver.py's five-job trace on 2 GPUs, through
    the port's simulator or the JAX package's."""
    if package == "port":
        from shockwave_tpu_torch.core.job import Job
        from shockwave_tpu_torch.core.scheduler import Scheduler
        from shockwave_tpu_torch.data.default_oracle import generate_oracle
        from shockwave_tpu_torch.data.profiles import synthesize_profiles
        from shockwave_tpu_torch.data.workload_info import steps_per_epoch

        policy = get_policy(policy_name, device="cpu")
    else:
        from shockwave_tpu.core.job import Job
        from shockwave_tpu.core.scheduler import Scheduler
        from shockwave_tpu.data.default_oracle import generate_oracle
        from shockwave_tpu.data.profiles import synthesize_profiles
        from shockwave_tpu.data.workload_info import steps_per_epoch
        from shockwave_tpu.policies import get_policy as ref_get_policy

        policy = ref_get_policy(policy_name)
    jobs = [Job(job_type="ResNet-18 (batch size 32)",
                command="python3 main.py --data_dir=%s/cifar10 "
                "--batch_size 32", num_steps_arg="--num_steps",
                total_steps=steps_per_epoch("ResNet-18", 32) * 2,
                scale_factor=1, mode="static") for _ in range(5)]
    arrivals = [30.0 * i for i in range(5)]
    oracle = generate_oracle()
    sched = Scheduler(
        policy, throughputs=oracle, seed=0, time_per_iteration=120,
        profiles=synthesize_profiles(jobs, oracle),
        shockwave_config={"num_gpus": 2, "time_per_iteration": 120,
                          "future_rounds": 8, "lambda": 5.0, "k": 10.0})
    makespan = sched.simulate({"v100": 2}, arrivals, jobs)
    return makespan, {int(str(j)): t for j, t in
                      sched._job_completion_times.items()}


def test_sharded_backend_end_to_end_matches_level():
    """``shockwave_tpu_sharded`` is a selectable backend whose simulated
    metrics equal ``shockwave_tpu_level``'s, in the port and against the
    JAX package's sharded run."""
    assert "shockwave_tpu_sharded" in get_available_policies()
    assert get_policy("shockwave_tpu_sharded", device="cpu").name == (
        "Shockwave_TPU_Sharded")
    before = eg_sharded.SOLVES["cpu"]
    makespan, jcts = _tiny_run("port", "shockwave_tpu_sharded")
    assert eg_sharded.SOLVES["cpu"] > before
    level_makespan, level_jcts = _tiny_run("port", "shockwave_tpu_level")
    ref_makespan, ref_jcts = _tiny_run("jax", "shockwave_tpu_sharded")
    assert len(jcts) == 5
    assert makespan == pytest.approx(level_makespan)
    assert makespan == pytest.approx(ref_makespan)
    for job_id, jct in level_jcts.items():
        assert jcts[job_id] == pytest.approx(jct)
        assert jcts[job_id] == pytest.approx(ref_jcts[job_id])


def test_tpu_backend_auto_dispatches_to_sharded(monkeypatch):
    """At the threshold or above, with more than one device visible, the
    ``tpu`` dispatch shards the one solve before the native fast path;
    below it, never."""
    calls = []
    real = eg_sharded.solve_eg_level_sharded

    def spy(problem, *args, **kwargs):
        calls.append(problem.num_jobs)
        return real(problem, *args, **kwargs)

    monkeypatch.setattr(eg_sharded, "solve_eg_level_sharded", spy)
    monkeypatch.setattr(shockwave, "SHARDED_DISPATCH_MIN_JOBS", 8)
    monkeypatch.setattr(meshes, "visible_devices", lambda device: [CPU] * 8)
    planner = ShockwavePlanner(
        {"num_gpus": 8, "time_per_iteration": 120, "future_rounds": 6,
         "lambda": 5.0, "k": 10.0}, backend="tpu", device="cpu")
    small = port_problem(bench.make_problem(num_jobs=6, future_rounds=6,
                                            num_gpus=8))
    planner._solve(small)
    assert calls == [], "a problem below the threshold took the sharded path"

    big = port_problem(bench.make_problem(num_jobs=32, future_rounds=6,
                                          num_gpus=8))
    Y, used = planner._solve(big)
    assert calls == [32], "a fleet-scale problem bypassed the sharded path"
    assert used == "sharded"
    assert Y.shape == (32, 6)
    big.audit_schedule(np.asarray(Y))

    # One device visible: the dispatch never shards, as the JAX package
    # with one device.
    monkeypatch.setattr(meshes, "visible_devices", lambda device: [CPU])
    _, used = planner._solve(big)
    assert calls == [32] and used != "sharded"


def test_dispatch_threshold_is_the_reference_default(monkeypatch):
    from shockwave_tpu.policies import shockwave as ref_shockwave

    monkeypatch.delenv("SHOCKWAVE_SHARDED_MIN_JOBS", raising=False)
    assert shockwave.SHARDED_DISPATCH_MIN_JOBS == (
        ref_shockwave.SHARDED_DISPATCH_MIN_JOBS)
    assert shockwave.sharded_dispatch_min_jobs() == (
        ref_shockwave.sharded_dispatch_min_jobs())
    monkeypatch.setenv("SHOCKWAVE_SHARDED_MIN_JOBS", "12")
    assert shockwave.sharded_dispatch_min_jobs() == 12
    assert ref_shockwave.sharded_dispatch_min_jobs() == 12
    assert os.environ["SHOCKWAVE_SHARDED_MIN_JOBS"] == "12"


def test_default_mesh_takes_every_visible_device(monkeypatch):
    """Without a mesh the solve takes every device visible beside its
    device, each once: the CPU alone here, or what the host shows."""
    monkeypatch.setattr(meshes, "visible_devices", lambda device: [CPU] * 4)
    seen = []
    real = eg_sharded._Shards

    def spy(devices):
        seen.append(list(devices))
        return real(devices)

    monkeypatch.setattr(eg_sharded, "_Shards", spy)
    p = bench.make_problem(num_jobs=100, future_rounds=20, num_gpus=64,
                           seed=0)
    c_sh, _ = eg_sharded.solve_level_sharded(port_problem(p), device="cpu")
    assert seen == [[CPU] * 4]
    np.testing.assert_array_equal(c_sh, eg_jax.solve_level_counts(p)[0])
