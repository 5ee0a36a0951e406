"""The port's relaxed projected-gradient solve (plain version of kernel B),
its analytic gradient and its entry point against the JAX package's, on
the CPU.

Inputs are the JAX package's seeded bench problems (``bench.make_problem``,
numpy seeds) and a hand-built problem with planted ties. The gradient is
held to ``jax.grad`` within 1e-6 relative (each element within 1e-6 of
itself plus 1e-6 of the largest element), at random points and where a
min or max ties. The solve is held to the reference's limits for two
summation orders (tests/test_pdhg.py:377-398): ``s`` within rtol = atol =
5e-3, the objective within 1e-3 (1 + |obj|), the rounded counts'
objective within 2e-3 (1 + |o|).

Raw PGD at 1000 jobs is the one place ``s`` falls outside 5e-3: 256 Adam
steps normalise every coordinate's step to about the step size, so a
rounding-level difference in the projection's dual (two sums in another
order) grows along the trajectory, and jobs oscillating across the kink of
the switch bonus at s = 1 end on different sides (seed 0: 93 of 1000
coordinates, by up to 0.071). The reference does the same against itself
when its start point moves by one float32 ulp
(test_reference_spreads_as_far_under_a_one_ulp_start). Its objective and
rounded objective stay inside their limits, and the entry point the
planner calls (PGD, then the PDHG polish) meets all three.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from shockwave_tpu.solver import eg_jax
from shockwave_tpu_torch.ops import eg_relaxed as kernel
from shockwave_tpu_torch.solver import eg_level, eg_relaxed
from shockwave_tpu_torch.solver.eg_problem import EGProblem
from shockwave_tpu_torch.tools import bench_sim
from test_torch_pdhg import assert_matches, rounded_objective
from test_torch_solver import port_problem

GRAD_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def packed(problem):
    slots = eg_level.num_slots_for(problem.num_jobs)
    return eg_relaxed._packed_args(port_problem(problem), slots)


def ref_raw(problem):
    """eg_jax.solve_relaxed as solve_eg_jax calls it: (s, objective)."""
    slots = eg_jax.num_slots_for(problem.num_jobs)
    pk = eg_jax.pad_problem(problem, slots)
    s, obj = eg_jax.solve_relaxed(
        pk["active"], pk["priorities"], pk["completed"], pk["total"],
        pk["epoch_dur"], pk["remaining"], pk["nworkers"], pk["num_gpus"],
        round_duration=float(problem.round_duration),
        future_rounds=int(problem.future_rounds),
        regularizer=float(problem.regularizer),
        switch_bonus=pk.get("switch_bonus"))
    return np.asarray(s)[:problem.num_jobs].astype(np.float64), float(obj)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_raw_pgd_matches_the_reference(seed):
    p = bench.make_problem(num_jobs=100, future_rounds=20, num_gpus=64,
                           seed=seed)
    ref_s, ref_obj = ref_raw(p)
    s, obj = eg_relaxed.solve_relaxed_problem(port_problem(p), device="cpu")
    assert_matches(p, s, obj, ref_s, ref_obj)


def test_raw_pgd_at_1000_jobs_matches_in_objective():
    """Raw PGD at 1000 x 50 x 256: the objective and the rounded
    objective within their limits (``s``: module docstring)."""
    p = bench.make_problem(num_jobs=1000, future_rounds=50, num_gpus=256,
                           seed=0)
    ref_s, ref_obj = ref_raw(p)
    s, obj = eg_relaxed.solve_relaxed_problem(port_problem(p), device="cpu")
    assert abs(obj - ref_obj) <= 1e-3 * (1.0 + abs(ref_obj))
    o, ref_o = rounded_objective(p, s), rounded_objective(p, ref_s)
    assert abs(o - ref_o) <= 2e-3 * (1.0 + abs(ref_o))


def _misses(s, ref_s):
    """Coordinates past the ``s`` limit (rtol = atol = 5e-3), and the
    largest |difference|."""
    d = np.abs(s - ref_s)
    return int((d > 5e-3 + 5e-3 * np.abs(ref_s)).sum()), float(d.max())


def test_reference_spreads_as_far_under_a_one_ulp_start(monkeypatch):
    """Raw PGD at 1000 x 50 x 256 (seed 0), the reference against itself:
    its start point (the first ``_project`` of ``solve_relaxed``) moved by
    one float32 ulp, up and then down, on every active job. Its own
    spread is of the size of the port's against it (CPU readings: 129 and
    95 coordinates past the ``s`` limit, by up to 0.063 and 0.071, where
    the port is 93 by up to 0.071), so the port's spread is the
    trajectory's sensitivity to rounding, not a fault of its projection
    or gradient; the module's limits stay as they are. The unjitted
    function is traced afresh, so the patch reaches the trace."""
    p = bench.make_problem(num_jobs=1000, future_rounds=50, num_gpus=256,
                           seed=0)
    slots = eg_jax.num_slots_for(p.num_jobs)
    pk = eg_jax.pad_problem(p, slots)
    args = [pk[k] for k in ("active", "priorities", "completed", "total",
                            "epoch_dur", "remaining", "nworkers",
                            "num_gpus")]
    kw = dict(round_duration=float(p.round_duration),
              future_rounds=int(p.future_rounds),
              regularizer=float(p.regularizer),
              switch_bonus=pk.get("switch_bonus"))
    ref_s, _ = ref_raw(p)
    s, _ = eg_relaxed.solve_relaxed_problem(port_problem(p), device="cpu")
    port_count, port_max = _misses(s, ref_s)
    project = eg_jax._project
    for toward in (np.inf, -np.inf):
        calls = []

        def nudged(s, weights, budget, s_max):
            out = project(s, weights, budget, s_max)
            calls.append(1)
            if len(calls) == 1:  # the start point, before the scan
                out = jnp.where(weights > 0, jnp.nextafter(
                    out, jnp.asarray(toward, out.dtype)), out)
            return out

        monkeypatch.setattr(eg_jax, "_project", nudged)
        moved = np.asarray(eg_jax.solve_relaxed.__wrapped__(*args, **kw)[0])
        monkeypatch.setattr(eg_jax, "_project", project)
        assert len(calls) == 2  # the start point and the traced step
        count, largest = _misses(moved[:p.num_jobs].astype(np.float64),
                                 ref_s)
        assert count >= port_count / 2 and largest >= port_max / 2, (
            count, largest, port_count, port_max)


@pytest.mark.parametrize("jobs, rounds, gpus, seed", [
    (100, 20, 64, 0), (1000, 50, 256, 0)])
def test_entry_point_matches_the_reference(jobs, rounds, gpus, seed):
    """solve_eg_relaxed (PGD, then the bounded PDHG polish) against
    solve_eg_jax, to the three limits."""
    from shockwave_tpu.solver import eg_pdhg as ref_pdhg

    p = bench.make_problem(num_jobs=jobs, future_rounds=rounds,
                           num_gpus=gpus, seed=seed)
    ref_s = eg_jax.solve_eg_jax(p)
    s = eg_relaxed.solve_eg_relaxed(port_problem(p), device="cpu")
    # The objective of each s, both by the reference's evaluation.
    _, obj, _ = ref_pdhg.solve_pdhg_relaxed(p, s0=s, max_cycles=0)
    _, ref_obj, _ = ref_pdhg.solve_pdhg_relaxed(p, s0=ref_s, max_cycles=0)
    assert_matches(p, s, obj, ref_s, ref_obj)


def jax_objective(host, tau):
    """eg_jax._objective bound as solve_relaxed binds it, from the port's
    packed rows (float32, the same padded problem)."""
    rows = dict(zip(eg_relaxed.ROWS, (jnp.asarray(r) for r in host[:-1])))
    scal = dict(zip(eg_relaxed.SCALARS, host[-1]))
    bonus = rows["switch_bonus"]
    return functools.partial(
        eg_jax._objective,
        active=rows["active"], priorities=rows["priorities"],
        completed=rows["completed"], total=rows["total"],
        epoch_dur=jnp.maximum(rows["epoch_dur"], eg_jax._EPS),
        remaining=rows["remaining"], num_active=jnp.sum(rows["active"]),
        round_duration=float(scal["round_duration"]),
        future_rounds=int(scal["future_rounds"]),
        regularizer=float(scal["regularizer"]),
        switch_bonus=bonus if bool(jnp.any(bonus > 0)) else None,
        tau=tau,
    )


def planted_ties():
    """Eight jobs on 120 s rounds: job 0 an incumbent with a bonus at
    s = 1, job 1 at its planned-epochs cap (3 epochs of 120 s left, s = 3),
    job 2 at zero lateness (240 s left, s = 2), job 3 past its cap, the rest
    random."""
    rng = np.random.default_rng(7)
    J = 8
    total = np.array([10.0, 5.0, 8.0, 4.0, *rng.integers(5, 30, 4)])
    completed = np.array([2.0, 2.0, 3.0, 3.0, *rng.integers(0, 4, 4)])
    epoch_dur = np.array([100.0, 120.0, 120.0, 60.0,
                          *rng.uniform(50.0, 300.0, 4)])
    remaining = (total - completed) * epoch_dur
    remaining[2] = 240.0
    p = EGProblem(
        priorities=rng.uniform(0.5, 5.0, J), completed_epochs=completed,
        total_epochs=total, epoch_duration=epoch_dur,
        remaining_runtime=remaining, nworkers=np.ones(J), num_gpus=4,
        round_duration=120.0, future_rounds=10, regularizer=1e-3,
        log_bases=bench_sim.LOG_BASES,
        switch_cost=np.array([50.0] + [0.0] * (J - 1)),
        incumbent=np.array([1.0] + [0.0] * (J - 1)))
    s = np.array([1.0, 3.0, 2.0, 5.0, *rng.uniform(0.0, 10.0, 4)])
    return p, s


def grad_cases():
    """(problem, points): random points on seeded bench problems (with
    and without a switch bonus) and the planted ties."""
    cases = []
    for seed, bonus in ((0, True), (1, False)):
        p = bench.make_problem(num_jobs=60, future_rounds=20, num_gpus=16,
                               seed=seed)
        if not bonus:
            p.switch_cost = None
        rng = np.random.default_rng(seed)
        cases.append((p, [rng.uniform(0.0, 20.0, 60) for _ in range(3)]))
    problem, s = planted_ties()
    cases.append((problem, [s]))
    return cases


@pytest.mark.parametrize("case", range(3), ids=["bonus", "no_bonus",
                                                 "planted_ties"])
@pytest.mark.parametrize("tau", [1.0, 250.0, None], ids=["tau1", "tau250",
                                                        "hard"])
def test_gradient_and_objective_match_jax(case, tau):
    """The analytic gradient against jax.grad of the reference's
    objective, and the objective itself, within 1e-6 relative. With
    ``tau`` None only the hard-max objective is compared (the reference
    takes no gradient of it)."""
    problem, points = grad_cases()[case]
    host = packed(problem)
    J = problem.num_jobs
    p = eg_relaxed._prepare(torch.from_numpy(host))
    for point in points:
        s = np.zeros(host.shape[1], np.float32)
        s[:J] = point
        s_t = torch.from_numpy(s)
        tau_t = None if tau is None else torch.tensor(tau,
                                                      dtype=torch.float32)
        f = jax_objective(host, None if tau is None else jnp.float32(tau))
        obj = float(eg_relaxed._objective(s_t, p, tau_t))
        assert obj == pytest.approx(float(f(jnp.asarray(s))), rel=1e-6)
        if tau is None:
            continue
        ref = np.asarray(jax.grad(f)(jnp.asarray(s)))
        got = eg_relaxed._grad(s_t, p, tau_t).numpy()
        np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref).max())


def test_planted_ties_split_the_gradient():
    """At each planted tie the reference's gradient takes half of each
    side, and so does the port's: compared with the same problem nudged
    off the tie, the tied element is the mean of the two sides'."""
    problem, s0 = planted_ties()
    host = packed(problem)
    p = eg_relaxed._prepare(torch.from_numpy(host))
    tau = torch.tensor(250.0)

    def grad_at(s):
        x = np.zeros(host.shape[1], np.float32)
        x[:problem.num_jobs] = s
        return eg_relaxed._grad(torch.from_numpy(x), p, tau).numpy()

    g = grad_at(s0)
    for j in (0, 1):  # the min(s, 1) tie and the planned-epochs cap
        lo, hi = s0.copy(), s0.copy()
        lo[j] = np.nextafter(np.float32(s0[j]), np.float32(-np.inf))
        hi[j] = np.nextafter(np.float32(s0[j]), np.float32(np.inf))
        assert grad_at(lo)[j] != grad_at(hi)[j]
        assert g[j] == pytest.approx(0.5 * (grad_at(lo)[j] + grad_at(hi)[j]),
                                     rel=1e-4)


def test_wrapper_on_the_cpu_is_the_plain_version():
    p = bench.make_problem(num_jobs=30, future_rounds=8, num_gpus=8, seed=2)
    pk = torch.from_numpy(packed(p))
    kernel.reset_launch_counts()
    out = kernel.relaxed(torch.stack([pk, pk]), 16)
    plain = eg_relaxed.solve_relaxed(pk, 16)
    assert out.shape == (2, pk.shape[1] + len(eg_relaxed.DIAG))
    assert torch.equal(out[0], plain) and torch.equal(out[1], plain)
    assert float(plain[-1]) == 16
    assert kernel.LAUNCHES["eg_relaxed"] == 0
    with pytest.raises(ValueError, match="packed problems"):
        kernel.relaxed(pk, 16)


# -- the reference's contracts (tests/test_shockwave_solver.py) ---------


def make_problem(priorities, completed, total, epoch_dur, remaining,
                 nworkers, num_gpus=2, round_duration=100.0,
                 future_rounds=3, regularizer=0.001):
    return EGProblem(
        priorities=np.asarray(priorities, dtype=np.float64),
        completed_epochs=np.asarray(completed, dtype=np.float64),
        total_epochs=np.asarray(total, dtype=np.float64),
        epoch_duration=np.asarray(epoch_dur, dtype=np.float64),
        remaining_runtime=np.asarray(remaining, dtype=np.float64),
        nworkers=np.asarray(nworkers, dtype=np.float64),
        num_gpus=num_gpus, round_duration=round_duration,
        future_rounds=future_rounds, regularizer=regularizer,
        log_bases=bench_sim.LOG_BASES,
    )


def test_relaxed_solution_feasible():
    rng = np.random.default_rng(3)
    J, R, num_gpus = 8, 5, 4
    total = rng.integers(2, 10, J).astype(float)
    completed = np.floor(total * rng.uniform(0, 0.9, J))
    epoch_dur = rng.uniform(30, 300, J)
    remaining = (total - completed) * epoch_dur * rng.uniform(0.8, 1.2, J)
    problem = make_problem(
        priorities=rng.uniform(0.5, 4.0, J), completed=completed,
        total=total, epoch_dur=epoch_dur, remaining=remaining,
        nworkers=rng.integers(1, 3, J).astype(float), num_gpus=num_gpus,
        round_duration=100.0, future_rounds=R, regularizer=1e-4)
    s = eg_relaxed.solve_eg_relaxed(problem, device="cpu")
    assert np.all(s >= -1e-5)
    assert np.all(s <= problem.future_rounds + 1e-5)
    budget = problem.num_gpus * problem.future_rounds
    assert float(problem.nworkers @ s) <= budget * (1 + 1e-4)


def test_saturated_jobs_get_no_extra_rounds():
    problem = make_problem(
        priorities=[1.0, 1.0], completed=[9.0, 0.0], total=[10.0, 10.0],
        epoch_dur=[50.0, 100.0], remaining=[50.0, 1000.0],
        nworkers=[1.0, 1.0], num_gpus=1, round_duration=100.0,
        future_rounds=4, regularizer=1e-4)
    s = eg_relaxed.solve_eg_relaxed(problem, device="cpu")
    assert s[0] < 1.5
    assert s[1] > 2.0


def test_relaxed_backend_end_to_end():
    """shockwave_tpu_relaxed is a selectable backend of the port
    (tests/test_shockwave_solver.py:340)."""
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.data.workload_info import steps_per_epoch
    from shockwave_tpu_torch.policies import get_available_policies, get_policy

    assert "shockwave_tpu_relaxed" in get_available_policies()
    jobs = [Job(job_type="ResNet-18 (batch size 32)",
                command="python3 main.py --data_dir=%s/cifar10 "
                "--batch_size 32", num_steps_arg="--num_steps",
                total_steps=steps_per_epoch("ResNet-18", 32) * 2)
            for _ in range(5)]
    arrivals = [i * 30.0 for i in range(5)]
    oracle = generate_oracle()
    sched = Scheduler(
        get_policy("shockwave_tpu_relaxed", device="cpu"),
        throughputs=oracle, seed=0, time_per_iteration=120,
        profiles=synthesize_profiles(jobs, oracle),
        shockwave_config={"num_gpus": 2, "time_per_iteration": 120,
                          "future_rounds": 8, "lambda": 5.0, "k": 10.0},
    )
    makespan = sched.simulate({"v100": 2}, arrivals, jobs)
    assert makespan > 0
    assert len(sched._job_completion_times) == 5
    assert all(t is not None for t in sched._job_completion_times.values())
    assert {r["backend"] for r in sched._shockwave.solve_records} == {
        "relaxed"}


def _flat_problem():
    """Raw PGD's 1000 x 50 x 256 problem (seed 0), packed for kernel B,
    and its plain version's output row."""
    problem = port_problem(bench.make_problem(
        num_jobs=1000, future_rounds=50, num_gpus=256, seed=0))
    packed = bench_sim.eg_pack("relaxed", problem, "cpu")
    return problem, packed, bench_sim.eg_plain("relaxed", packed).numpy()


def test_start_moved_spreads_on_a_flat_optimum():
    """``bench_sim.start_moved``: the plain version of kernel B with its
    ``s_init`` one float32 step up, then down, on raw PGD's 1000-job
    problem. ``s`` moves past the limit on a coordinate or two each way,
    by 0.0125 and 0.039 (CPU readings), while the objective, the rounded
    objective and feasibility hold (``eg_misses`` without ``s``): float32
    does not determine ``s`` there, so chip_smoke.py phase 9(b) lists
    such a miss and does not hold it. The same spread on the 2048-job pdhg
    tier's 276-job window measured 0.809 / 0.837 (PERF.md)."""
    problem, packed, ref = _flat_problem()
    J, slots = problem.num_jobs, packed.shape[2]
    ref_s = ref[:J].astype(np.float64)
    largest = []
    for row in bench_sim.start_moved("relaxed", packed):
        moved = row.numpy()
        s = moved[:J].astype(np.float64)
        count, err = _misses(s, ref_s)
        assert count >= 1, (count, err)
        largest.append(err)
        assert bench_sim.eg_misses(problem, s, float(moved[slots]), ref_s,
                                   float(ref[slots]), check_s=False) == []
    assert max(largest) >= 0.03, largest


def test_kernel_check_holds_s_only_where_float32_determines_it(
        monkeypatch):
    """``bench_sim.check_eg_kernels`` with a stand-in for the kernel (the
    plain version on the CPU, kernel A exact): an ``s`` that a one-step
    move of the plain version's start reproduces is listed, not failed,
    on the flat problem; the same stand-in's objective 1% off, or its
    ``s`` past the budget, still fails there; and one job's ``s`` one
    round less fails on a seeded problem, where the plain version's own
    spread stays under the limit."""
    flat, flat_packed, _ = _flat_problem()
    seeded = bench_sim.seeded_problem(256)
    moved = bench_sim.start_moved("relaxed", flat_packed)[1]
    cases = {
        "rounding": lambda row, J, slots: moved.clone(),
        "objective": lambda row, J, slots: torch.cat([
            moved[:slots], moved[slots:slots + 1] * 1.01,
            moved[slots + 1:]]),
        "budget": lambda row, J, slots: torch.cat([
            moved[:J] * 1.01, moved[J:]]),
        "one job": lambda row, J, slots: torch.where(
            torch.arange(len(row)) == int(torch.argmax(row[:J])),
            row - 1.0, row),
    }
    for case, change in cases.items():
        def solve(kind, packed, stats=None, variant=None):
            row = bench_sim.eg_plain(kind, packed)
            if kind == "pdhg":
                return row
            J = int((packed[0, 0] > 0).sum())
            return change(row, J, packed.shape[2])

        monkeypatch.setattr(bench_sim, "eg_solve", solve)
        problem = seeded if case == "one job" else flat
        undetermined = []
        bad, max_err = bench_sim.check_eg_kernels([problem], "cpu",
                                                  undetermined)
        if case == "rounding":
            assert bad == [] and max_err == {"pdhg": 0.0, "relaxed": 0.0}
            [u] = undetermined
            assert (u["kernel"], u["jobs"]) == ("relaxed", 1000)
            assert u["s_err"] >= 0.03 and max(u["plain_spread"]) >= 0.03
        elif case == "one job":
            assert undetermined == [] and len(bad) == 1
            assert "s off by 1" in bad[0]
        elif case == "objective":
            assert len(undetermined) == 1
            assert len(bad) == 1 and "objective" in bad[0], bad
        else:
            assert len(undetermined) == 1
            assert any("GPU-rounds" in b for b in bad), bad
