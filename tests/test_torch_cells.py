"""The port's cells market (``shockwave_tpu_torch/cells/``) against the JAX
package's (``shockwave_tpu/cells/``), on the CPU.

The same numpy-seeded inputs go through both packages. Partitioning and
the coordinator's math are plain host code copied from the reference and
must agree exactly. A lane of the port's batched solve is kernel A's plain
version on the CPU, which repeats the reference's float32 arithmetic with
its sums in another order, so against the JAX package's
``solve_cells_pdhg`` it is held to ``tests/test_torch_pdhg.py``'s limits
for two summation orders (``s`` within 5e-3, the objective within
1e-3 (1 + |obj|)); against its own one-lane solve it must be equal in every
bit. The rest are the port's copies of the contracts of
``tests/test_cells.py`` that this slice covers, the golden trace under
``--cells 2`` against the JAX package's run, and the state dicts: a
``cell_set`` or flat state the JAX package writes must restore in the port
and build the same ``EGProblem`` in every bit of its float64 fields.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import bench
from shockwave_tpu.cells import batched as ref_batched
from shockwave_tpu.cells import coordinator as ref_coordinator
from shockwave_tpu.cells import partition as ref_partition
from shockwave_tpu.cells.planner import CellPlanner as RefCellPlanner
from shockwave_tpu.core.ids import JobId as RefJobId
from shockwave_tpu.obs import recorder as ref_recorder
from shockwave_tpu.policies.shockwave import \
    planner_from_state as ref_planner_from_state
from shockwave_tpu_torch.cells import batched, coordinator, partition
from shockwave_tpu_torch.cells.planner import CellPlanner
from shockwave_tpu_torch.obs import recorder
from shockwave_tpu_torch.ops import eg_pdhg as kernel
from shockwave_tpu_torch.parallel import mesh as meshes
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.policies.shockwave import (ShockwavePlanner,
                                                    planner_from_state)
from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.solver import eg_pdhg
from shockwave_tpu_torch.tools import bench_sim
from test_torch_pdhg import OBJ_TOL, S_TOL
from test_torch_solver import port_problem

PROFILE = {
    "num_epochs": 4,
    "num_samples_per_epoch": 64,
    "scale_factor": 1,
    "bs_every_epoch": [32] * 4,
    "duration_every_epoch": [120.0] * 4,
}

CONFIG = {
    "num_gpus": 4,
    "time_per_iteration": 60.0,
    "future_rounds": 4,
    "lambda": 2.0,
    "k": 1e-3,
    "cells": 2,
}

JOB_FIELDS = ("priorities", "completed_epochs", "total_epochs",
              "epoch_duration", "remaining_runtime", "nworkers",
              "switch_cost", "incumbent", "log_bases")
SCALAR_FIELDS = ("num_gpus", "round_duration", "future_rounds",
                 "regularizer")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cell_planner(num_jobs=6, config=None, backend="cells"):
    planner = CellPlanner(dict(config or CONFIG), backend=backend,
                          device="cpu")
    for j in range(num_jobs):
        planner.add_job(j, dict(PROFILE), 60.0, 1)
    return planner


def split_global(problem, num_cells):
    """A JAX-package bench problem split row-wise into cells (round
    robin), capacity split evenly (tests/test_cells.py::_split_global)."""
    caps = ref_partition.partition_capacity(problem.num_gpus, num_cells)
    cells, indices = [], []
    for c in range(num_cells):
        idx = np.arange(c, problem.num_jobs, num_cells)
        fields = {f: getattr(problem, f)[idx] for f in JOB_FIELDS[:-1]}
        cells.append(dataclasses.replace(problem, num_gpus=caps[c], **fields))
        indices.append(idx)
    return cells, indices


def assert_same_problem(port, ref):
    """Every float64 field (and scalar) equal in every bit."""
    for f in JOB_FIELDS:
        a, b = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype == np.float64, f
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), f
    for f in SCALAR_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
        assert type(getattr(port, f)) is type(getattr(ref, f)), f


# -- partitioning ---------------------------------------------------------


def test_partition_capacity_even_and_floored():
    assert partition.partition_capacity(8, 3) == [3, 3, 2]
    assert partition.partition_capacity(2, 5) == [1, 1]  # clamped
    assert sum(partition.partition_capacity(257, 16)) == 257
    for gpus in (1, 2, 7, 64, 257, 25600):
        for cells in (1, 2, 3, 4, 8, 16, 300):
            assert (partition.partition_capacity(gpus, cells)
                    == ref_partition.partition_capacity(gpus, cells))
    assert partition.cell_names(12) == ref_partition.cell_names(12)


@pytest.mark.parametrize("seed", range(4))
def test_spread_capacity_delta_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    caps = [int(c) for c in rng.integers(1, 40, 6)]
    floors = [int(rng.integers(1, c + 1)) for c in caps]
    for delta in (-200, -17, -1, 0, 1, 5, 90):
        assert (partition.spread_capacity_delta(caps, delta, floors)
                == ref_partition.spread_capacity_delta(caps, delta, floors))
    shrunk = partition.spread_capacity_delta([4, 4], -5, floors=[2, 2])
    assert shrunk == [2, 2]


@pytest.mark.parametrize("seed", range(4))
def test_pick_cell_and_floor_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        loads = [float(x) for x in rng.integers(0, 60, n)]
        caps = [int(x) for x in rng.integers(1, 30, n)]
        gang = int(rng.choice([1, 2, 4, 8, 40]))
        sticky = int(rng.integers(-1, n + 1))
        sticky = None if sticky < 0 else sticky
        assert (partition.pick_cell(gang, loads, caps, sticky=sticky)
                == ref_partition.pick_cell(gang, loads, caps, sticky=sticky))
    gangs = {j: float(g) for j, g in enumerate(rng.choice([1, 2, 8], 9))}
    assert partition.cell_floor(gangs) == ref_partition.cell_floor(gangs)
    # The reference's own cases (tests/test_cells.py:73-93).
    assert partition.pick_cell(1, [6.0, 1.0], [4, 4]) == 1
    assert partition.pick_cell(4, [6.0, 1.0], [4, 2]) == 0
    assert partition.pick_cell(1, [50.0, 49.0, 50.0], [100] * 3,
                               sticky=0) == 0
    assert partition.pick_cell(1, [52.0, 49.0, 50.0], [100] * 3,
                               sticky=0) == 1


def test_burst_admission_touches_one_cell():
    """After a balanced fill of 1000 jobs a cell, an 18-job burst lands in
    at most 2 cells, and every job lands where the JAX package puts it."""
    planner = CellPlanner({**CONFIG, "num_gpus": 64, "cells": 4},
                          device="cpu")
    ref = RefCellPlanner({**CONFIG, "num_gpus": 64, "cells": 4},
                         backend="cells")
    for j in range(4000):
        planner.add_job(j, dict(PROFILE), 60.0, 1)
        ref.add_job(j, dict(PROFILE), 60.0, 1)
    loads = [planner._cell_load(n) for n in planner.cells]
    assert max(loads) - min(loads) <= 0.03 * (sum(loads) / 4), loads
    touched = set()
    for j in range(4000, 4018):
        planner.add_job(j, dict(PROFILE), 60.0, 1)
        ref.add_job(j, dict(PROFILE), 60.0, 1)
        touched.add(planner.job_cell[j])
    assert len(touched) <= 2, touched
    assert planner.job_cell == ref.job_cell


# -- coordinator math -----------------------------------------------------


@pytest.mark.parametrize("jobs, gpus, seed", [(8, 512, 0), (64, 4, 0),
                                              (40, 16, 2), (100, 32, 5)])
def test_coordinator_math_equals_the_reference(jobs, gpus, seed):
    """demand_rounds, congestion_price and spare_chips on the JAX
    package's own solve of the problem: equal to its values exactly."""
    g = bench.make_problem(num_jobs=jobs, future_rounds=10, num_gpus=gpus,
                           seed=seed)
    s, _, _ = ref_batched.solve_cells_pdhg([g])
    s = s[0]
    p = port_problem(g)
    assert np.array_equal(coordinator.demand_rounds(p),
                          ref_coordinator.demand_rounds(g))
    assert (coordinator.congestion_price(p, s)
            == ref_coordinator.congestion_price(g, s))
    assert coordinator.spare_chips(p, s) == ref_coordinator.spare_chips(g, s)


def test_congestion_price_zero_when_slack_and_positive_under_contention():
    slack = port_problem(bench.make_problem(num_jobs=8, future_rounds=10,
                                            num_gpus=512, seed=0))
    s, _, _ = eg_pdhg.solve_pdhg_relaxed(slack, device="cpu")
    assert coordinator.congestion_price(slack, s) == 0.0
    tight = port_problem(bench.make_problem(num_jobs=64, future_rounds=10,
                                            num_gpus=4, seed=0))
    s, _, _ = eg_pdhg.solve_pdhg_relaxed(tight, device="cpu")
    assert coordinator.congestion_price(tight, s) > 0.0


def test_capacity_move_equals_the_reference():
    args = (["a", "b"], {"a": 0.0, "b": 5.0}, {"a": 3, "b": 0},
            {"a": 8, "b": 8}, {"a": 1, "b": 1})
    move = coordinator.propose_capacity_move(*args)
    assert move is not None and move.src == "a" and move.dst == "b"
    assert 1 <= move.chips <= 3
    assert move.as_dict() == ref_coordinator.propose_capacity_move(
        *args).as_dict()
    assert coordinator.propose_capacity_move(
        ["a", "b"], {"a": 5.0, "b": 5.0}, {"a": 3, "b": 3},
        {"a": 8, "b": 8}, {"a": 1, "b": 1}) is None
    rng = np.random.default_rng(7)
    for _ in range(100):
        names = ["c00", "c01", "c02"]
        prices = {n: float(rng.choice([0.0, rng.uniform(0, 3)]))
                  for n in names}
        spares = {n: int(rng.integers(0, 5)) for n in names}
        caps = {n: int(rng.integers(1, 20)) for n in names}
        floors = {n: int(rng.integers(1, caps[n] + 1)) for n in names}
        a = coordinator.propose_capacity_move(names, prices, spares, caps,
                                              floors)
        b = ref_coordinator.propose_capacity_move(names, prices, spares,
                                                  caps, floors)
        assert (a is None and b is None) or a.as_dict() == b.as_dict()


def test_migration_priced_through_switch_cost():
    """An incumbent whose relaunch overhead exceeds the cross-cell gain
    must not migrate; an identical non-incumbent must; the plan equals
    the JAX package's."""
    g = bench.make_problem(num_jobs=16, future_rounds=10, num_gpus=4, seed=2)
    g = dataclasses.replace(g, incumbent=np.array([1.0] * 8 + [0.0] * 8),
                            switch_cost=np.array([1e9] * 8 + [0.0] * 8))
    s, _, _ = ref_batched.solve_cells_pdhg([g])
    ids = [f"job{i}" for i in range(16)]
    args = (["hot", "cold"], {"hot": g, "cold": g},
            {"hot": s[0], "cold": s[0]}, {"hot": ids, "cold": ids},
            {"hot": 10.0, "cold": 0.0}, {"hot": 4, "cold": 4})
    p = port_problem(g)
    plan = coordinator.plan_migrations(*args[:1], {"hot": p, "cold": p},
                                       *args[2:], max_moves=4)
    assert plan, "no migrations out of a congested cell"
    assert {m.job for m in plan} <= set(ids[8:])
    assert all(m.cost == 0.0 and not m.incumbent for m in plan)
    ref = ref_coordinator.plan_migrations(*args, max_moves=4)
    assert [m.as_dict() for m in plan] == [m.as_dict() for m in ref]


# -- batched lanes --------------------------------------------------------


def test_lane_equals_its_one_lane_solve_whatever_its_neighbours():
    """A cell's market does not change by being solved next to its
    neighbours: every lane equals the one-problem solve in every bit, and
    the lane count does not matter."""
    g = bench.make_problem(num_jobs=48, future_rounds=10, num_gpus=12,
                           seed=1)
    cells = [port_problem(c) for c in split_global(g, 3)[0]]
    s_all, obj_all, diags = batched.solve_cells_pdhg(cells, device="cpu")
    assert [d["lanes"] for d in diags] == [3, 3, 3]
    for i, cell in enumerate(cells):
        s_single, obj_single, _ = eg_pdhg.solve_pdhg_relaxed(cell,
                                                             device="cpu")
        assert np.array_equal(s_all[i], s_single)
        assert obj_all[i] == obj_single
    s_two, _, _ = batched.solve_cells_pdhg(cells[1:], device="cpu")
    assert np.array_equal(s_two[0], s_all[1])
    assert np.array_equal(s_two[1], s_all[2])


@pytest.mark.parametrize("places, cells", [(1, 8), (2, 8), (4, 8), (4, 3),
                                           (3, 8)])
def test_lanes_on_a_mesh_equal_the_meshless_call(places, cells):
    """The lanes split over a mesh's places in contiguous blocks of the
    band over P, one launch a place; each lane equal in every bit to the
    meshless call (tests/test_whatif.py:130-141). A mesh whose places do
    not divide the band runs the meshless call, as the JAX package."""
    g = bench.make_problem(num_jobs=16 * cells, future_rounds=10,
                           num_gpus=4 * cells, seed=cells)
    problems = [port_problem(c) for c in split_global(g, cells)[0]]
    s_one, obj_one, diag_one = batched.solve_cells_pdhg(problems,
                                                        device="cpu")
    launches = []
    real = eg_pdhg.solve_lanes_on_mesh

    def spy(packed, *args, **kwargs):
        launches.append(len(packed))
        return real(packed, *args, **kwargs)

    mesh = meshes.make_solve_mesh(["cpu"] * places, "cells")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(batched, "solve_lanes_on_mesh", spy)
        s_mesh, obj_mesh, diag_mesh = batched.solve_cells_pdhg(
            problems, mesh=mesh, device="cpu")
    band = batched.lane_band(cells)
    assert launches == ([cells] if band % places == 0 else [])
    for i in range(cells):
        assert np.array_equal(s_mesh[i], s_one[i])
        assert obj_mesh[i] == obj_one[i]
        assert diag_mesh[i]["lanes"] == cells
        assert diag_mesh[i]["iterations"] == diag_one[i]["iterations"]
    if band % places == 0:
        assert diag_mesh[0]["chunk"] == min(band // places, cells)


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("cells", [2, 3, 4, 6, 8])
def test_cell_mesh_takes_the_largest_n_dividing_the_band(devices, cells,
                                                         monkeypatch):
    """``_mesh``: the largest n up to the visible devices that divides the
    cells' lane band, none for one device or n = 1 (the JAX package's
    ``CellPlanner._mesh`` on its host devices)."""
    import jax

    config = {**CONFIG, "num_gpus": 16, "cells": cells, "cell_mesh": True}
    monkeypatch.setattr(meshes, "visible_devices",
                        lambda device: [torch.device("cpu")] * devices)
    mesh = CellPlanner(config, device="cpu")._mesh()
    ref_planner = RefCellPlanner(config)
    monkeypatch.setattr(jax, "devices", lambda: jax.local_devices()[:devices])
    ref_mesh = ref_planner._mesh()
    if ref_mesh is None:
        assert mesh is None
    else:
        assert mesh.shape == {"cells": ref_mesh.devices.size}
        assert batched.lane_band(cells) % mesh.devices.size == 0


@pytest.mark.parametrize("jobs, gpus, cells, seed", [(48, 12, 2, 1),
                                                     (120, 32, 4, 3)])
def test_lanes_match_the_reference_batch(jobs, gpus, cells, seed):
    g = bench.make_problem(num_jobs=jobs, future_rounds=10, num_gpus=gpus,
                           seed=seed)
    parts = split_global(g, cells)[0]
    rng = np.random.default_rng(seed)
    s0s = [None] + [rng.uniform(0, 10, p.num_jobs) for p in parts[1:]]
    ref_s, ref_obj, ref_diag = ref_batched.solve_cells_pdhg(parts, s0s)
    kernel.reset_launch_counts()
    s, obj, diag = batched.solve_cells_pdhg(
        [port_problem(p) for p in parts], s0s, device="cpu")
    assert kernel.LAUNCHES["eg_pdhg"] == 0  # the plain version on the CPU
    for i in range(cells):
        np.testing.assert_allclose(s[i], ref_s[i], rtol=S_TOL, atol=S_TOL)
        assert abs(obj[i] - ref_obj[i]) <= OBJ_TOL * (1.0 + abs(ref_obj[i]))
        assert diag[i]["converged"] == ref_diag[i]["converged"]
    assert batched.lane_band(cells) == ref_batched.lane_band(cells)
    assert [batched.lane_band(n) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]


def test_mismatched_planning_configs_and_mesh_raise():
    cells = [port_problem(c) for c in split_global(
        bench.make_problem(num_jobs=16, future_rounds=10, num_gpus=8,
                           seed=0), 2)[0]]
    other = dataclasses.replace(cells[1], future_rounds=12)
    with pytest.raises(ValueError, match="planning config"):
        batched.solve_cells_pdhg([cells[0], other], device="cpu")
    # A mesh without the lane axis.
    with pytest.raises(ValueError, match="'cells'"):
        batched.solve_cells_pdhg(cells, mesh=meshes.make_solve_mesh(
            ["cpu", "cpu"], "solve"), device="cpu")
    # cell_mesh with one device visible: no mesh, as the JAX package.
    assert CellPlanner({**CONFIG, "cell_mesh": True},
                       device="cpu")._mesh() is None
    # Speculation is ported (tests/test_torch_speculation.py).
    planner = CellPlanner({**CONFIG, "speculate": True}, device="cpu")
    assert planner.spec_stats == {"hit": 0, "repair": 0, "miss": 0}


def test_cells_vs_global_objective_gap_and_capacity():
    """The merged cell schedule, audited against the global problem,
    stays within 0.1% of the global solve's objective and conserves
    capacity (tests/test_cells.py:155-177)."""
    g = port_problem(bench.make_problem(num_jobs=64, future_rounds=20,
                                        num_gpus=16, seed=3))
    Y_global = eg_pdhg.solve_eg_pdhg(g, device="cpu")
    g.audit_schedule(Y_global)
    cells, indices = split_global(g, 2)
    s_list, _, _ = batched.solve_cells_pdhg(cells, device="cpu")
    merged = np.zeros_like(Y_global)
    for cell, idx, s in zip(cells, indices, s_list):
        merged[idx] = batched.schedule_cell(cell, s, "cpu")
    g.audit_schedule(merged)
    obj_g, obj_m = g.objective_value(Y_global), g.objective_value(merged)
    assert (obj_g - obj_m) / abs(obj_g) <= 1e-3, (obj_g, obj_m)


# -- CellPlanner ----------------------------------------------------------


def test_cell_planner_plans_and_conserves_capacity():
    planner = tiny_cell_planner(num_jobs=8)
    assert planner.current_round_schedule()
    assert len(planner.job_cell) == 8
    assert sum(planner.assignments.values()) == 8
    for r in range(planner.round_index, planner.round_index + 4):
        used = sum(1 for child in planner.children.values()
                   for _ in child.schedules.get(r, []))
        assert used <= CONFIG["num_gpus"]
    record = planner.coord_solve_records[-1]
    assert record["backend"] == "cells"
    assert set(record["cells"]) == {"c00", "c01"}
    assert all(c["lanes"] == 2 for c in record["cells"].values())


def test_selective_replan_only_touches_stale_cells():
    planner = tiny_cell_planner(num_jobs=8)
    planner.current_round_schedule()
    assert planner.coord_solve_records[-1]["stale_cells"] == 2
    cell = planner.job_cell[0]
    other = [n for n in planner.cells if n != cell][0]
    cached = {r: list(s)
              for r, s in planner.children[other].schedules.items()}
    planner.remove_job(0)
    planner.children[cell].set_recompute_flag()
    planner.current_round_schedule()
    second = planner.coord_solve_records[-1]
    assert second["stale_cells"] == 1
    assert list(second["cells"]) == [cell]
    assert second["cells"][cell]["lanes"] == 1
    assert {r: list(s) for r, s in
            planner.children[other].schedules.items()} == cached


def test_set_recompute_flag_with_jobs_stales_only_owning_cell():
    planner = tiny_cell_planner(num_jobs=6)
    planner.current_round_schedule()
    cell = planner.job_cell[3]
    planner.set_recompute_flag(jobs=[3])
    assert [n for n, c in planner.children.items()
            if c.recompute_flag] == [cell]
    planner.set_recompute_flag(jobs=[999])  # unmapped: every cell
    assert all(c.recompute_flag for c in planner.children.values())


def test_fleet_capacity_change_spreads_with_floors():
    planner = tiny_cell_planner(num_jobs=4)
    planner.current_round_schedule()
    planner.set_capacity(2)
    assert sum(planner.cells.values()) == 2
    assert all(c >= 1 for c in planner.cells.values())
    planner.set_capacity(6)
    assert sum(planner.cells.values()) == 6
    # A floor above one chip: a 3-wide gang keeps its cell at 3.
    planner = CellPlanner({**CONFIG, "num_gpus": 8}, device="cpu")
    ref = RefCellPlanner({**CONFIG, "num_gpus": 8}, backend="cells")
    for p in (planner, ref):
        p.add_job(0, dict(PROFILE), 60.0, 3)
        p.add_job(1, dict(PROFILE), 60.0, 1)
        p.set_capacity(4)
    assert planner.cells == ref.cells
    assert planner.cells[planner.job_cell[0]] >= 3
    assert {n: c.num_gpus for n, c in planner.children.items()} == dict(
        planner.cells)


def test_migration_carries_incumbency_and_switch_cost():
    planner = tiny_cell_planner(num_jobs=6)
    planner.current_round_schedule()
    src_name = planner.job_cell[0]
    dst_name = [n for n in planner.cells if n != src_name][0]
    src = planner.children[src_name]
    src.job_overheads[0] = 42.0
    src.last_round_jobs = [0]
    planner._move_job(coordinator.Migration(
        job=0, src=src_name, dst=dst_name, gain=1.0, cost=0.0,
        incumbent=True))
    dst = planner.children[dst_name]
    assert planner.job_cell[0] == dst_name
    assert 0 in dst.job_metadata and 0 not in src.job_metadata
    assert dst.job_overheads[0] == 42.0
    assert 0 in dst.last_round_jobs and 0 not in src.last_round_jobs
    assert planner.migrations_total == 1
    assert src.recompute_flag and dst.recompute_flag
    problem, job_ids = dst._build_problem()
    i = job_ids.index(0)
    assert problem.incumbent[i] == 1.0
    assert problem.switch_cost[i] == 42.0


def test_single_cell_timeout_degrades_that_cell_only():
    """An injected solver_timeout charges one cell's ladder; the other
    cell's plan is the no-fault run's in every round (tests/test_cells.py
    :331-359)."""
    config = {**CONFIG, "plan_deadline_s": 10.0}
    baseline = tiny_cell_planner(num_jobs=6, config=config)
    baseline.current_round_schedule()
    base_plans = {n: dict(c.schedules) for n, c in baseline.children.items()}
    injector = faults.configure(faults.FaultPlan(
        seed=0, events=[faults.FaultEvent(0, "solver_timeout", round=0)]))
    try:
        planner = tiny_cell_planner(num_jobs=6, config=config)
        assert planner.current_round_schedule()
        records = {n: c.solve_records[-1]
                   for n, c in planner.children.items()}
        assert records["c00"].get("degraded") is True
        assert records["c00"]["backend"] != "pdhg"
        assert records["c01"].get("degraded") is None
        assert records["c01"]["backend"] == "pdhg"
        assert dict(planner.children["c01"].schedules) == base_plans["c01"]
        assert injector.summary()["unrecovered"] == []
        assert planner.coord_solve_records[-1]["reconcile"]["skipped"] == (
            "faults_armed")
    finally:
        faults.reset()


def test_a_device_fault_on_the_individual_path_is_raised(monkeypatch):
    """A kernel that does not build or launch is not isolated as a failed
    cell: it raises."""
    from shockwave_tpu_torch.ops._build import KernelError

    planner = tiny_cell_planner(num_jobs=4,
                                config={**CONFIG, "plan_deadline_s": 10.0})

    def broken(*args, **kwargs):
        raise KernelError("eg_pdhg: launch failed")

    for child in planner.children.values():
        monkeypatch.setattr(child, "_solve", broken)
    with pytest.raises(KernelError):
        planner.current_round_schedule()


def test_a_kernel_failure_on_the_batched_path_raises(monkeypatch):
    """The batched path has no fallback: a launch that fails raises out
    of the replan, and no cell is solved another way."""
    from shockwave_tpu_torch.ops._build import KernelError

    planner = tiny_cell_planner(num_jobs=4)

    def broken(*args, **kwargs):
        raise KernelError("eg_pdhg: launch failed")

    monkeypatch.setattr(batched, "solve_lanes", broken)
    with pytest.raises(KernelError):
        planner.current_round_schedule()
    assert not planner.coord_solve_records
    assert all(not c.solve_records for c in planner.children.values())


def test_checkpoint_roundtrip_preserves_federation():
    planner = tiny_cell_planner(num_jobs=6)
    planner.current_round_schedule()
    state = planner.state_dict()
    assert state["kind"] == "cell_set"
    restored = planner_from_state(state, device="cpu")
    assert isinstance(restored, CellPlanner)
    assert restored.cells == planner.cells
    assert restored.job_cell == planner.job_cell
    assert restored.num_jobs == planner.num_jobs
    assert restored._load == planner._load
    restored.set_recompute_flag()
    assert restored.current_round_schedule()


def test_a_recorded_replan_stamp_raises():
    """A plan record's state carries the replan it recorded
    (``cells_replay``): it restores, and the restored federation's next
    replan re-enters the recorded one, over the recorded stale set and
    path, not the live staleness (tests/test_torch_flight_recorder.py
    replays whole logs)."""
    state = tiny_cell_planner(num_jobs=4).state_dict()
    state["cells_replay"] = {"stale": ["c00"], "individual": False,
                             "backends": {}, "fallback": {}, "failed": [],
                             "warm_starts": {"c00": None}}
    restored = planner_from_state(state, device="cpu")
    assert restored._replay_stamp["stale"] == ["c00"]
    restored.set_recompute_flag()
    restored._replan()
    assert restored._replay_stamp is None
    assert restored.coord_solve_records[-1]["stale_cells"] == 1
    assert set(restored.coord_solve_records[-1]["cells"]) <= {"c00"}
    assert restored.schedules


def test_policy_dispatch_builds_cell_planner():
    policy = get_policy("shockwave_tpu_cells", device="cpu")
    assert policy.name == "Shockwave_TPU_Cells"
    assert isinstance(policy.make_planner(dict(CONFIG)), CellPlanner)
    policy = get_policy("shockwave_tpu_pdhg", device="cpu")
    planner = policy.make_planner(dict(CONFIG))
    assert isinstance(planner, CellPlanner)
    assert planner.device == policy.device
    assert not isinstance(policy.make_planner({**CONFIG, "cells": 0}),
                          CellPlanner)


# -- the golden trace -----------------------------------------------------


def test_golden_trace_with_two_cells_matches_the_reference():
    """``-p shockwave_tpu_pdhg -c v100=8 --cells 2`` on the 12-job trace:
    makespan, average JCT and worst FTF within 1e-3 of the JAX package's
    run (``bench_sim.GOLDEN_CELLS``) in the same number of rounds, every
    plan a coordinated replan and every cell plan feasible."""
    r = bench_sim.run_trace(bench_sim.GOLDEN_TRACE, "shockwave_tpu_pdhg", 8,
                            "cpu", config={"cells": 2})
    assert bench_sim.check_run(r, bench_sim.GOLDEN_CELLS) == []
    coord = [rec for rec in r["records"] if "stale_cells" in rec]
    assert coord and r["solves"] == {"cells": len(coord)}
    assert all(rec["ok"] and not rec["failed_cells"] for rec in coord)


def test_golden_cells_pin_is_the_references_run():
    from shockwave_tpu.core.scheduler import Scheduler as RefScheduler
    from shockwave_tpu.data import load_or_synthesize_profiles, parse_trace
    from shockwave_tpu.data.default_oracle import generate_oracle
    from shockwave_tpu.policies import get_policy as ref_get_policy

    jobs, arrivals = parse_trace(str(bench_sim.GOLDEN_TRACE))
    oracle = generate_oracle()
    profiles = load_or_synthesize_profiles(
        str(bench_sim.GOLDEN_TRACE), jobs, oracle, worker_type="v100",
        cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    sched = RefScheduler(
        ref_get_policy("shockwave_tpu_pdhg"), throughputs=oracle, seed=0,
        time_per_iteration=120.0, profiles=profiles,
        shockwave_config={"num_gpus": 8, "time_per_iteration": 120.0,
                          "future_rounds": 20, "lambda": 5.0, "k": 10.0,
                          "cells": 2})
    makespan = sched.simulate({"v100": 8}, arrivals, jobs)
    ftf, _ = sched.get_finish_time_fairness()
    pin = bench_sim.GOLDEN_CELLS
    assert round(makespan, 3) == pin["makespan"]
    assert round(sched.get_average_jct(), 3) == pin["avg_jct"]
    assert round(max(ftf), 3) == pin["worst_ftf"]
    assert sched._num_completed_rounds == pin["rounds"]


# -- state dicts: the JAX package's restore in the port -------------------


def ref_cell_planner(config, jobs, rounds):
    """A JAX-package CellPlanner with ``jobs`` JobId-keyed jobs (gangs 1-2,
    seeded throughput history), planned and advanced ``rounds`` rounds."""
    rng = np.random.default_rng(0)
    planner = RefCellPlanner(dict(config), backend="pdhg")
    for j in range(jobs):
        epochs = int(rng.integers(3, 9))
        profile = {**PROFILE, "num_epochs": epochs,
                   "bs_every_epoch": ([32, 64] * 5)[:epochs],
                   "duration_every_epoch": list(rng.uniform(60, 400,
                                                            epochs))}
        planner.add_job(RefJobId(j), profile, 60.0, int(rng.integers(1, 3)),
                        submit_time=float(j), overhead_s=float(j % 3) * 10.0)
    for r in range(rounds):
        for j in planner.current_round_schedule():
            planner.record_round_throughput(j, r, float(rng.uniform(1, 9)),
                                            int(rng.choice([32, 64])))
            md = planner.get_metadata(j)
            planner.set_progress(j, min(md.completed_epochs + 1,
                                        md.total_epochs))
        planner.increment_round()
    return planner


def through_json(state):
    """A JAX-package state through its recorder's codec and JSON, decoded
    by the port's recorder."""
    return recorder.decode(json.loads(json.dumps(ref_recorder.encode(state))))


@pytest.mark.parametrize("kind", ["flat", "cell_set"])
def test_a_reference_state_dict_builds_the_same_problem(kind):
    config = {**CONFIG, "num_gpus": 6, "cells": 3}
    ref = ref_cell_planner(config, 10, 3)
    state = ref.state_dict() if kind == "cell_set" else ref.children[
        "c01"].state_dict()
    port = planner_from_state(through_json(state), device="cpu")
    ref_restored = ref_planner_from_state(state)
    pairs = (list(zip(port.children.values(), ref_restored.children.values()))
             if kind == "cell_set" else [(port, ref_restored)])
    assert isinstance(port, CellPlanner if kind == "cell_set"
                      else ShockwavePlanner)
    for p, r in pairs:
        assert p.round_index == r.round_index and p.round_index == 3
        problem, ids = p._build_problem()
        ref_problem, ref_ids = r._build_problem()
        assert [str(j) for j in ids] == [str(j) for j in ref_ids]
        assert_same_problem(problem, ref_problem)
        w, ref_w = p._solution_warm_start(), r._solution_warm_start()
        assert (w is None) == (ref_w is None)
        if w is not None:
            assert np.array_equal(w, ref_w)
    if kind == "cell_set":
        assert port.cells == ref_restored.cells
        # Keys are each package's own JobId: compared by their names.
        assert ({str(j): c for j, c in port.job_cell.items()}
                == {str(j): c for j, c in ref_restored.job_cell.items()})
        assert port._load == ref_restored._load
        assert port.prices == ref_restored.prices
        # And the port's own state back through the JAX package's codec.
        back = ref_recorder.decode(json.loads(json.dumps(
            recorder.encode(port.state_dict()))))
        again = ref_planner_from_state(back)
        for (p, _), r in zip(pairs, again.children.values()):
            assert_same_problem(p._build_problem()[0], r._build_problem()[0])


def test_a_restored_reference_federation_plans_as_the_reference():
    """The JAX package's federation restored in the port replans its next
    round: the same stale cells, and each cell's plan within the limits of
    two summation orders of its relaxed solve."""
    config = {**CONFIG, "num_gpus": 6, "cells": 3}
    ref = ref_cell_planner(config, 10, 3)
    port = planner_from_state(through_json(ref.state_dict()), device="cpu")
    ref.set_recompute_flag()
    port.set_recompute_flag()
    ref_schedule = ref.current_round_schedule()
    schedule = port.current_round_schedule()
    a, b = ref.coord_solve_records[-1], port.coord_solve_records[-1]
    assert a["stale_cells"] == b["stale_cells"] == 3
    assert set(a["cells"]) == set(b["cells"])
    assert sorted(map(str, schedule)) == sorted(map(str, ref_schedule))


def test_packed_lanes_are_the_references_stacked_cells():
    """The lanes of one launch hold, row for row and bit for bit, what the
    JAX package's ``_stack_cells`` hands its vmapped kernel, each lane's
    own capacity in its scalar row and no inert lanes."""
    g = bench.make_problem(num_jobs=70, future_rounds=10, num_gpus=12,
                           seed=4)
    parts = split_global(g, 3)[0]
    rng = np.random.default_rng(4)
    s0s = [rng.uniform(0, 10, p.num_jobs) for p in parts]
    stacked = ref_batched._stack_cells(parts, s0s, 64, 4)
    packed = eg_pdhg.pack_problems([port_problem(p) for p in parts], s0s, 64,
                                   1e-4, 1e-5)
    assert packed.shape == (3, len(eg_pdhg.ROWS) + 1, 64)
    for row in range(len(eg_pdhg.ROWS)):
        ref = np.asarray(stacked[row])[:3]
        assert np.array_equal(packed[:, row].view(np.int32),
                              ref.astype(np.float32).view(np.int32)), row
    scalars = packed[:, len(eg_pdhg.ROWS)]
    assert np.array_equal(scalars[:, 0], np.asarray(stacked[9])[:3])
    assert np.all(scalars[:, 1:4] == [120.0, 10.0, 10.0])


def test_lane_chunk_splits_only_what_the_card_cannot_hold(monkeypatch):
    """A launch takes every lane unless a global instantiation's state
    (STATE_ROWS floats a slot a lane) would pass half the card's free
    memory; the CPU and resident instantiations never split."""

    class Lanes:
        def __init__(self, P, slots, device):
            self.shape = (P, len(eg_pdhg.ROWS) + 1, slots)
            self.device = torch.device(device)

    per_lane = 4 * kernel.STATE_ROWS * 65536
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (2 * 10 * per_lane + 7, 0))
    assert kernel.lane_chunk(Lanes(1024, 65536, "cpu")) == 1024
    assert kernel.lane_chunk(Lanes(1024, 64, "cuda")) == 1024  # resident
    assert kernel.instantiation(65536) == (1, False)
    assert kernel.lane_chunk(Lanes(1024, 65536, "cuda")) == 10
    assert kernel.lane_chunk(Lanes(6, 65536, "cuda")) == 6
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (0, 0))
    assert kernel.lane_chunk(Lanes(3, 65536, "cuda")) == 1
