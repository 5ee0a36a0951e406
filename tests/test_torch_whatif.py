"""The port's what-if fleet (``shockwave_tpu_torch/whatif/``) and the
flight recorder's reader against the JAX package's, on the CPU.

The same numpy-seeded problems and the committed decision log
(``results/flight_recorder/decisions.jsonl``) go through both packages.
A lane is kernel A's plain version on the CPU: equal in every bit to its
own one-lane solve and to the one-problem solve of the problem its
overlay describes, and within ``tests/test_torch_pdhg.py``'s limits of
two summation orders (``s`` within 5e-3, the objective within
1e-3 (1 + |obj|)) of the JAX package's ``solve_scenarios`` lane. Seeding
from a recorded round or an export-state artifact must build the same
``EGProblem`` as the JAX package, equal in every bit. The rest are the
port's copies of the contracts of ``tests/test_whatif.py`` this slice
covers (the pricing, replay and streaming tests wait with their
modules).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from shockwave_tpu.obs import recorder as ref_recorder
from shockwave_tpu.solver.eg_problem import EGProblem as RefEGProblem
from shockwave_tpu.whatif import Scenario as RefScenario
from shockwave_tpu.whatif import ScenarioBatch as RefScenarioBatch
from shockwave_tpu.whatif import base_problem_from_log as ref_from_log
from shockwave_tpu.whatif import base_problem_from_state as ref_from_state
from shockwave_tpu.whatif import solve_scenarios as ref_solve_scenarios
from shockwave_tpu_torch.obs import recorder
from shockwave_tpu_torch.ops import eg_pdhg as kernel
from shockwave_tpu_torch.parallel import mesh as meshes
from shockwave_tpu_torch.solver import eg_pdhg
from shockwave_tpu_torch.tools import whatif as cli
from shockwave_tpu_torch.whatif import (Scenario, ScenarioBatch, audit_lanes,
                                        base_problem_from_log,
                                        base_problem_from_state,
                                        scenario_report, solve_scenario,
                                        solve_scenarios)
from test_torch_cells import assert_same_problem
from test_torch_pdhg import OBJ_TOL, S_TOL
from test_torch_solver import port_problem

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(REPO_ROOT, "results", "flight_recorder",
                   "decisions.jsonl")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_problem(num_jobs=10, num_gpus=4, seed=0, future_rounds=8):
    """tests/test_whatif.py::make_problem, the JAX package's."""
    rng = np.random.default_rng(seed)
    total = rng.integers(5, 40, num_jobs).astype(float)
    completed = np.floor(total * rng.uniform(0, 0.8, num_jobs))
    epoch_dur = rng.uniform(60, 900, num_jobs)
    incumbent = (rng.random(num_jobs) < 0.3).astype(np.float64)
    return RefEGProblem(
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


def make_problem(**kwargs):
    return port_problem(ref_problem(**kwargs))


def mixed_grid(problem, n=7, scenario=Scenario):
    """tests/test_whatif.py::mixed_grid, of either package's Scenario."""
    rng = np.random.default_rng(1)
    grid = [scenario(name="baseline")]
    for i in range(n - 1):
        mask = None
        if i % 3 == 2:
            mask = (rng.random(problem.num_jobs) < 0.7).astype(float)
        grid.append(scenario(
            name=f"s{i}", num_gpus=float(2 + (i % 6)),
            priority_scale=0.5 + (i % 4) * 0.5,
            switch_cost_scale=float(i % 3),
            round_duration=60.0 * (1 + i % 3), job_mask=mask,
            regularizer=None if i % 4 else 5.0))
    return grid


def solve(batch, **kwargs):
    return solve_scenarios(batch, device="cpu", **kwargs)


# -- lanes ----------------------------------------------------------------


def test_identity_lane_equals_the_one_problem_solve():
    problem = make_problem()
    batch = ScenarioBatch(problem, [Scenario(name="baseline")])
    s_list, objs, _ = solve(batch)
    s0 = batch.base[len(eg_pdhg.ROWS) - 1][:problem.num_jobs]
    s_ref, obj_ref, _ = eg_pdhg.solve_pdhg_relaxed(problem, s0=s0,
                                                   device="cpu")
    assert np.array_equal(np.float32(s_list[0]), np.float32(s_ref))
    assert objs[0] == obj_ref


def test_every_mixed_grid_lane_equals_its_one_lane_solve():
    problem = make_problem()
    batch = ScenarioBatch(problem, mixed_grid(problem))
    s_list, _, diags = solve(batch)
    audit = audit_lanes(batch, s_list, device="cpu")
    assert audit == {"audited": 7, "mismatched": [], "bit_identical": True}
    assert all(d["converged"] for d in diags)
    assert all(d["lanes"] == 7 and d["chunk"] == 7 for d in diags)


def test_capacity_overlay_equals_a_problem_built_with_it():
    problem = make_problem()
    batch = ScenarioBatch(problem, [Scenario(name="baseline"),
                                    Scenario(name="cap9", num_gpus=9)])
    s_list, objs, _ = solve(batch)
    s0 = batch.base[len(eg_pdhg.ROWS) - 1][:problem.num_jobs]
    s_ref, obj_ref, _ = eg_pdhg.solve_pdhg_relaxed(
        dataclasses.replace(problem, num_gpus=9), s0=s0, device="cpu")
    assert np.array_equal(np.float32(s_list[1]), np.float32(s_ref))
    assert objs[1] == obj_ref


@pytest.mark.parametrize("seed", [0, 3])
def test_lanes_match_the_reference_fleet(seed):
    """The JAX package's scenario lanes (its vmapped kernel) against the
    port's on the same grid: the overlays are the same float32 products,
    so each lane agrees to the limits of two summation orders."""
    ref = ref_problem(num_jobs=12, seed=seed)
    problem = port_problem(ref)
    ref_s, ref_obj, ref_diag = ref_solve_scenarios(RefScenarioBatch(
        ref, mixed_grid(ref, n=8, scenario=RefScenario)))
    kernel.reset_launch_counts()
    s, obj, diag = solve(ScenarioBatch(problem, mixed_grid(problem, n=8)))
    assert kernel.LAUNCHES["eg_pdhg"] == 0  # the plain version on the CPU
    for i in range(8):
        np.testing.assert_allclose(s[i], ref_s[i], rtol=S_TOL, atol=S_TOL)
        assert abs(obj[i] - ref_obj[i]) <= OBJ_TOL * (1.0 + abs(ref_obj[i]))
        assert diag[i]["converged"] == ref_diag[i]["converged"]


def test_overlay_lanes_are_the_references_float32_products():
    """Each packed lane holds active * mask, priorities * pscale and
    switch_bonus * sscale as the JAX package's kernel forms them, and the
    lane's own scalars."""
    ref = ref_problem(num_jobs=12, seed=2)
    grid = mixed_grid(ref, n=6, scenario=RefScenario)
    ref_batch = RefScenarioBatch(ref, grid)
    batch = ScenarioBatch(port_problem(ref), mixed_grid(port_problem(ref),
                                                        n=6))
    lanes = batch.packed()
    base = [np.asarray(a) for a in ref_batch.base_args]
    mask, pscale, gpus, sscale, dur, rounds, reg = (
        np.asarray(a)[:6] for a in ref_batch.overlays)
    for i in range(6):
        for row, want in ((0, base[0] * mask[i]), (1, base[1] * pscale[i]),
                          (7, base[7] * sscale[i])):
            assert np.array_equal(lanes[i, row].view(np.int32),
                                  want.astype(np.float32).view(np.int32))
        for row in (2, 3, 4, 5, 6, 8):
            assert np.array_equal(lanes[i, row], base[row])
        assert list(lanes[i, len(eg_pdhg.ROWS), :4]) == [
            gpus[i], dur[i], rounds[i], reg[i]]


# -- overlays -------------------------------------------------------------


def test_perturbing_one_lane_leaves_others_untouched():
    problem = make_problem()
    a = ScenarioBatch(problem, [Scenario(name="baseline"),
                                Scenario(name="p2", priority_scale=2.0)])
    b = ScenarioBatch(problem, [Scenario(name="baseline"),
                                Scenario(name="p4", priority_scale=4.0)])
    s_a, obj_a, _ = solve(a)
    s_b, obj_b, _ = solve(b)
    assert np.array_equal(s_a[0], s_b[0])
    assert obj_a[0] == obj_b[0]
    assert obj_a[1] != obj_b[1]


def test_scenario_order_permutes_lanes():
    problem = make_problem()
    scs = [Scenario(name="baseline"), Scenario(name="cap2", num_gpus=2.0),
           Scenario(name="half_switch", switch_cost_scale=0.5)]
    fwd = solve(ScenarioBatch(problem, scs))[0]
    rev = solve(ScenarioBatch(problem, scs[::-1]))[0]
    for i in range(3):
        assert np.array_equal(fwd[i], rev[2 - i])


def test_job_mask_prices_the_market_without_the_job():
    problem = make_problem(num_jobs=8)
    mask = np.ones(8)
    mask[[2, 5]] = 0.0
    s_list, objs, _ = solve(ScenarioBatch(
        problem, [Scenario(name="without", job_mask=mask)]))
    assert np.all(s_list[0][[2, 5]] == 0.0)
    keep = mask > 0
    sub = dataclasses.replace(problem, **{
        f: np.asarray(getattr(problem, f))[keep] for f in (
            "priorities", "completed_epochs", "total_epochs",
            "epoch_duration", "remaining_runtime", "nworkers",
            "switch_cost", "incumbent")})
    s_sub, obj_sub, _ = eg_pdhg.solve_pdhg_relaxed(sub, device="cpu")
    assert objs[0] == pytest.approx(obj_sub, rel=1e-3)
    assert np.array_equal(s_list[0][keep] >= 0.5, np.asarray(s_sub) >= 0.5)


def test_lanes_are_the_scenarios_and_the_band_is_reported():
    """The launch takes exactly the scenarios (no inert lanes); the JAX
    package's power-of-two band is kept for reports."""
    problem = make_problem()
    for n, band in ((1, 1), (3, 4), (5, 8), (8, 8)):
        batch = ScenarioBatch(problem, [Scenario()] * n)
        assert batch.lanes == n and batch.band == band
        assert batch.packed().shape == (n, len(eg_pdhg.ROWS) + 1,
                                        batch.slots)
    with pytest.raises(ValueError, match="at least one"):
        ScenarioBatch(problem, [])


@pytest.mark.parametrize("places, n", [(8, 8), (4, 8), (2, 7), (4, 5),
                                       (3, 8)])
def test_sharded_scenario_axis_matches_single_device(places, n):
    """The scenario lanes over a mesh's places, one launch a place: each
    lane equal in every bit to the meshless call (tests/test_whatif.py:
    130-141); a mesh whose places do not divide the band runs the
    meshless call, as the JAX package."""
    problem = make_problem()
    batch = ScenarioBatch(problem, mixed_grid(problem, n=n))
    s_single, obj_single, diag_single = solve(batch)
    mesh = meshes.make_solve_mesh(["cpu"] * places, "scenarios")
    before = kernel.LAUNCHES["eg_pdhg"]
    s_mesh, obj_mesh, diag_mesh = solve(batch, mesh=mesh)
    assert kernel.LAUNCHES["eg_pdhg"] == before  # plain versions here
    for a, b in zip(s_single, s_mesh):
        np.testing.assert_array_equal(a, b)
    assert obj_single == obj_mesh
    assert [d["lanes"] for d in diag_mesh] == [n] * n
    per = batch.band // places
    assert diag_mesh[0]["chunk"] == (min(per, n) if batch.band % places == 0
                                     else diag_single[0]["chunk"])


def test_report_rows_carry_deltas():
    problem = make_problem()
    scs = [Scenario(name="baseline"), Scenario(name="cap12", num_gpus=12)]
    s_list, objs, diags = solve(ScenarioBatch(problem, scs))
    rows = scenario_report(problem, scs, s_list, objs, diags)
    assert rows[0]["nash_welfare_delta"] == 0.0
    assert rows[1]["capacity"] == 12
    assert rows[1]["nash_welfare_delta"] >= -1e-9


def test_scenario_metrics_equal_the_reference():
    """The report's host metrics (float64) on the same ``s``: equal to
    the JAX package's."""
    from shockwave_tpu.whatif import scenario_report as ref_report

    ref = ref_problem(num_jobs=12, seed=4)
    problem = port_problem(ref)
    grid = mixed_grid(problem, n=6)
    s_list, objs, diags = solve(ScenarioBatch(problem, grid))
    rows = scenario_report(problem, grid, s_list, objs, diags)
    ref_rows = ref_report(ref, mixed_grid(ref, n=6, scenario=RefScenario),
                          s_list, objs, diags)
    assert rows == ref_rows


# -- seeding from recorded state ------------------------------------------


def test_round_91_builds_the_references_problem():
    problem, keys, s0, rnd = base_problem_from_log(LOG, round_index=91)
    ref, ref_keys, ref_s0, ref_rnd = ref_from_log(LOG, round_index=91)
    assert rnd == ref_rnd == 91
    assert keys == ref_keys and problem.num_jobs == len(keys) > 0
    assert_same_problem(problem, ref)
    assert (s0 is None) == (ref_s0 is None)
    if s0 is not None:
        assert np.array_equal(s0, ref_s0)


def test_the_last_round_by_default_and_an_unknown_round_lists_rounds():
    _, keys, _, rnd = base_problem_from_log(LOG)
    _, ref_keys, _, ref_rnd = ref_from_log(LOG)
    assert rnd == ref_rnd and keys == ref_keys
    with pytest.raises(ValueError, match="recorded rounds"):
        recorder.extract_state(LOG, round_index=10**9)


def test_export_state_envelopes_cross_between_the_packages(tmp_path):
    """An artifact the JAX package exports loads in the port, and one the
    port exports loads in the JAX package: the same problem every way."""
    ref_out, out = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref_recorder.export_state(LOG, ref_out, round_index=91)
    extracted = recorder.export_state(LOG, out, round_index=91)
    assert extracted["out"] == out and extracted["round"] == 91
    ref, ref_keys, _ = ref_from_state(
        ref_recorder.load_exported_state(out)["planner_state"])
    for path in (ref_out, out):
        envelope = recorder.load_exported_state(path)
        assert envelope["event"] == "planner_state"
        assert envelope["round"] == 91
        problem, keys, _ = base_problem_from_state(envelope["planner_state"])
        assert keys == ref_keys
        assert_same_problem(problem, ref)
    with open(out) as f:
        assert json.load(f)["schema"] == ref_recorder.SCHEMA
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"event": "plan"}))
    with pytest.raises(ValueError, match="not an export-state"):
        recorder.load_exported_state(str(bad))


def test_a_cell_set_state_merges_into_the_references_global_market():
    """A ``cell_set`` state (the JAX package's federation after three
    rounds) merges into one market in both packages: per-cell rows
    concatenated, capacities summed, warm starts concatenated."""
    from test_torch_cells import CONFIG, ref_cell_planner, through_json

    state = ref_cell_planner({**CONFIG, "num_gpus": 6, "cells": 3}, 10,
                             3).state_dict()
    problem, keys, s0 = base_problem_from_state(through_json(state))
    ref, ref_keys, ref_s0 = ref_from_state(state)
    assert keys == ref_keys
    assert_same_problem(problem, ref)
    assert problem.num_gpus == 6
    assert np.array_equal(s0, ref_s0)


# -- the CLI --------------------------------------------------------------


def test_sweep_on_the_committed_log(tmp_path):
    out = str(tmp_path / "sweep.json")
    assert cli.main(["sweep", "--log", LOG, "--round", "91", "--capacity",
                     "1,2,4", "--priority-scale", "1,2", "--device", "cpu",
                     "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["audit"]["bit_identical"]
    assert report["audit"]["audited"] == 7
    assert report["timing"]["scenarios"] == report["timing"]["lanes"] == 7
    assert report["timing"]["lane_band"] == 8
    assert report["round"] == 91
    assert [r["name"] for r in report["scenarios"]][:2] == [
        "baseline", "g1_p1_s1_d60"]


def test_sweep_from_a_state_artifact_and_price_raises(tmp_path):
    state = str(tmp_path / "state.json")
    recorder.export_state(LOG, state, round_index=91)
    assert cli.main(["sweep", "--state", state, "--switch-scale", "0,1",
                     "--audit-lanes", "1", "--device", "cpu"]) == 0
    # ``price`` is ported (tests/test_torch_pricing.py): on the state
    # artifact it prices a burst and exits 0.
    out = str(tmp_path / "price.json")
    assert cli.main(["price", "--state", state, "--burst-jobs", "4",
                     "--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        assert json.load(f)["priced_decision"]["action"] in ("accept",
                                                             "reject")
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--device", "cpu"])


def test_sweep_solves_the_grid_as_one_batch(monkeypatch):
    """The sweep's report is the batch's: the standalone solves only time
    and audit it."""
    problem, _, s0, _ = base_problem_from_log(LOG, round_index=91)
    grid = cli.build_grid(problem, capacity="2,4", round_s="60,120")
    assert len(grid) == 5
    calls = []
    real = eg_pdhg.solve_lanes

    def counting(packed, *args, **kwargs):
        calls.append(len(packed))
        return real(packed, *args, **kwargs)

    monkeypatch.setattr("shockwave_tpu_torch.whatif.scenario.solve_lanes",
                        counting)
    report = cli.sweep(problem, grid, s0, "cpu", audit_n=2)
    # Warm-up batch and lane, the batch, five single lanes, two audits.
    assert calls == [5, 1, 5, 1, 1, 1, 1, 1, 1, 1]
    assert report["audit"]["audited"] == 2
    s_list, _, _ = solve(ScenarioBatch(problem, grid, s0=s0))
    s_one, _, _ = solve_scenario(ScenarioBatch(problem, grid, s0=s0), 3,
                                 device="cpu")
    assert np.array_equal(s_list[3], s_one)
