"""The port's telemetry building blocks against the JAX package's.

Each test drives the same operation sequence, with values drawn from a
seeded numpy generator, through both packages' ``obs`` classes and
compares what they emit. Every comparison is exact (bit-equal numbers,
byte-equal text and frames): the modules are pure Python and numpy, the
same in both packages, so any difference is a porting fault. Trace
events are compared under a virtual clock, without the wall seconds of
a span the clock did not advance over; the one field a producer names
itself (``otherData.producer``) is left out.
"""

import json

import numpy as np
import pytest

from shockwave_tpu import obs as jax_obs
from shockwave_tpu.obs import calibration as j_cal
from shockwave_tpu.obs import fleet as j_fleet
from shockwave_tpu.obs import history as j_hist
from shockwave_tpu.obs import metrics as j_met
from shockwave_tpu.obs import propagate as j_prop
from shockwave_tpu.obs import sketch as j_sk
from shockwave_tpu.obs import spantree as j_tree
from shockwave_tpu.obs import trace as j_trace
from shockwave_tpu_torch import obs
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.obs import calibration as p_cal
from shockwave_tpu_torch.obs import fleet as p_fleet
from shockwave_tpu_torch.obs import history as p_hist
from shockwave_tpu_torch.obs import metrics as p_met
from shockwave_tpu_torch.obs import propagate as p_prop
from shockwave_tpu_torch.obs import sketch as p_sk
from shockwave_tpu_torch.obs import spantree as p_tree
from shockwave_tpu_torch.obs import trace as p_trace
from shockwave_tpu_torch.tools import bench_sim


@pytest.fixture(autouse=True)
def _reset_planes():
    obs.reset()
    jax_obs.reset()
    yield
    obs.reset()
    jax_obs.reset()


def _drive_registry(mod, seed: int, budget=None):
    """One seeded operation sequence on a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry(enabled=True)
    if budget is not None:
        reg.set_series_budget(budget)
    reg.track_history("q_depth")
    c = reg.counter("jobs_total", "jobs")
    g = reg.gauge("q_depth", "queue depth")
    h = reg.histogram("solve_seconds", "solve time")
    hb = reg.histogram("ftf", "fairness", buckets=(0.5, 1.0, 2.0, 4.0))
    for step in range(60):
        c.inc(float(rng.integers(1, 4)), kind=str(rng.integers(0, 3)))
        g.set(float(rng.normal()), cell=f"c{rng.integers(0, 2)}")
        h.observe(float(rng.exponential(0.05)), backend="level")
        hb.observe_many(rng.gamma(2.0, 0.7, size=5).tolist(), pool="v100")
        reg.offer_exemplar("worst_jobs", int(rng.integers(0, 40)),
                           float(rng.random()), job=int(step))
        if step % 7 == 6:
            g.remove(cell="c0")
        if step % 10 == 9:
            reg.scale_tick(float(step))
    reg.remove_series(kind="2")
    return reg


@pytest.mark.parametrize("seed,budget", [(0, None), (1, None), (2, 12)],
                         ids=["seq0", "seq1", "budget-12"])
def test_registry_snapshot_and_prometheus_text_match(seed, budget):
    ours = _drive_registry(p_met, seed, budget)
    ref = _drive_registry(j_met, seed, budget)
    assert ours.snapshot() == ref.snapshot()
    assert ours.render_text() == ref.render_text()
    assert ours.snapshot()["schema"] == "shockwave-metrics-v1"
    snaps = [_drive_registry(p_met, s).snapshot() for s in (3, 4)]
    j_snaps = [_drive_registry(j_met, s).snapshot() for s in (3, 4)]
    assert p_met.merge_snapshots(snaps) == j_met.merge_snapshots(j_snaps)
    assert (p_met.render_snapshot_text(snaps[0], {"worker": "w1"})
            == j_met.render_snapshot_text(j_snaps[0], {"worker": "w1"}))
    merged = p_met.merge_snapshots(snaps)["metrics"]["solve_seconds"]
    for q in (0.5, 0.9, 0.99):
        assert (p_met.merged_histogram_quantile(merged, q)
                == j_met.merged_histogram_quantile(
                    j_met.merge_snapshots(j_snaps)["metrics"]
                    ["solve_seconds"], q))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_bins_quantiles_and_exact_merge(seed):
    """Same streams, same bins, sums and quantiles in both packages
    (singles, bulk adds, zeros and outliers); and the fleet-merge
    guarantee on tests/test_obs_scale.py's streams: two merged sketches
    equal, bit for bit, one that saw both streams."""
    rng = np.random.default_rng(seed)
    a = rng.lognormal(0.0, 1.5, 700)
    b = np.concatenate([rng.exponential(3.0, 300), [0.0, 1e-12, 1e9]])
    built = {}
    for name, mod in (("port", p_sk), ("jax", j_sk)):
        one, two = mod.QuantileSketch(), mod.QuantileSketch()
        one.add_many(a)
        for x in b:
            two.add(float(x))
        built[name] = (one.copy().merge(two), one, two)
    for p, j in zip(built["port"], built["jax"]):
        assert p.to_dict() == j.to_dict()
    merged, j_merged = built["port"][0], built["jax"][0]
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert merged.quantile(q) == j_merged.quantile(q)
    restored = p_sk.QuantileSketch.from_dict(j_merged.to_dict())
    assert restored.to_dict() == merged.to_dict()
    assert (p_sk.merge_sketch_dicts([None, merged.to_dict()]).to_dict()
            == j_sk.merge_sketch_dicts([None, j_merged.to_dict()]).to_dict())

    rng = np.random.default_rng(11)
    a_vals = rng.lognormal(2.0, 1.0, 4_000)
    b_vals = rng.uniform(0.1, 50.0, 4_000)
    x, y, one = (p_sk.QuantileSketch() for _ in range(3))
    x.add_many(a_vals)
    y.add_many(b_vals)
    one.add_many(np.concatenate([a_vals, b_vals]))
    assert x.merge(y).to_dict() == one.to_dict()


def test_snapshot_frames_are_byte_equal_and_cross_decode():
    snap = _drive_registry(p_met, 5).snapshot()
    j_snap = _drive_registry(j_met, 5).snapshot()
    frame = p_sk.encode_snapshot_frame(snap)
    assert frame == j_sk.encode_snapshot_frame(j_snap)
    assert j_sk.decode_snapshot_frame(frame) == snap
    assert p_sk.decode_snapshot_frame(frame[:-3]) is None


def test_history_and_exemplars_match():
    rng = np.random.default_rng(7)
    rings = [mod.RingHistory(16, 8, 3) for mod in (p_hist, j_hist)]
    res = [mod.ExemplarReservoir(5) for mod in (p_hist, j_hist)]
    for t in range(200):
        v, s = float(rng.normal()), float(rng.random())
        j = int(rng.integers(0, 30))
        for ring, reservoir in zip(rings, res):
            ring.append(float(t), v)
            reservoir.offer(j, s, round=t)
            if t % 11 == 0:
                reservoir.remove(j)
    assert rings[0].snapshot() == rings[1].snapshot()
    assert res[0].snapshot() == res[1].snapshot()
    assert res[0].evicted_by(99, 0.5) == res[1].evicted_by(99, 0.5)


def _drive_tracer(mod):
    clock = [0.0]
    tracer = mod.EventTracer(enabled=True)
    tracer.set_clock(lambda: clock[0])
    for r in range(20):
        clock[0] = 60.0 * r
        tracer.complete(f"round {r}", 60.0 * r, 60.0, cat="sched",
                        tid="rounds", args={"round": r})
        with tracer.span("replan", cat="plan", pid="solver",
                         tid="planner", args={"round": r}):
            pass
        tracer.instant("job_admitted", cat="job", tid="jobs",
                       args={"job_id": r}, ts_s=60.0 * r + 1.5)
        if r % 3 == 0:
            tracer.begin("lease", tid=f"job {r}")
            tracer.end("lease", tid=f"job {r}")
    return tracer.export_dict()


def test_trace_events_under_a_virtual_clock_match():
    ours, ref = _drive_tracer(p_trace), _drive_tracer(j_trace)

    def events(export):
        # A span the virtual clock did not advance over carries its
        # wall seconds (args.wall_s) as its duration: both are dropped.
        out = []
        for e in export["traceEvents"]:
            e = dict(e)
            if "wall_s" in e.get("args", {}):
                e["args"] = {k: v for k, v in e["args"].items()
                             if k != "wall_s"}
                e.pop("dur")
            out.append(e)
        return out

    assert events(ours) == events(ref)
    assert ours["displayTimeUnit"] == ref["displayTimeUnit"]
    assert ours["otherData"]["producer"] == "shockwave_tpu_torch.obs"


def test_calibration_tracker_publishes_what_the_jax_package_does():
    rng = np.random.default_rng(11)
    calls = []
    for job in range(6):
        total = float(rng.uniform(500, 5000))
        for t in range(0, int(total), 120):
            pred = (total - t) * float(rng.uniform(0.7, 1.4))
            calls.append(("f", job, float(t), pred, 0.8 * pred, 1.2 * pred,
                          float(t)))
        calls.append(("o" if job != 3 else "d", job, total))
    tables = []
    for planes, cal_mod in ((obs, p_cal), (jax_obs, j_cal)):
        planes.configure(metrics=True)
        tracker = cal_mod.CalibrationTracker(enabled=True)
        for c in calls:
            if c[0] == "f":
                tracker.record_forecast(c[1], c[2], c[3], c[4], c[5],
                                        ts_s=c[6], ape_floor_s=30.0)
            elif c[0] == "o":
                tracker.record_outcome(c[1], c[2])
            else:
                tracker.discard(c[1])
        tables.append(tracker.snapshot())
    ours = obs.get_registry().snapshot()
    ref = jax_obs.get_registry().snapshot()
    assert ours == ref and ours["metrics"]
    assert tables[0] == tables[1]


def test_propagation_and_span_trees_match_on_the_committed_fleet_trace():
    """The trace-context wire form round-trips between the packages, and
    the span-tree analysis of the JAX package's committed merged fleet
    trace (results/fleet_trace/) is the same in both."""
    ctx = p_prop.TraceContext("ab" * 16, "cd" * 8, None, True)
    wire = ctx.to_wire()
    assert wire == j_prop.TraceContext("ab" * 16, "cd" * 8).to_wire()
    back = j_prop.from_wire(wire)
    assert (back.trace_id, back.span_id, back.sampled) == (
        ctx.trace_id, ctx.span_id, True)
    assert p_prop.from_wire("garbage") is None
    with open(bench_sim.ROOT / "results/fleet_trace/merged_trace.json") as f:
        merged = json.load(f)
    events = merged["traceEvents"]
    assert p_tree.collect_chains(events) == j_tree.collect_chains(events)
    budgets = p_tree.latency_budget(events)
    assert budgets and budgets == j_tree.latency_budget(events)
    assert (p_tree.budget_fleet_summary(budgets)
            == j_tree.budget_fleet_summary(budgets))
    parts = []
    for name in ("scheduler_trace", "worker0_trace", "worker1_trace"):
        with open(bench_sim.ROOT / f"results/fleet_trace/{name}.json") as f:
            parts.append(json.load(f))
    ours, ref = p_tree.merge_traces(parts), j_tree.merge_traces(parts)
    assert ours["traceEvents"] == ref["traceEvents"]
    for meta in (ours["otherData"], ref["otherData"]):
        meta.pop("producer")
    assert ours["otherData"] == ref["otherData"]


def test_fleet_clock_estimator_and_frame_merge_match():
    rng = np.random.default_rng(3)
    est = [p_fleet.ClockEstimator(8), j_fleet.ClockEstimator(8)]
    for _ in range(40):
        sample = (0.25 + float(rng.normal(0, 1e-4)),
                  float(rng.uniform(-1e-4, 5e-3)))
        for e in est:
            e.add(sample)
    assert est[0].best() == est[1].best() and est[0].offset() is not None
    frames = [p_sk.encode_snapshot_frame(_drive_registry(p_met, s)
                                         .snapshot()) for s in (8, 9)]
    tele = []
    for planes, mod in ((obs, p_fleet), (jax_obs, j_fleet)):
        planes.configure(metrics=True)
        ft = mod.FleetTelemetry()
        for i, frame in enumerate(frames):
            ft.add_target(f"w{i}", lambda: "")
            assert ft.accept_frame(f"w{i}", frame)
        assert not ft.accept_frame("w9", frames[0])  # retired: dropped
        assert not ft.accept_frame("w0", b"not a frame")
        tele.append(ft)
    assert tele[0].merged_snapshot() == tele[1].merged_snapshot()
    assert tele[0].render() == tele[1].render()
    text = _drive_registry(p_met, 8).render_text()
    assert (p_fleet.relabel_prometheus_text(text, worker="w1")
            == j_fleet.relabel_prometheus_text(text, worker="w1"))


def test_lock_sanitizer_raises_on_an_inversion_and_is_raw_when_off():
    sanitize.configure(["locks"])
    try:
        a, b = sanitize.make_lock("t.a"), sanitize.make_lock("t.b")
        with a:
            with b:
                pass
        with pytest.raises(sanitize.LockOrderViolation):
            with b:
                with a:
                    pass
        with pytest.raises(sanitize.LockOrderViolation):
            with a:
                a.acquire()
        assert {"held": "t.a", "acquired": "t.b"}.items() <= \
            sanitize.report()["locks"]["edges"][0].items()
    finally:
        sanitize.configure(None)
        sanitize.reset()
    assert type(sanitize.make_lock("t.c")) is not sanitize.SanitizedLock


def test_registry_and_tracer_locks_come_from_the_sanitizer():
    """The speculation thread publishes into the registry and the tracer:
    both lock through ``sanitize.make_lock``, so the lock sanitizer sees
    them."""
    sanitize.configure(["locks"])
    try:
        assert isinstance(p_met.MetricsRegistry()._lock,
                          sanitize.SanitizedLock)
        assert isinstance(p_trace.EventTracer()._lock,
                          sanitize.SanitizedLock)
    finally:
        sanitize.configure(None)


def test_disabled_telemetry_is_inert_and_result_identical(tmp_path):
    """Every plane off is the default and records nothing; a golden run
    with every plane on takes the same decisions as one with every plane
    off (the counterpart of tests/test_obs.py::
    test_disabled_telemetry_is_inert_and_result_identical)."""
    from shockwave_tpu_torch import simulate

    assert obs.counter("x") is obs._NULL
    assert not obs.enabled() and not obs.get_recorder().enabled
    args = ["-t", str(bench_sim.GOLDEN_TRACE), "-p", "shockwave_tpu_pdhg",
            "-c", "v100=8", "--time_per_iteration", "120", "--device",
            "cpu", "--no_profile_cache", "--round_log"]
    off = simulate.main(args + [str(tmp_path / "off.jsonl")])
    on = simulate.main(args + [
        str(tmp_path / "on.jsonl"), "--metrics-out", str(tmp_path / "m.json"),
        "--trace-out", str(tmp_path / "t.json"), "--decision-log",
        str(tmp_path / "d.jsonl"), "--watchdog"])
    for key in ("makespan", "avg_jct", "worst_ftf", "rounds",
                "num_preemptions", "solves"):
        assert on[key] == off[key], key
    assert ((tmp_path / "on.jsonl").read_text()
            == (tmp_path / "off.jsonl").read_text())
    # main resets every plane when it ends.
    assert not obs.enabled() and not obs.get_recorder().enabled
