"""The port's survivable control plane (``shockwave_tpu_torch/ha/``, the
HA half of ``core/physical.py``, the worker's outage path) against the
JAX package's: a counterpart for each test of ``tests/test_ha.py``.

Where the JAX test has an observable result it runs through both
packages. The journal and the lease are files of one format, so their
tests run a writer of one package against a reader of the other (``WR``:
the port alone, and each package against the other); a scheduler's state
captured by one package is restored by the other. The live SIGKILL
failover is in ``tests/test_torch_failover.py``.
"""

import importlib
import json
import os
import time
import types
import zlib

import numpy as np
import pytest

from shockwave_tpu_torch.runtime.testing import free_port

PKG = {"jax": "shockwave_tpu", "port": "shockwave_tpu_torch"}
# (writer, reader) package pairs of the file-format tests.
WR = [("port", "port"), ("port", "jax"), ("jax", "port")]
BOTH = ["jax", "port"]


def pkg(name):
    """The modules of one package the tests use."""
    base = PKG[name]

    def mod(path):
        return importlib.import_module(f"{base}.{path}")

    return types.SimpleNamespace(
        name=name,
        JobId=mod("core.ids").JobId,
        Job=mod("core.job").Job,
        codec=mod("ha.codec"),
        election=mod("ha.election"),
        journal=mod("ha.journal"),
        frontdoor=mod("ha.frontdoor"),
        physical=mod("core.physical"),
        scheduler=mod("core.scheduler"),
        policies=mod("policies"),
        oracle=mod("data.default_oracle"),
        admission=mod("runtime.admission"),
        faults=mod("runtime.faults"),
        retry=mod("runtime.retry"),
        recorder=mod("obs.recorder"),
    )


def encoded(p, value) -> str:
    return json.dumps(p.recorder.encode(value))


# ----------------------------------------------------------------------
# Journal
# ----------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", WR)
def test_journal_checkpoint_and_tail_replay(tmp_path, writer, reader):
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir)
    journal.append("submit", {"token": "t0", "n": 2}, epoch=1)
    journal.append("admit", {"job_id": 0}, epoch=1)
    journal.checkpoint({"fields": {"round": 3}}, epoch=1)
    journal.append(
        "done", {"job_ids": (w.JobId(0),), "steps": np.asarray([5, 7])},
        epoch=1,
    )
    snap = r.journal.ControlPlaneJournal.replay(jdir)
    assert snap.checkpoint == {"fields": {"round": 3}}
    assert [e["kind"] for e in snap.entries] == ["done"]
    payload = snap.entries[0]["payload"]
    assert payload["job_ids"] == (r.JobId(0),)
    assert payload["steps"].tolist() == [5, 7]
    assert snap.last_epoch == 1 and snap.last_lsn == 3 and snap.seq == 1
    assert r.journal.SCHEMA == w.journal.SCHEMA == "shockwave-ha-journal-v1"


@pytest.mark.parametrize("writer,reader", WR)
def test_journal_cold_start_replays_wal_without_checkpoint(tmp_path, writer,
                                                           reader):
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir)
    journal.append("submit", {"token": "t0"}, epoch=1)
    journal.append("admit", {"job_id": 0}, epoch=1)
    snap = r.journal.ControlPlaneJournal.replay(jdir)
    assert snap.checkpoint is None
    assert [e["kind"] for e in snap.entries] == ["submit", "admit"]
    assert r.journal.ControlPlaneJournal.summarize(jdir) == (
        w.journal.ControlPlaneJournal.summarize(jdir))


@pytest.mark.parametrize("writer,reader", WR)
def test_journal_writer_reopen_continues_lsn(tmp_path, writer, reader):
    """A writer of one package, then a writer of the other reopening the
    journal: the LSNs continue."""
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    first = w.journal.ControlPlaneJournal(jdir)
    first.append("a", {}, epoch=1)
    first.checkpoint({"x": 1}, epoch=1)
    first.append("b", {}, epoch=1)
    reopened = r.journal.ControlPlaneJournal(jdir)
    lsn = reopened.append("c", {}, epoch=2)
    assert lsn == 3
    snap = w.journal.ControlPlaneJournal.replay(jdir)
    assert [e["kind"] for e in snap.entries] == ["b", "c"]
    assert snap.entries[-1]["lsn"] == lsn
    assert snap.last_epoch == 2


@pytest.mark.parametrize("writer,reader", WR)
def test_journal_truncated_final_line_is_skipped(tmp_path, writer, reader):
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir)
    journal.append("a", {"ok": True}, epoch=1)
    wal = os.path.join(jdir, "wal-00000000.jsonl")
    with open(wal, "a") as f:
        f.write('{"lsn": 99, "kind": "tr')  # an append the crash cut
    snap = r.journal.ControlPlaneJournal.replay(jdir)
    assert [e["kind"] for e in snap.entries] == ["a"]
    # A writer reopening it resumes after the last whole record.
    assert r.journal.ControlPlaneJournal(jdir).append("b", {}) == 1


@pytest.mark.parametrize("writer,reader", WR)
def test_journal_corrupt_middle_line_raises(tmp_path, writer, reader):
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir)
    journal.append("a", {}, epoch=1)
    wal = os.path.join(jdir, "wal-00000000.jsonl")
    with open(wal, "a") as f:
        f.write("garbage\n")
        f.write(json.dumps({"lsn": 5, "kind": "b", "payload": {}}) + "\n")
    with pytest.raises(ValueError, match="corrupt WAL record"):
        r.journal.ControlPlaneJournal.replay(jdir)


@pytest.mark.parametrize("writer,reader", WR)
def test_journal_gc_retains_configured_generations(tmp_path, writer, reader):
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir, retain=2)
    for i in range(5):
        journal.append("tick", {"i": i}, epoch=1)
        journal.checkpoint({"i": i}, epoch=1)
    names = sorted(os.listdir(jdir))
    ckpts = [n for n in names if n.startswith("checkpoint-")]
    assert ckpts == ["checkpoint-00000004.json", "checkpoint-00000005.json"]
    snap = r.journal.ControlPlaneJournal.replay(jdir)
    assert snap.checkpoint == {"i": 4} and snap.entries == []


@pytest.mark.parametrize("writer,reader", WR)
def test_journal_falls_back_a_generation_on_damaged_checkpoint(
        tmp_path, writer, reader):
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir, retain=3)
    journal.append("early", {}, epoch=1)
    journal.checkpoint({"gen": 1}, epoch=1)
    journal.append("mid", {}, epoch=1)
    journal.checkpoint({"gen": 2}, epoch=1)
    journal.append("late", {}, epoch=1)
    with open(os.path.join(jdir, "checkpoint-00000002.json"), "w") as f:
        f.write("not json")
    snap = r.journal.ControlPlaneJournal.replay(jdir)
    assert snap.checkpoint == {"gen": 1}
    assert [e["kind"] for e in snap.entries] == ["mid", "late"]
    # A writer reopening it mints past every generation's LSNs.
    assert r.journal.ControlPlaneJournal(jdir).append("x", {}) == 5


def test_journal_lines_are_the_jax_packages_bytes(tmp_path):
    """The same appends and checkpoint write the same bytes in both
    packages."""
    files = {}
    for name in BOTH:
        p = pkg(name)
        jdir = tmp_path / name
        journal = p.journal.ControlPlaneJournal(str(jdir))
        journal.append("dispatch", {"job_ids": [p.JobId(0, 1)],
                                    "worker_ids": [0, 1], "round": 2},
                       epoch=3)
        journal.checkpoint({"sets": {1, 2}, "t": (1.5, "x")}, epoch=3)
        journal.append("done", {"steps": np.asarray([4], np.int64)},
                       epoch=3)
        files[name] = {f: (jdir / f).read_text()
                       for f in sorted(os.listdir(jdir))}
    assert files["port"] == files["jax"]
    assert len(files["port"]) == 3


# ----------------------------------------------------------------------
# Election and fenced epochs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("a_pkg,b_pkg", WR)
def test_lease_epoch_is_monotonic_and_exclusive(tmp_path, a_pkg, b_pkg):
    a_mod, b_mod = pkg(a_pkg).election, pkg(b_pkg).election
    store_a = a_mod.LeaseStore(str(tmp_path), ttl_s=0.3)
    store_b = b_mod.LeaseStore(str(tmp_path), ttl_s=0.3)
    a = a_mod.LeaderElection(store_a, "A")
    b = b_mod.LeaderElection(store_b, "B")
    lease_a = a.acquire(sched_addr="127.0.0.1", sched_port=1, block=False)
    assert lease_a.epoch == 1 and a.is_leader()
    assert b.acquire(block=False) is None
    time.sleep(0.4)
    lease_b = b.acquire(sched_addr="127.0.0.1", sched_port=2, block=False)
    assert lease_b.epoch == 2
    with pytest.raises(a_mod.LeaseLost):
        store_a.renew(lease_a)
    again = b.acquire(sched_addr="127.0.0.1", sched_port=2, block=False)
    assert again.epoch == 2
    assert store_a.read().to_dict() == again.to_dict()


@pytest.mark.parametrize("a_pkg,b_pkg", WR)
def test_lease_release_hands_over_without_ttl_wait(tmp_path, a_pkg, b_pkg):
    a_mod, b_mod = pkg(a_pkg).election, pkg(b_pkg).election
    store = a_mod.LeaseStore(str(tmp_path), ttl_s=30.0)
    a = a_mod.LeaderElection(store, "A")
    b = b_mod.LeaderElection(b_mod.LeaseStore(str(tmp_path), ttl_s=30.0),
                             "B")
    lease_a = a.acquire(block=False)
    assert b.acquire(block=False) is None
    store.release(lease_a)
    # The holder's own renewal cannot bring a released term back.
    with pytest.raises(a_mod.LeaseLost, match="released"):
        store.renew(lease_a)
    lease_b = b.acquire(block=False)
    assert lease_b is not None and lease_b.epoch == 2


@pytest.mark.parametrize("writer,reader", WR)
def test_lease_doubles_as_front_door_map(tmp_path, writer, reader):
    w, r = pkg(writer), pkg(reader)
    store = w.election.LeaseStore(str(tmp_path), ttl_s=30.0)
    election = w.election.LeaderElection(store, "A")
    election.acquire(sched_addr="127.0.0.1", sched_port=5000, block=False)
    election.publish(
        admission_ports={"s00": 6000, "s01": 6001, "s02": 6002}
    )
    target = r.frontdoor.resolve_submit_target(str(tmp_path), "some-token")
    addr, port, epoch = target
    assert addr == "127.0.0.1" and epoch == 1
    assert port == [6000, 6001, 6002][zlib.crc32(b"some-token") % 3]
    assert r.frontdoor.shard_port_for_token({}, "t") is None
    for token in ("a", "b", "tok-7", ""):
        ports = {"s00": 1, "s01": 2}
        assert r.frontdoor.shard_port_for_token(ports, token) == (
            w.frontdoor.shard_port_for_token(ports, token))


@pytest.mark.parametrize("name", BOTH)
def test_renewal_thread_fences_on_newer_epoch(tmp_path, name):
    e = pkg(name).election
    store = e.LeaseStore(str(tmp_path), ttl_s=0.4)
    a = e.LeaderElection(store, "A", renew_interval_s=0.1)
    b = e.LeaderElection(store, "B")
    a.acquire(block=False)
    fenced = []
    a.start_renewal(on_lost=lambda: fenced.append(True))
    time.sleep(0.5)
    # A renews every 0.1 s, so its lease never runs out: take it by a
    # release, then let B mint epoch 2.
    store.release(a.lease or store.read())
    assert b.acquire(block=False) is not None
    deadline = time.time() + 3
    while not fenced and time.time() < deadline:
        time.sleep(0.05)
    a.stop(release=False)
    assert fenced == [True]
    assert a.lease is None and a.epoch == 0 and b.epoch == 2


# ----------------------------------------------------------------------
# Codec
# ----------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", WR)
def test_job_codec_roundtrips_declared_and_dynamic_fields(writer, reader):
    w, r = pkg(writer), pkg(reader)
    job = w.Job(
        job_type="ResNet-18 (batch size 32)", command="x 32",
        total_steps=100, scale_factor=2, mode="gns", tenant="teamA",
    )
    job.arrival_time = 12.5  # attached by the submitter
    text = json.dumps(w.recorder.encode(w.codec.job_state(job)))
    restored = r.codec.job_from_state(r.recorder.decode(json.loads(text)))
    assert isinstance(restored, r.Job)
    assert vars(restored) == vars(job)


def test_state_fingerprint_is_stable_and_content_sensitive():
    codec, JobId = pkg("port").codec, pkg("port").JobId
    a = {"x": np.arange(4), "y": (JobId(1), 2)}
    same = {"x": np.arange(4), "y": (JobId(1), 2)}
    assert codec.state_fingerprint(a) == codec.state_fingerprint(same)
    assert codec.state_fingerprint(
        codec.json_roundtrip(a)) == codec.state_fingerprint(a)
    c = {"x": np.arange(4), "y": (JobId(2), 2)}
    assert codec.state_fingerprint(a) != codec.state_fingerprint(c)
    # The same value's encoding is the JAX package's text.
    jax = pkg("jax")
    assert codec.to_json(a) == json.dumps(jax.recorder.encode(
        {"x": np.arange(4), "y": (jax.JobId(1), 2)}))


# ----------------------------------------------------------------------
# Scheduler state capture and restore
# ----------------------------------------------------------------------
def fresh_physical(p, **kwargs):
    policy = (p.policies.get_policy("fifo", device="cpu") if p.name == "port"
              else p.policies.get_policy("fifo"))
    return p.physical.PhysicalScheduler(
        policy, port=free_port(), throughputs=p.oracle.generate_oracle(),
        time_per_iteration=3.0, **kwargs,
    )


def make_job(p, steps=400, **kwargs):
    return p.Job(
        job_type="ResNet-18 (batch size 32)", command="x 32",
        total_steps=steps, scale_factor=1, mode="static", **kwargs,
    )


def spec(p, job):
    return p.admission.job_to_spec_dict(job)


# The two packages' captures differ in scope (the JAX package keeps a few
# more fields and all profiles); this is what both hold.
COMMON_SETS = ("_completed_jobs", "_fault_tainted", "_running_jobs")
PHYSICAL_SETS = ("consumed_sched_faults", "extended_leases", "outstanding",
                 "retired_workers")


def common_view(p, state, clock=False) -> str:
    """``state`` (a decoded capture of either package) reduced to what
    both packages capture, as the reading package's codec text, with
    sets as sorted lists (ROADMAP.md, queue 3) and, unless ``clock``,
    the continuing clock zeroed."""
    both = set(pkg("jax").scheduler.Scheduler._HA_STATE_FIELDS)
    view = {
        "fields": {f: state["fields"][f]
                   for f in pkg("port").scheduler.Scheduler._HA_STATE_FIELDS
                   if f in both},
        "sets": {f: sorted(state["sets"][f]) for f in COMMON_SETS},
        "jobs": state["jobs"],
        "physical": dict(state.get("physical") or {}),
        "planner": state.get("planner"),
    }
    for f in PHYSICAL_SETS:
        if f in view["physical"]:
            view["physical"][f] = sorted(view["physical"][f])
    if not clock:
        view["physical"]["now"] = 0.0
        view["fields"]["_current_timestamp"] = 0.0
    return encoded(p, view)


def _dispatch_all(s1):
    assignments = s1._schedule_jobs_on_workers()
    for key, wids in assignments.items():
        s1._dispatched_worker_ids[key] = tuple(wids)
        for wid in wids:
            s1._outstanding.add((key, wid))
        for single in key.singletons():
            s1._running_jobs.add(single)
            s1._per_job_latest_timestamps[single] = (
                s1.get_current_timestamp())


@pytest.mark.parametrize("writer,reader", WR + [("jax", "jax")])
def test_physical_state_roundtrips_exactly_modulo_clock(writer, reader):
    """A capture of one package restored by the other: its recapture
    equals the capture on what both hold, but for the clock and the
    deliberate failover adjustments; the restored front door dedups the
    token admitted before the crash."""
    w, r = pkg(writer), pkg(reader)
    s1 = fresh_physical(w)
    try:
        s1.register_worker("v100", num_gpus=1)
        s1.register_worker("v100", num_gpus=1)
        s1.expect_stream()
        status, _, _, _ = s1.submit_batch(
            "tokA", [spec(w, make_job(w, 500))], False)
        assert status == "ACCEPTED"
        for _ in range(3):
            s1.add_job(make_job(w))
        _dispatch_all(s1)
        text = json.dumps(w.recorder.encode(s1.ha_state_dict()))
    finally:
        s1.shutdown()
    state = r.recorder.decode(json.loads(text))
    s2 = fresh_physical(r)
    try:
        s2.restore_ha_state(state)
        recaptured = r.codec.json_roundtrip(s2.ha_state_dict())
        for side in (state, recaptured):
            side["physical"]["last_lease_contact"] = {}
            side["physical"]["extended_leases"] = []
        assert common_view(r, recaptured) == common_view(r, state)
        status, _, admitted, _ = s2.submit_batch(
            "tokA", [spec(r, make_job(r, 500))], False)
        assert status == "ACCEPTED" and admitted == 1
        assert s2._admission.summary()["deduped_batches"] == 1
        assert s2._outstanding
        for key, _wid in s2._outstanding:
            assert key in s2._jobs_with_extended_lease
    finally:
        s2.shutdown()


def test_port_capture_lists_sets_sorted():
    """The port lists the physical capture's sets sorted, so a capture's
    text depends on the members, not the sets' histories (ROADMAP.md,
    queue 3); the JAX package lists them in iteration order."""
    p = pkg("port")
    s1 = fresh_physical(p)
    try:
        s1._retired_workers.update([9, 3, 7])
        s1._jobs_with_extended_lease.update([p.JobId(5), p.JobId(2)])
        physical = s1.ha_state_dict()["physical"]
        assert physical["retired_workers"] == [3, 7, 9]
        assert physical["extended_leases"] == [p.JobId(2), p.JobId(5)]
    finally:
        s1.shutdown()


@pytest.mark.parametrize("name", BOTH)
def test_restored_job_completion_cleans_priorities(name):
    p = pkg(name)
    s1 = fresh_physical(p)
    try:
        s1.register_worker("v100", num_gpus=1)
        s1.register_worker("v100", num_gpus=1)
        jids = [s1.add_job(make_job(p)) for _ in range(3)]
        _dispatch_all(s1)
        s1._outstanding.clear()
        state = p.codec.json_roundtrip(s1.ha_state_dict())
    finally:
        s1.shutdown()
    s2 = fresh_physical(p)
    try:
        s2.restore_ha_state(state)
        key = jids[0]
        worker_id = state["physical"]["dispatched_worker_ids"][key][0]
        s2._done_callback(key, worker_id, [400], [2.0])
        assert key not in s2._jobs
        for per_type in s2._priorities.values():
            assert key not in per_type
        s2._schedule_jobs_on_workers()
    finally:
        s2.shutdown()


@pytest.mark.parametrize("writer,reader", WR + [("jax", "jax")])
def test_journal_replay_restores_jobs_ledger_and_outstanding(
        tmp_path, writer, reader):
    """A leader of one package journals a checkpoint and a tail (submit,
    admit, dispatch, done, submit) and is abandoned; a successor of the
    other, built from the journal alone, carries the jobs, the ledger,
    the progress and the in-flight set, and the two packages' restores
    of the same journal agree."""
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    s1 = fresh_physical(w, ha_journal=w.journal.ControlPlaneJournal(jdir))
    try:
        s1.register_worker("v100", num_gpus=1)
        s1.register_worker("v100", num_gpus=1)
        s1.expect_stream()
        with s1._cv:
            s1._ha_checkpoint()
        status, _, _, _ = s1.submit_batch(
            "tok0", [spec(w, make_job(w, 600))], False)
        assert status == "ACCEPTED"
        with s1._cv:
            assert s1._drain_admission_queue() == 1
        key = w.JobId(0)
        with s1._cv:
            s1._ha_log("dispatch",
                       {"job_ids": [0], "worker_ids": [0], "round": 0})
            s1._outstanding.add((key, 0))
            s1._dispatched_worker_ids[key] = (0,)
            s1._running_jobs.add(key)
            s1._per_job_latest_timestamps[key] = s1.get_current_timestamp()
            s1._ha_log("done", {"job_ids": [0], "worker_id": 0,
                                "steps": [250], "times": [1.5]})
            s1._outstanding.discard((key, 0))
            s1._done_callback(key, 0, [250], [1.5])
        s1.submit_batch("tok1", [spec(w, make_job(w, 500))], False)
    finally:
        s1.shutdown()

    snap = r.journal.ControlPlaneJournal.replay(jdir)
    assert snap.checkpoint is not None
    assert [e["kind"] for e in snap.entries] == [
        "submit", "admit", "dispatch", "done", "submit"]
    s2 = fresh_physical(r, ha_journal=r.journal.ControlPlaneJournal(jdir))
    try:
        assert s2.restore_from_journal(snap) == {
            "submit": 2, "admit": 1, "dispatch": 1, "done": 1}
        assert list(s2._jobs) == [r.JobId(0)]
        assert s2._total_steps_run[r.JobId(0)] == 250
        assert s2._admission.depth() == 1
        assert s2._admission.summary()["tokens"] == 2
        snap2 = r.journal.ControlPlaneJournal.replay(jdir)
        assert snap2.checkpoint is not None and snap2.entries == []
        for token in ("tok0", "tok1"):
            status, _, _, _ = s2.submit_batch(
                token, [spec(r, make_job(r, 500))], False)
            assert status == "ACCEPTED"
        assert s2._admission.summary()["deduped_batches"] == 2
    finally:
        s2.shutdown()


@pytest.mark.parametrize("name", BOTH)
def test_sim_scheduler_crash_restart_is_bit_identical(name):
    """The simulator's seeded scheduler_crash / scheduler_restart round
    trip the control plane through the journal's codec mid-run; the
    campaign ends exactly as the plain one, and the port's equals the JAX
    package's."""
    p = pkg(name)

    def run(plan):
        p.faults.reset()
        if plan is not None:
            p.faults.configure(plan)
        sched = p.scheduler.Scheduler(
            (p.policies.get_policy("max_min_fairness")),
            throughputs=p.oracle.generate_oracle(),
            time_per_iteration=60.0, seed=0,
        )
        jobs = [make_job(p, 2000 + 307 * i) for i in range(4)]
        makespan = sched.simulate(
            {"v100": 2}, arrival_times=[0.0, 10.0, 20.0, 30.0], jobs=jobs)
        result = (makespan, sched.get_average_jct(),
                  {str(k): v for k, v in sched._total_steps_run.items()})
        p.faults.reset()
        return result

    base = run(None)
    plan = p.faults.FaultPlan(seed=0, events=[
        p.faults.FaultEvent(0, "scheduler_crash", at_s=90.0),
        p.faults.FaultEvent(1, "scheduler_restart", at_s=130.0),
    ])
    assert run(plan) == base
    if name == "port":  # the JAX package's campaign
        jax = pkg("jax")
        jax_sched = jax.scheduler.Scheduler(
            jax.policies.get_policy("max_min_fairness"),
            throughputs=jax.oracle.generate_oracle(),
            time_per_iteration=60.0, seed=0)
        makespan = jax_sched.simulate(
            {"v100": 2}, arrival_times=[0.0, 10.0, 20.0, 30.0],
            jobs=[make_job(jax, 2000 + 307 * i) for i in range(4)])
        assert base[0] == makespan
        assert base[1] == jax_sched.get_average_jct()


@pytest.mark.parametrize("name", BOTH)
def test_generate_churn_plan_scheduler_faults_are_paired(name):
    faults = pkg(name).faults
    plan = faults.generate_churn_plan(
        seed=3, horizon_s=600.0, num_workers=8, target_events=40,
        scheduler_faults=2,
    )
    crashes = [e for e in plan.events if e.kind == "scheduler_crash"]
    restarts = [e for e in plan.events if e.kind == "scheduler_restart"]
    assert len(crashes) == 2 and len(restarts) == 2
    for crash, restart in zip(crashes, restarts):
        assert restart.at_s > crash.at_s
    restored = faults.FaultPlan.from_json(plan.to_json())
    assert [e.kind for e in restored.events] == [
        e.kind for e in plan.events]
    injector = faults.FaultInjector(plan)
    assert any(e.kind == "scheduler_crash"
               for e in injector.due_cluster_events(crashes[0].at_s))
    # The port's plan is the JAX package's, event for event.
    other = pkg("jax" if name == "port" else "port").faults
    assert plan.to_json() == other.generate_churn_plan(
        seed=3, horizon_s=600.0, num_workers=8, target_events=40,
        scheduler_faults=2).to_json()


# ----------------------------------------------------------------------
# Fenced epochs on the wire
# ----------------------------------------------------------------------
def test_new_wire_fields_roundtrip_and_stay_legacy_compatible():
    from shockwave_tpu.runtime.protobuf import (
        scheduler_to_worker_pb2 as jax_s2w,
        worker_to_scheduler_pb2 as jax_w2s,
    )
    from shockwave_tpu_torch.runtime.protobuf import (
        scheduler_to_worker_pb2 as s2w,
        worker_to_scheduler_pb2 as w2s,
    )

    for mod_w2s in (w2s, jax_w2s):
        req = mod_w2s.RegisterWorkerRequest(
            worker_type="v100", num_accelerators=2, ip_addr="10.0.0.1",
            port=50061, prev_worker_ids=[3, 4], outstanding_job_ids=[7, 9])
        if mod_w2s is w2s:
            port_bytes = req.SerializeToString()
        else:
            assert req.SerializeToString() == port_bytes
    parsed = w2s.RegisterWorkerRequest.FromString(port_bytes)
    assert parsed.prev_worker_ids == [3, 4]
    assert parsed.outstanding_job_ids == [7, 9]
    resp = w2s.RegisterWorkerResponse(
        success=True, worker_ids=[3, 4], round_duration=3, sched_epoch=5,
        reattached=True)
    data = resp.SerializeToString()
    assert data == jax_w2s.RegisterWorkerResponse(
        success=True, worker_ids=[3, 4], round_duration=3, sched_epoch=5,
        reattached=True).SerializeToString()
    parsed = w2s.RegisterWorkerResponse.FromString(data)
    assert parsed.sched_epoch == 5 and parsed.reattached
    assert w2s.HeartbeatAck.FromString(
        w2s.HeartbeatAck(sched_epoch=4).SerializeToString()).sched_epoch == 4
    run = s2w.RunJobRequest(worker_id=1, round_id=2, sched_epoch=9)
    assert run.SerializeToString() == jax_s2w.RunJobRequest(
        worker_id=1, round_id=2, sched_epoch=9).SerializeToString()
    assert s2w.RunJobRequest.FromString(
        run.SerializeToString()).sched_epoch == 9
    kill = s2w.KillJobRequest(job_id=5, sched_epoch=9)
    assert s2w.KillJobRequest.FromString(
        kill.SerializeToString()).sched_epoch == 9
    legacy_bytes = w2s.RegisterWorkerRequest(
        worker_type="v100", num_accelerators=2, ip_addr="10.0.0.1",
        port=50061).SerializeToString()
    assert b"\x32" not in legacy_bytes[-2:]  # no field-6 tail
    assert s2w.KillJobRequest(job_id=5).SerializeToString() == (
        s2w.KillJobRequest(job_id=5, sched_epoch=0).SerializeToString())


def test_worker_fences_stale_epoch_dispatch():
    """A deposed leader's RunJob and KillJob bounce with the status the
    plane treats as permanent once the worker has seen a newer epoch;
    the current epoch and unfenced (epoch 0) RPCs pass."""
    from shockwave_tpu_torch.runtime.retry import (
        PermanentRpcError,
        RetryPolicy,
    )
    from shockwave_tpu_torch.runtime.rpc import worker_server
    from shockwave_tpu_torch.runtime.rpc.scheduler_client import (
        SchedulerRpcClient,
    )
    from shockwave_tpu_torch.runtime.worker import _EpochWitness

    witness = _EpochWitness()
    witness.witness(5)
    ran = []
    port = free_port()
    server = worker_server.serve(
        port,
        {
            "run_job": lambda jobs, wid, rid: ran.append(("run", rid)),
            "kill_job": lambda job_id: ran.append(("kill", job_id)),
            "reset": lambda: None,
            "shutdown": lambda: None,
            "fence_epoch": witness.witness,
        },
    )
    try:
        client = SchedulerRpcClient(
            "127.0.0.1", port,
            retry=RetryPolicy(attempts=2, deadline_s=5.0, call_timeout_s=2.0),
        )
        with pytest.raises(PermanentRpcError, match="fenced"):
            client.run_job([], worker_id=0, round_id=1, sched_epoch=4)
        with pytest.raises(PermanentRpcError, match="fenced"):
            client.kill_job(3, sched_epoch=2)
        assert ran == []
        client.run_job([], worker_id=0, round_id=2, sched_epoch=5)
        client.kill_job(3, sched_epoch=0)
        assert ran == [("run", 2), ("kill", 3)]
        witness.witness(6)
        with pytest.raises(PermanentRpcError, match="fenced"):
            client.run_job([], worker_id=0, round_id=3, sched_epoch=5)
    finally:
        server.stop(grace=1)


def test_a_fenced_dispatch_deposes_the_leader():
    """A worker's epoch gate bouncing RunJob makes the scheduler call
    ``_ha_fenced``: it stops dispatching, leaves the micro-task to the
    successor (no fault completion) and shuts down without touching the
    fleet."""
    from shockwave_tpu_torch.runtime.retry import PermanentRpcError

    p = pkg("port")
    sched = fresh_physical(p)
    calls = []

    class FencedClient:
        def run_job(self, descriptions, worker_id, round_id, sched_epoch=0):
            calls.append(("run_job", worker_id))
            raise PermanentRpcError("fenced: epoch 1 below 2")

        def shutdown(self):
            calls.append(("shutdown",))

    try:
        sched.register_worker("v100", num_gpus=1)
        sched._worker_connections[0] = FencedClient()
        sched._worker_addrs[0] = ("127.0.0.1", 1)
        job_id = sched.add_job(make_job(p))
        with sched._cv:
            sched._dispatch(job_id, (0,))
        assert sched._ha_deposed and sched._shutdown_requested.is_set()
        assert calls == [("run_job", 0)]  # no Shutdown to the fleet
        assert sched._outstanding == set()
        assert sched._total_steps_run.get(job_id, 0) == 0
        assert sched._num_failures_per_job.get(job_id, 0) == 0
    finally:
        sched.shutdown()


# ----------------------------------------------------------------------
# The worker's outage handling
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", BOTH)
def test_scheduler_outage_threshold_and_accounting(name):
    SchedulerOutage = pkg(name).retry.SchedulerOutage
    outage = SchedulerOutage(threshold=3)
    assert not outage.record_failure()
    assert not outage.record_failure()
    assert not outage.in_outage()
    assert outage.record_failure()
    assert outage.in_outage()
    time.sleep(0.05)
    accounted = outage.outage_seconds()
    assert accounted > 0.0
    outage.record_success()
    assert not outage.in_outage()
    assert outage.outage_seconds() >= accounted
    outage.record_failure()
    assert not outage.in_outage()


@pytest.mark.parametrize("name", BOTH)
def test_outage_threshold_env_knob(monkeypatch, name):
    monkeypatch.setenv("SHOCKWAVE_OUTAGE_BEATS", "1")
    outage = pkg(name).retry.SchedulerOutage()
    assert outage.record_failure()


def test_dispatcher_buffers_dones_during_outage(tmp_path):
    """With the scheduler unreachable, Done reports buffer; the flush
    delivers them oldest first once contact returns."""
    from shockwave_tpu_torch.runtime.dispatcher import Dispatcher
    from shockwave_tpu_torch.runtime.retry import SchedulerOutage

    class FlakyClient:
        def __init__(self):
            self.delivered = []
            self.fail = True

        def notify_scheduler(self, worker_id, job_ids, steps, durations,
                             logs, trace_contexts=None):
            if self.fail:
                raise ConnectionError("scheduler down")
            self.delivered.append((worker_id, tuple(job_ids)))

    client = FlakyClient()
    outage = SchedulerOutage(threshold=1)
    outage.record_failure()
    dispatcher = Dispatcher(
        3.0, [0], client, "127.0.0.1", 1, str(tmp_path / "run"),
        str(tmp_path / "ckpt"), outage=outage, device="cpu",
    )
    for i in range(3):
        dispatcher._buffer_done((0, [i], [10], [1.0], [""], [""]))
    assert dispatcher.outstanding_job_ids() == [0, 1, 2]
    assert dispatcher.flush_buffered_dones() == 0
    client.fail = False
    assert dispatcher.flush_buffered_dones() == 3
    assert [jid for _, (jid,) in client.delivered] == [0, 1, 2]
    assert dispatcher.outstanding_job_ids() == []
    dispatcher.retarget_scheduler("10.0.0.9", 777)
    assert dispatcher._sched_addr == "10.0.0.9"


def test_worker_reattaches_to_the_leader_the_lease_names(tmp_path):
    """The agent's outage path over ``ha_dir``: no leader, a leader whose
    map is not published yet, or a map at an epoch below the highest the
    agent has seen are all skipped; a published leader at a newer epoch
    retargets the RPC client and the dispatcher, and the agent
    re-registers there with its previous ids and outstanding jobs, then
    flushes its buffered Done reports."""
    from shockwave_tpu_torch.ha.election import LeaderElection, LeaseStore
    from shockwave_tpu_torch.obs.fleet import ClockEstimator
    from shockwave_tpu_torch.runtime.retry import SchedulerOutage
    from shockwave_tpu_torch.runtime.worker import Worker, _EpochWitness

    calls = []

    class Client:
        addr = ("127.0.0.1", 7000)

        def retarget(self, addr, port):
            self.addr = (addr, port)

        def register_worker(self, *args, **kwargs):
            calls.append(("register", self.addr, args, kwargs))
            return [4], 3.0, "", None, 4, True

    class Dispatcher:
        def retarget_scheduler(self, addr, port):
            calls.append(("dispatcher", addr, port))

        def outstanding_job_ids(self):
            return [9]

        def flush_buffered_dones(self):
            calls.append(("flush",))
            return 1

    ha_dir = str(tmp_path / "ha")
    worker = Worker.__new__(Worker)
    worker._ha_dir = ha_dir
    worker._epoch = _EpochWitness()
    worker._rpc_client = Client()
    worker._dispatcher = Dispatcher()
    worker._outage = SchedulerOutage(threshold=1)
    worker._clock_sync = ClockEstimator()
    worker._worker_type, worker._num_accelerators = "v100", 1
    worker._ip_addr, worker._port = "127.0.0.1", 50061
    worker._worker_ids = [4]
    worker._outage.record_failure()

    assert not worker._try_reattach()  # no lease at all
    store = LeaseStore(ha_dir, ttl_s=30.0)
    first = LeaderElection(store, "leader")
    first.acquire(block=False)
    assert not worker._try_reattach()  # elected, map not published
    worker._epoch.witness(3)
    first.publish(sched_addr="127.0.0.1", sched_port=7001)
    assert not worker._try_reattach()  # epoch 1 below the witnessed 3
    assert calls == []
    store.release(first.lease)
    for holder in ("n2", "n3"):  # epochs 2 and 3
        other = LeaderElection(store, holder)
        other.acquire(block=False)
        store.release(other.lease)
    successor = LeaderElection(store, "successor")
    assert successor.acquire(block=False).epoch == 4
    successor.publish(sched_addr="127.0.0.1", sched_port=7002)
    assert worker._try_reattach()
    assert calls == [
        ("dispatcher", "127.0.0.1", 7002),
        ("register", ("127.0.0.1", 7002), ("v100", 1, "127.0.0.1", 50061),
         {"prev_worker_ids": [4], "outstanding_job_ids": [9]}),
        ("flush",),
    ]
    assert worker._epoch.max_epoch() == 4
    assert not worker._outage.in_outage()


def test_registrations_bounce_until_journal_restore_completes(tmp_path):
    """A successor's server is live from construction; with
    ``ha_restore_pending`` a registration bounces until
    ``restore_from_journal`` installs the restored registry (here a
    registry the JAX package journaled)."""
    jax, p = pkg("jax"), pkg("port")
    jdir = str(tmp_path / "journal")
    journal = jax.journal.ControlPlaneJournal(jdir)
    journal.append(
        "register",
        {"worker_ids": [0], "worker_type": "v100",
         "num_accelerators": 1, "ip_addr": "127.0.0.1", "port": 1234},
        epoch=1,
    )
    snapshot = p.journal.ControlPlaneJournal.replay(jdir)
    sched = fresh_physical(p, ha_journal=p.journal.ControlPlaneJournal(jdir),
                           ha_restore_pending=True)
    try:
        with pytest.raises(RuntimeError, match="restoring"):
            sched._register_worker_rpc("v100", 1, "127.0.0.1", 1234)
        sched.restore_from_journal(snapshot)
        ids, _, _, reattached = sched._register_worker_rpc(
            "v100", 1, "127.0.0.1", 1234, prev_worker_ids=[0],
            outstanding_job_ids=[])
        assert ids == [0] and reattached
        kinds = [e["kind"] for e in
                 p.journal.ControlPlaneJournal.replay(jdir).entries]
        assert kinds == ["reattach"]
    finally:
        sched.shutdown()


@pytest.mark.parametrize("writer,reader", WR)
def test_replay_reconciles_out_of_order_submit_admit(tmp_path, writer,
                                                     reader):
    """The append race: a drain can journal 'admit' below the matching
    'submit'. Replay must not queue the admitted job again."""
    w, r = pkg(writer), pkg(reader)
    jdir = str(tmp_path / "journal")
    journal = w.journal.ControlPlaneJournal(jdir)
    job_state = w.codec.job_state(make_job(w, 500))
    journal.append("admit", {"job_id": 0, "job": job_state,
                             "timestamp": 0.0, "token": "raced"}, epoch=1)
    journal.append("submit", {"token": "raced",
                              "jobs": [job_state, job_state],
                              "close": False}, epoch=1)
    snapshot = r.journal.ControlPlaneJournal.replay(jdir)
    sched = fresh_physical(r, ha_journal=r.journal.ControlPlaneJournal(jdir))
    try:
        sched.restore_from_journal(snapshot)
        assert list(sched._jobs) == [r.JobId(0)]
        assert sched._admission.depth() == 1
        assert len(sched._admission.drain(now=1.0)) == 1
    finally:
        sched.shutdown()
