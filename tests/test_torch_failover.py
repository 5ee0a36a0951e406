"""Failover of the port's physical control plane, against the JAX
package's.

* A leader of each package runs the cluster of
  ``tests/test_torch_physical.py`` under its scripted clock with the
  write-ahead journal armed: the two WALs hold the same lines, and each
  package replays either journal into the same ``ha_state_dict`` (sets
  sorted, ROADMAP.md queue 3).
* The port of ``tests/test_runtime.py::
  test_leader_sigkill_hot_standby_failover``: two ``python -m
  shockwave_tpu_torch.ha.standby --device cpu`` nodes and two agents with
  ``jax``, the JAX package, ``grpc`` and ``google.protobuf`` unimportable;
  the leader is SIGKILLed by the seeded ``scheduler_crash``, the standby
  takes over at epoch 2 and finishes every job exactly once.
* The cases of ``tests/test_kill_stale_workloads.py`` against
  ``shockwave_tpu_torch/tools/kill_stale_workloads.py``.
"""

import importlib
import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_physical import (  # noqa: E402
    PKG,
    ROUND_S,
    Cluster,
    FakeTime,
    JaxJob,
    PortJob,
    _jobs,
    make_client_class,
)

from shockwave_tpu_torch.runtime.testing import free_port  # noqa: E402
from shockwave_tpu_torch.tools import kill_stale_workloads as ksw  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "shockwave_tpu",
           "grpc", "google.protobuf")


class StubElection:
    """A leader at epoch 1 whose lease never lapses."""

    epoch = 1

    def start_renewal(self, on_lost=None):
        pass

    def stop(self, release=True):
        pass


def _modules(package):
    base = PKG[package]
    return {name: importlib.import_module(f"{base}.{name}") for name in (
        "core.physical", "runtime.rpc.scheduler_client", "policies",
        "data.default_oracle", "data.profiles", "runtime.admission",
        "ha.journal", "obs.recorder")}


def _scheduler(package, policy, monkeypatch, cluster, **kwargs):
    m = _modules(package)
    monkeypatch.setattr(m["core.physical"], "time", FakeTime(cluster))
    monkeypatch.setattr(m["core.physical"], "KILL_WAIT_SECONDS", 0.0)
    monkeypatch.setattr(m["runtime.rpc.scheduler_client"],
                        "SchedulerRpcClient", make_client_class(cluster))
    oracle = m["data.default_oracle"].generate_oracle()
    Job = JaxJob if package == "jax" else PortJob
    policy_obj = (m["policies"].get_policy(policy, device="cpu")
                  if package == "port" else m["policies"].get_policy(policy))
    return m["core.physical"].PhysicalScheduler(
        policy_obj, port=free_port(), throughputs=oracle,
        time_per_iteration=ROUND_S, completion_buffer_seconds=0.0,
        minimum_time_between_allocation_resets=0.0,
        heartbeat_timeout_s=3.0,
        profiles=m["data.profiles"].synthesize_profiles(_jobs(Job), oracle),
        shockwave_config={"num_gpus": 3, "time_per_iteration": ROUND_S,
                          "future_rounds": 4, "lambda": 5.0, "k": 10.0},
        **kwargs,
    )


def run_leader(package, policy, monkeypatch, jdir, max_rounds=6):
    """The scripted cluster of tests/test_torch_physical.py under one
    package's leader with the journal armed (every generation kept)."""
    m = _modules(package)
    cluster = Cluster()
    journal = m["ha.journal"].ControlPlaneJournal(str(jdir), retain=10**6)
    sched = _scheduler(package, policy, monkeypatch, cluster,
                       ha_journal=journal, ha_election=StubElection())
    cluster.sched = sched
    try:
        for args in [("v100", 2, "10.0.0.1", 50061),
                     ("v100", 1, "10.0.0.2", 50062)]:
            sched._register_worker_rpc(*args)
        for wid in sched._worker_ids:
            cluster.hb_until[wid] = 10**9
        cluster.hb_until[2] = 25.0
        cluster.at(25.0, lambda: cluster.dead.add(2))
        Job = JaxJob if package == "jax" else PortJob
        jobs = _jobs(Job)
        for job in jobs[:3]:
            sched.add_job(job)
        admission = m["runtime.admission"]
        sched.submit_batch(
            "tok-0", [admission.job_to_spec_dict(j) for j in jobs[3:]], True)
        sched.run(max_rounds=max_rounds)
    finally:
        sched.shutdown()
    return cluster.log


def wal_lines(jdir):
    lines = []
    for name in sorted(os.listdir(jdir)):
        if name.startswith("wal-"):
            lines.extend((Path(jdir) / name).read_text().splitlines())
    return lines


def restored_state(package, policy, monkeypatch, jdir, restore_dir):
    """A successor of ``package`` built from the journal in ``jdir`` (a
    copy, since the restore appends a checkpoint): its capture as the
    package's codec text, sets sorted, and the planner's state apart."""
    import shutil

    m = _modules(package)
    shutil.copytree(jdir, restore_dir)
    snapshot = m["ha.journal"].ControlPlaneJournal.replay(str(restore_dir))
    cluster = Cluster()
    cluster.now = 500.0
    sched = _scheduler(
        package, policy, monkeypatch, cluster,
        ha_journal=m["ha.journal"].ControlPlaneJournal(str(restore_dir)),
        ha_restore_pending=True)
    try:
        applied = sched.restore_from_journal(snapshot)
        state = sched.ha_state_dict()
    finally:
        sched._ha_deposed = True  # leave the fake fleet alone
        sched.shutdown()
    planner = state.pop("planner", None)
    return state, planner, applied, snapshot


# Not compared between restores of the two leaders' journals: the port's
# allocation counters (the JAX package's scheduler has none to journal)
# and the lease contacts, which the leaders themselves keep apart on
# purpose: the port starts an attempt's silence window at its dispatch
# (ROADMAP.md, queue 3), so its leader records a contact for the hung job
# that the JAX package's does not.
APART = {"fields": ("num_allocations", "allocation_s"),
         "physical": ("last_lease_contact",)}


def view(package, state, common):
    """``state`` as codec text with its sets sorted and without ``APART``;
    ``common`` keeps what both packages capture (the JAX package keeps
    more RNG streams and a few counters)."""
    jax_fields = importlib.import_module(
        "shockwave_tpu.core.scheduler").Scheduler._HA_STATE_FIELDS
    port_fields = importlib.import_module(
        "shockwave_tpu_torch.core.scheduler").Scheduler._HA_STATE_FIELDS
    state = dict(state)
    state["sets"] = {f: sorted(v) for f, v in state["sets"].items()}
    physical = dict(state["physical"])
    for f in ("consumed_sched_faults", "extended_leases", "outstanding",
              "retired_workers"):
        physical[f] = sorted(physical[f])
    state["physical"] = physical
    state["fields"] = dict(state["fields"])
    for section, keys in APART.items():
        for key in keys:
            state[section].pop(key, None)
    if common:
        state = {
            "fields": {f: state["fields"][f] for f in port_fields
                       if f in jax_fields and f in state["fields"]},
            "profiles": state["profiles"],
            "sets": {f: state["sets"][f] for f in
                     ("_completed_jobs", "_fault_tainted", "_running_jobs")},
            "jobs": state["jobs"],
            "physical": physical,
        }
    recorder = importlib.import_module(f"{PKG[package]}.obs.recorder")
    return json.dumps(recorder.encode(state))


@pytest.mark.parametrize("policy", ["fifo", "max_min_fairness",
                                    "shockwave_tpu_level"])
def test_each_package_replays_the_others_journal(policy, monkeypatch,
                                                 tmp_path):
    """The leaders' WALs hold the same lines; each package replays either
    journal into the same state, and the two packages' states agree on
    what both capture."""
    jdirs = {}
    logs = {}
    for package in ("jax", "port"):
        jdirs[package] = tmp_path / f"{package}_journal"
        logs[package] = run_leader(package, policy, monkeypatch,
                                   jdirs[package])
    assert logs["port"] == logs["jax"]
    jax_wal, port_wal = wal_lines(jdirs["jax"]), wal_lines(jdirs["port"])
    assert port_wal == jax_wal
    kinds = [json.loads(line)["kind"] for line in port_wal]
    assert {"register", "admit", "submit", "dispatch", "done",
            "round", "retire"} <= set(kinds), set(kinds)
    assert len([n for n in os.listdir(jdirs["port"])
                if n.startswith("checkpoint-")]) == 6

    states = {}
    for reader in ("jax", "port"):
        for writer in ("jax", "port"):
            states[reader, writer] = restored_state(
                reader, policy, monkeypatch, jdirs[writer],
                tmp_path / f"{reader}_restores_{writer}")
    for reader in ("jax", "port"):
        (a, planner_a, applied_a, snap_a), (b, planner_b, applied_b, _) = (
            states[reader, "jax"], states[reader, "port"])
        assert applied_a == applied_b
        assert view(reader, a, common=False) == view(reader, b, common=False)
        assert (planner_a is None) == (policy != "shockwave_tpu_level")
        if planner_a is not None:
            assert planner_a["recompute_flag"] and planner_b["recompute_flag"]
    # The packages agree on what both capture, of either journal.
    for writer in ("jax", "port"):
        assert view("port", states["port", writer][0], common=True) == (
            view("jax", states["jax", writer][0], common=True))
    # The restore resumed the leader's registry, jobs and ledger.
    port_state = states["port", "jax"][0]
    assert sorted(port_state["fields"]["_worker_ids"]) == [0, 1]
    assert port_state["physical"]["retired_workers"] == [2]
    assert port_state["physical"]["admission"]["token_jobs"] == {"tok-0": 2}


def _blocker_env(tmp_path):
    """An environment whose Python processes cannot import the JAX
    package, JAX, grpc or google.protobuf (a sitecustomize that marks
    them missing), and that runs the port from this checkout."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n")
    return {"PYTHONPATH": os.pathsep.join([str(blocker), str(ROOT)]),
            "OMP_NUM_THREADS": "2"}


# A wall-clock drill (3 s rounds, a 2 s lease): the repo's bounded retry
# for load-sensitive runs, as tests/test_torch_runtime.py's.
@pytest.mark.wallclock_retry
def test_leader_sigkill_hot_standby_failover(tmp_path):
    """A leader node journals a live campaign under the PDHG planner and
    is SIGKILLed mid-round by the seeded scheduler_crash; the hot standby
    takes the lease at epoch 2 on its own port, replays the checkpoint
    and tail (with the crash's marker), restores its planner, re-adopts
    both re-attaching agents and finishes all 6 jobs exactly once, each
    to its steps; the first token, resent across the failover, is
    deduped by the restored ledger. Every process runs with jax, the JAX
    package, grpc and google.protobuf unimportable."""
    from shockwave_tpu_torch.tools import ha_smoke

    extra_env = _blocker_env(tmp_path)
    probe = subprocess.run(
        [sys.executable, "-c", "import jax"], cwd=ROOT,
        env={**os.environ, **extra_env}, capture_output=True, text=True)
    assert probe.returncode != 0 and "None in sys.modules" in probe.stderr
    report = ha_smoke.failover_arm(
        str(tmp_path), "hot", hot=True, device="cpu",
        policy="shockwave_tpu_pdhg", extra_env=extra_env)
    assert ha_smoke.check_arm(report) == [], json.dumps(report)[:4000]
    succ = report["successor"]
    assert succ["restored_tail"]["sched_fault"] == 1
    assert succ["admission"]["deduped_batches"] == 1
    assert succ["journal"]["last_epoch"] == 2
    assert report["takeover_s"] < 20
    # The successor replanned after its restore.
    log = Path(tmp_path) / "hot" / "succ_decisions.jsonl"
    events = [json.loads(line)["event"] for line in log.read_text()
              .splitlines()]
    assert "plan" in events and "recovery" in events


# ----------------------------------------------------------------------
# tools/kill_stale_workloads.py
# ----------------------------------------------------------------------
def _spawn(extra_env=None, marker=""):
    env = dict(os.environ)
    env.pop("SHOCKWAVE_JOB_ID", None)
    if extra_env:
        env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)", marker],
        env=env,
    )


def test_find_by_env_marker_and_kill():
    proc = _spawn(extra_env={"SHOCKWAVE_JOB_ID": "7"})
    other = _spawn()
    near_miss = _spawn(extra_env={"OLD_SHOCKWAVE_JOB_ID": "7"})
    try:
        time.sleep(0.3)
        assert proc.pid not in [pid for pid, _ in ksw.find_stale()]
        pids = [pid for pid, _ in ksw.find_stale(include_parented=True)]
        assert proc.pid in pids
        assert other.pid not in pids
        assert near_miss.pid not in pids
        ksw.kill([proc.pid], grace_s=2.0)
        assert proc.wait(timeout=5) != 0
        assert proc.pid not in [
            pid for pid, _ in ksw.find_stale(include_parented=True)]
    finally:
        for p in (proc, other, near_miss):
            if p.poll() is None:
                p.kill()
            p.wait()


def test_orphaned_workload_found_by_default():
    """A payload whose agent died (reparented to init) is stale and found
    without flags, by the module and by its CLI's dry run; the test then
    kills that one payload, and signals no process it did not start."""
    code = (
        "import os, subprocess, sys\n"
        "env = dict(os.environ); env['SHOCKWAVE_JOB_ID'] = '9'\n"
        "p = subprocess.Popen([sys.executable, '-c',"
        " 'import time; time.sleep(60)'], env=env,"
        " start_new_session=True, stdout=subprocess.DEVNULL,"
        " stderr=subprocess.DEVNULL)\n"
        "print(p.pid, flush=True)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=30)
    grandchild = int(out.stdout.strip())
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            _, ppid = ksw._stat_fields(grandchild)
            if ppid == 1:
                break
            time.sleep(0.1)
        assert ksw._orphaned(grandchild), "grandchild not reparented"
        assert grandchild in [pid for pid, _ in ksw.find_stale()]
        cli = subprocess.run(
            [sys.executable, "-m", "shockwave_tpu_torch.tools."
             "kill_stale_workloads"], cwd=ROOT,
            capture_output=True, text=True, timeout=60)
        assert cli.returncode == 0 and f"{grandchild}:" in cli.stdout
        assert "dry run" in cli.stdout
        assert ksw._alive(grandchild)
        ksw.kill([grandchild], grace_s=2.0)
        assert grandchild not in [pid for pid, _ in ksw.find_stale()]
    finally:
        try:
            os.kill(grandchild, 9)
        except OSError:
            pass


def test_find_by_cmdline_pattern():
    marker = f"stale-marker-{os.getpid()}"
    proc = _spawn(marker=marker)
    try:
        time.sleep(0.3)
        assert [pid for pid, _ in ksw.find_stale(pattern=marker)] == [
            proc.pid]
    finally:
        proc.kill()
        proc.wait()


def test_kill_does_not_wait_on_zombies():
    proc = _spawn()
    try:
        time.sleep(0.3)
        start = time.time()
        ksw.kill([proc.pid], grace_s=10.0)
        assert time.time() - start < 5.0
    finally:
        proc.kill()
        proc.wait()


def test_no_match_is_empty():
    assert ksw.find_stale(
        pattern=f"no-such-process-{uuid.uuid4().hex}") == []
