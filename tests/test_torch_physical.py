"""The port's ``PhysicalScheduler`` against the JAX package's, driven
through their callbacks under a scripted clock.

Each package's scheduler runs its real round loop (``run``) with the
clock of ``core/physical.py`` replaced by a script: ``time.sleep``
advances the clock and plays the fake cluster's events due by then. The
cluster is recording fake worker clients (``SchedulerRpcClient`` swapped
for ``FakeClient``): a dispatch starts a micro-task that calls
``InitJob`` after a start-up, ``UpdateLease`` at three quarters of its
lease and ``Done`` when the lease or its steps run out; a kill reports
zero progress at once; one worker stops heartbeating and is retired.
Both packages must answer every lease request alike, dispatch the same
``JobDescription``s and commands, merge the same Done accounting and
plan the same rounds.
"""

import copy
import heapq
import importlib
import time as real_time

import pytest

from shockwave_tpu.core.job import Job as JaxJob
from shockwave_tpu_torch.core.job import Job as PortJob
from shockwave_tpu_torch.runtime.testing import free_port

ROUND_S = 10.0
STARTUP_S = 0.5
RATE = 100.0  # steps/s of every fake micro-task
PKG = {"jax": "shockwave_tpu", "port": "shockwave_tpu_torch"}


class Cluster:
    """The scripted clock and the fake workers' pending events."""

    def __init__(self):
        self.now = 0.0
        self.events: list = []  # (time, seq, fn)
        self.seq = 0
        self.log: list = []
        self.sched = None
        self.dead: set = set()
        self.hb_until = {}  # worker id -> last heartbeat time it sends
        self.attempts = {}  # job id -> micro-tasks started
        self.live = {}  # job id -> its running micro-task's attempt

    def at(self, t, fn):
        heapq.heappush(self.events, (t, self.seq, fn))
        self.seq += 1

    def advance(self, until):
        while self.events and self.events[0][0] <= until:
            t, _, fn = heapq.heappop(self.events)
            self.now = max(self.now, t)
            fn()
        self.now = max(self.now, until)

    def heartbeats(self):
        for wid, last in self.hb_until.items():
            if self.now <= last:
                self.sched._heartbeat_rpc(wid)


class ScriptedCondition:
    """A scheduler's condition whose timed waits take scripted time: a
    wait plays the cluster's events of up to a simulated second (their
    RPCs re-enter the scheduler's lock on this thread)."""

    def __init__(self, cv, clock):
        self._cv, self._clock = cv, clock

    def __enter__(self):
        return self._cv.__enter__()

    def __exit__(self, *exc):
        return self._cv.__exit__(*exc)

    def wait(self, timeout=None):
        self._clock.sleep(1.0 if timeout is None else min(timeout, 1.0))
        return True

    def __getattr__(self, name):
        return getattr(self._cv, name)


class FakeTime:
    """The ``time`` module of core/physical.py under the script."""

    def __init__(self, cluster):
        self.cluster = cluster

    def time(self):
        return 1000.0 + self.cluster.now

    def monotonic(self):
        return self.cluster.now

    def perf_counter(self):
        return real_time.perf_counter()

    def sleep(self, dt):
        end = self.cluster.now + dt
        # Heartbeats once a simulated second, the cluster's events between.
        t = self.cluster.now
        while t < end:
            t = min(t + 1.0, end)
            self.cluster.advance(t)
            self.cluster.heartbeats()


def make_client_class(cluster, startup=STARTUP_S, rate=RATE):
    class FakeClient:
        def __init__(self, ip_addr, port, retry=None):
            self.addr = (ip_addr, port)

        def run_job(self, descriptions, worker_id, round_id, sched_epoch=0):
            cluster.log.append(("run_job", worker_id, round_id, sched_epoch,
                                [dict(d) for d in descriptions]))
            for d in descriptions:
                self._start(dict(d), worker_id)

        def _start(self, d, worker_id):
            """One micro-task: InitJob after the start-up, then steps at
            ``rate``; UpdateLease at 75% of each lease, Done when the lease
            or the steps run out (the iterator's protocol)."""
            sched = cluster.sched
            job_id = int(d["job_id"])
            if "--hang" in d["command"]:
                return
            task = {}
            attempt = cluster.attempts[job_id] = (
                cluster.attempts.get(job_id, 0) + 1)
            cluster.live[job_id] = attempt

            def alive():
                # A killed micro-task (or a dead worker's) does nothing.
                return (worker_id not in cluster.dead
                        and cluster.live.get(job_id) == attempt)
            startup_s = startup
            if "--slow" in d["command"]:
                # The first attempt starts fast and its process dies 3 s
                # into its lease; every later one takes 14 s to start.
                startup_s = startup if attempt == 1 else 14.0

            def plan():
                max_steps, max_duration = task["lease"]
                end = task["t0"] + min(max_duration, max_steps / rate,
                                       d["num_steps"] / rate)
                refresh = task["t0"] + 0.75 * max_duration
                if refresh < end and refresh > cluster.now:
                    cluster.at(refresh, update)
                else:
                    cluster.at(max(end, cluster.now), done)

            def init():
                if not alive():
                    return
                task["t0"] = cluster.now
                max_steps, max_duration, extra = sched._init_job_rpc(job_id)
                cluster.log.append(("init", job_id, worker_id, max_steps,
                                    max_duration, extra))
                task["lease"] = (max_steps, max_duration + extra)
                if "--slow" in d["command"] and attempt == 1:
                    cluster.at(cluster.now + 3.0, done)
                    return
                plan()

            def update():
                if not alive():
                    return
                duration = cluster.now - task["t0"]
                steps = int(duration * rate)
                lease = sched._update_lease_rpc(job_id, worker_id, steps,
                                                duration, *task["lease"])
                cluster.log.append(("update", job_id, worker_id, steps)
                                   + tuple(lease))
                task["lease"] = (lease[0], lease[1] + lease[2])
                plan()

            def done():
                if not alive():
                    return
                cluster.live.pop(job_id, None)
                duration = cluster.now - task["t0"]
                steps = min(int(round(duration * rate)), d["num_steps"],
                            task["lease"][0])
                cluster.log.append(("done", job_id, worker_id, steps,
                                    duration))
                sched._done_rpc(worker_id, [job_id], [steps], [duration],
                                [f"steps={steps} duration={duration}"])

            cluster.at(cluster.now + startup_s, init)

        def kill_job(self, job_id, trace_context="", sched_epoch=0):
            cluster.log.append(("kill", int(job_id), self.addr, cluster.now))
            sched = cluster.sched
            for (key, wid) in list(sched._outstanding):
                if int(job_id) not in key.as_tuple():
                    continue
                if wid in cluster.dead:
                    raise ConnectionError(f"worker {wid} is unreachable")
                # A killed process that made no progress reports zero
                # steps.
                cluster.live.pop(int(job_id), None)
                sched._done_rpc(wid, [int(job_id)], [0], [0.0], [""])

        def reset(self):
            cluster.log.append(("reset",))

        def shutdown(self):
            cluster.log.append(("shutdown", self.addr))

        def dump_worker_metrics(self, trace_context=""):
            return ""

    return FakeClient


def _jobs(Job):
    jobs = [Job(job_type="ResNet-18 (batch size 32)",
                command=f"python3 payload.py --job {i}", num_steps_arg="-n",
                total_steps=steps)
            for i, steps in enumerate((1400, 2600, 900, 3100))]
    jobs.append(Job(job_type="ResNet-50 (batch size 32)",
                    command="python3 payload.py --hang", num_steps_arg="-n",
                    total_steps=500))
    return jobs


def run_package(package, policy, monkeypatch, slow_start=False):
    """One package's scripted run: three workers on two agents, four jobs
    and a hung one, worker 2 falling silent at 25 s. ``slow_start``
    instead runs one job on one worker whose first process dies 3 s into
    its lease and whose every later attempt takes 14 s to reach its first
    lease (rounds of 10 s)."""
    pkg = PKG[package]
    physical = importlib.import_module(f"{pkg}.core.physical")
    client_mod = importlib.import_module(f"{pkg}.runtime.rpc.scheduler_client")
    policies = importlib.import_module(f"{pkg}.policies")
    oracle_mod = importlib.import_module(f"{pkg}.data.default_oracle")
    profiles_mod = importlib.import_module(f"{pkg}.data.profiles")
    Job = JaxJob if package == "jax" else PortJob
    cluster = Cluster()
    monkeypatch.setattr(physical, "time", FakeTime(cluster))
    # A kill of an unreachable worker's task synthesizes its completion
    # at once instead of waiting on the real clock.
    monkeypatch.setattr(physical, "KILL_WAIT_SECONDS", 0.0)
    monkeypatch.setattr(client_mod, "SchedulerRpcClient",
                        make_client_class(cluster))
    oracle = oracle_mod.generate_oracle()
    jobs = _jobs(Job)
    if slow_start:
        jobs = [Job(job_type="ResNet-18 (batch size 32)",
                    command="python3 payload.py --slow", num_steps_arg="-n",
                    total_steps=4000)]
    policy_obj = (policies.get_policy(policy, device="cpu")
                  if package == "port" else policies.get_policy(policy))
    sched = physical.PhysicalScheduler(
        policy_obj, port=free_port(), throughputs=oracle,
        time_per_iteration=ROUND_S, completion_buffer_seconds=0.0,
        minimum_time_between_allocation_resets=0.0,
        heartbeat_timeout_s=3.0,
        profiles=profiles_mod.synthesize_profiles(jobs, oracle),
        shockwave_config={"num_gpus": 3, "time_per_iteration": ROUND_S,
                          "future_rounds": 4, "lambda": 5.0, "k": 10.0},
    )
    cluster.sched = sched
    try:
        agents = ([("v100", 1, "10.0.0.1", 50061)] if slow_start else [
            ("v100", 2, "10.0.0.1", 50061),
            ("v100", 1, "10.0.0.2", 50062),
            # A retransmitted registration gets the same ids back.
            ("v100", 1, "10.0.0.2", 50062)])
        registered = [copy.deepcopy(sched._register_worker_rpc(*args))
                      for args in agents]
        for wid in sched._worker_ids:
            cluster.hb_until[wid] = 10**9
        if not slow_start:
            # Worker 2 stops heartbeating after 25 s and is then retired.
            cluster.hb_until[2] = 25.0
            cluster.at(25.0, lambda: cluster.dead.add(2))
        admitted = [sched.add_job(job) for job in jobs[:3]]
        # The rest through the front door (SubmitJobs' handler), with the
        # stream's close.
        admission = importlib.import_module(f"{pkg}.runtime.admission")
        front_door = sched.submit_batch(
            "tok-0", [admission.job_to_spec_dict(j) for j in jobs[3:]],
            True) if jobs[3:] else None
        sched.run(max_rounds=14)
    finally:
        sched.shutdown()
    return {
        "registered": registered,
        "admitted": [j.integer for j in admitted],
        "front_door": front_door,
        "log": cluster.log,
        "rounds": [(r["round"], r["time"], r["jobs"])
                   for r in sched._round_log if r.get("event") == "round"],
        "steps": {str(k): v for k, v in sched._total_steps_run.items()},
        "completion": {str(k): v
                       for k, v in sched._job_completion_times.items()},
        "failures": {str(k): v
                     for k, v in sched._num_failures_per_job.items()},
        "workers": sorted(sched._worker_ids),
        "preemptions": sched._num_preemptions,
        "extensions": sched._num_lease_extensions,
    }


@pytest.mark.parametrize("policy", ["fifo", "max_min_fairness",
                                    "shockwave_tpu_level"])
def test_physical_schedulers_agree_under_a_scripted_clock(policy,
                                                          monkeypatch):
    ref = run_package("jax", policy, monkeypatch)
    port = run_package("port", policy, monkeypatch)
    assert ref["front_door"] == ("ACCEPTED", 0.0, 2, 2)
    for key in ("registered", "admitted", "front_door", "workers", "rounds",
                "steps",
                "completion", "failures", "preemptions", "extensions"):
        assert port[key] == ref[key], key
    assert port["log"] == ref["log"]
    kinds = {entry[0] for entry in ref["log"]}
    assert {"run_job", "init", "update", "done", "kill",
            "shutdown"} <= kinds, kinds
    # Worker 2 was retired; the hung job was killed at each of its five
    # failed attempts and dropped; every other job completed.
    assert ref["workers"] == [0, 1]
    assert ref["completion"]["4"] is None and "4" not in ref["failures"]
    assert sum(1 for e in ref["log"] if e[:2] == ("kill", 4)) == 5
    assert all(ref["completion"][str(j)] is not None for j in range(4))
    assert ref["registered"][1] == ref["registered"][2]


def test_a_slow_start_is_not_killed_as_unresponsive(monkeypatch):
    """A relaunched attempt that is kept for the next round (an extended
    lease) and takes 14 s to start, with its previous attempt's last lease
    contact 19.5 s old at the round's end (the silence window is 1.5
    rounds of 10 s): the port measures the new attempt's silence from its
    dispatch, so the job completes; the JAX package keeps the stale
    contact and kills every such attempt as unresponsive until the job is
    dropped (ROADMAP.md, queue 3)."""
    port = run_package("port", "fifo", monkeypatch, slow_start=True)
    assert port["completion"]["0"] is not None
    assert port["steps"]["0"] >= 4000
    assert not [e for e in port["log"] if e[0] == "kill"]
    ref = run_package("jax", "fifo", monkeypatch, slow_start=True)
    assert ref["completion"]["0"] is None
    assert sum(1 for e in ref["log"] if e[0] == "kill") == 5


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# The payload's steps/s alone on the card in chip_smoke.py phase 17, the
# rate phase 20 measures under its label (23.3 on an H100, NVIDIA H100
# 80GB HBM3 at 700 W; 10-14 at its share of the card in phase 17).
PHASE17_ORACLE_RATE = 23.3


def phase17_oracle(rate=PHASE17_ORACLE_RATE, job_type=None,
                   worker_type=None):
    """Phase 20's oracle: one row, the payload's rate alone on the card."""
    smoke = _chip_smoke()
    return {worker_type or smoke.PHYSICAL_WORKER_TYPE: {
        (job_type or smoke.PHYSICAL_JOB_TYPE, 1): {"null": rate}}}


def run_phase17(monkeypatch, round_s, startup_s, rate, oracle=None,
                epochs=None, config=None):
    """``chip_smoke.py`` phase 17's cluster on the port's scheduler under
    the scripted clock: one ``h100`` agent with two slots, three jobs
    sized from ``oracle`` (default :func:`phase17_oracle`) as the phase
    sizes them (``epochs`` overrides ``PHYSICAL_JOB_EPOCHS``), each
    of its micro-tasks ``startup_s`` from dispatch to its first lease and
    training at ``rate``; ``config`` updates the planner's configuration.
    Returns the round log's job sets, each job's attempts and the
    scheduler's preemptions by job."""
    import shockwave_tpu_torch.core.physical as physical
    import shockwave_tpu_torch.runtime.rpc.scheduler_client as client_mod
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.runtime.admission import job_to_spec_dict

    smoke = _chip_smoke()
    if epochs is not None:
        monkeypatch.setattr(smoke, "PHYSICAL_JOB_EPOCHS", epochs)
    oracle = oracle or phase17_oracle()
    (worker_type,) = oracle
    cluster = Cluster()
    clock = FakeTime(cluster)
    monkeypatch.setattr(physical, "time", clock)
    monkeypatch.setattr(physical, "KILL_WAIT_SECONDS", 0.0)
    monkeypatch.setattr(client_mod, "SchedulerRpcClient",
                        make_client_class(cluster, startup_s, rate))
    jobs = smoke.physical_jobs(oracle)
    for job in jobs:
        job.job_type = next(iter(oracle[worker_type]))[0]
    steps = jobs[0].total_steps
    by_job = {}

    class Scheduler(physical.PhysicalScheduler):
        def _round_observability(self, assignments, preempted=None):
            for key in preempted or ():
                by_job[str(key)] = by_job.get(str(key), 0) + 1
            return super()._round_observability(assignments,
                                                preempted=preempted)

    sched = Scheduler(
        get_policy("shockwave_tpu_pdhg", device="cpu"), port=free_port(),
        throughputs=oracle, time_per_iteration=round_s,
        completion_buffer_seconds=smoke.PHYSICAL_BUFFER_S,
        minimum_time_between_allocation_resets=0.0,
        profiles=synthesize_profiles(jobs, oracle, worker_type),
        shockwave_config={**smoke.physical_shockwave_config(round_s),
                          **(config or {})},
    )
    cluster.sched = sched
    # A micro-task's Done due after the round's end arrives in the
    # completion wait, which must take scripted time too.
    sched._cv = ScriptedCondition(sched._cv, clock)
    try:
        sched._register_worker_rpc(worker_type, smoke.PHYSICAL_SLOTS,
                                   "10.0.0.1", 50061)
        for wid in sched._worker_ids:
            cluster.hb_until[wid] = 10**9
        sched.expect_stream()
        sched.submit_batch("tok-0", [job_to_spec_dict(j) for j in jobs], True)
        sched.run(max_rounds=20)
    finally:
        sched.shutdown()
        # The last background speculation solves in real time; one still
        # running when the interpreter exits aborts it.
        speculation = getattr(sched._shockwave, "_speculation", None)
        if speculation is not None:
            speculation.done.wait(timeout=60)
    attempts = {}
    for entry in cluster.log:
        if entry[0] == "init":
            attempts[str(entry[1])] = attempts.get(str(entry[1]), 0) + 1
    return {
        "rounds": [sorted(r["jobs"]) for r in sched._round_log
                   if r.get("event") == "round"],
        "attempts": attempts,
        "preempted": by_job,
        "completed": sorted(str(j) for j, t in
                            sched._job_completion_times.items()
                            if t is not None),
        "steps": steps,
    }


@pytest.mark.parametrize("round_s,startup_s,rate", [
    (25, 18.4, 12.5), (25, 14.0, 15.0), (25, 24.0, 10.0)])
def test_the_smoke_phase_17_rotates_every_job(round_s, startup_s, rate,
                                              monkeypatch):
    """Phase 17's jobs, planned from the card's own rate (phase 20's
    ``h100`` row): every job completes after two attempts or more
    (stopped before its end and resumed), and the scheduler preempts at
    least one, at the start-ups, rates and rounds the card has shown and
    around them."""
    run = run_phase17(monkeypatch, round_s, startup_s, rate)
    assert run["completed"] == ["0", "1", "2"], run
    assert all(run["attempts"].get(j, 0) >= 2 for j in "012"), run
    assert sum(run["preempted"].values()) >= 1, run
