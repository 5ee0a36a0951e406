"""The port's physical runtime on localhost: a real scheduler + worker +
training subprocesses, short rounds, end to end to completion — the
counterparts of the JAX package's ``tests/test_runtime.py`` flows with the
port's scheduler, worker agent (its payloads on ``--device cpu``) and
payloads (``runtime/synthetic.py``, and ``models/train.py`` at a tiny
width) over the port's socket transport.

Three completion-only flows stay in tier-1 under ``wallclock_retry``:
``fifo`` and ``shockwave_tpu`` with the synthetic payload, and the
Transformer payload. The rest carry ``slow``, as the JAX package's do.
Left out: the gang-training flow (``torch.distributed`` between payload
processes, ROADMAP.md queue 1 item 8). The hot-standby failover is
``tests/test_torch_failover.py``'s.
"""

import os
import sys
import threading
import time

import pytest

pytestmark = pytest.mark.wallclock_retry

# Tests that run CONCURRENT payload processes (a packed pair sharing an
# accelerator) are timing assertions about parallel execution: on a
# <4-CPU host the payloads time-share cores with the scheduler and the
# measured rates are noise, not signal.
_needs_parallel_cpus = pytest.mark.skipif(
    (os.cpu_count() or 1) < 4,
    reason=(
        "wall-clock-sensitive packed-pair test: needs >= 4 CPUs for truly "
        f"parallel payloads, host has {os.cpu_count()}"
    ),
)

from shockwave_tpu_torch.core.job import Job
from shockwave_tpu_torch.core.physical import PhysicalScheduler
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.policies import get_policy
from shockwave_tpu_torch.runtime.testing import (
    make_synthetic_job as make_job,
    start_local_cluster,
)
from shockwave_tpu_torch.runtime.testing import (
    SYNTHETIC_WORKLOAD as WORKLOAD,
    free_port,
)


@pytest.fixture
def cluster(tmp_path):
    """One scheduler + one 2-accelerator worker on localhost.
    (minimum_time_between_allocation_resets=0: the production default
    of 1920s is tuned for 360s rounds and would starve late jobs of
    allocation recomputes at 3s test rounds.)"""
    sched = start_local_cluster(
        "fifo", 2,
        run_dir=str(tmp_path / "run"),
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    yield sched, tmp_path
    sched.shutdown()


def test_jobs_run_to_completion(cluster):
    sched, tmp_path = cluster
    # ~1.5 rounds of work each at 200 steps/s and 3s rounds.
    job_ids = [sched.add_job(make_job(800)) for _ in range(2)]
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 20})
    runner.start()
    runner.join(timeout=90)
    assert not runner.is_alive(), "physical round loop did not converge"
    assert len(sched._job_completion_times) == 2
    for job_id in job_ids:
        assert sched._job_completion_times[job_id] is not None
        assert sched._total_steps_run[job_id] >= 800
    # The workload checkpointed across preemptions.
    ckpts = list((tmp_path / "ckpt").glob("job_id=*/state.json"))
    assert len(ckpts) == 2


@pytest.mark.slow
def test_gang_job_merges_worker_reports(cluster):
    sched, tmp_path = cluster
    # One 2-worker gang job: both members dispatch, both Done reports must
    # merge into one micro-task completion.
    job_id = sched.add_job(make_job(600, scale_factor=2))
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 20})
    runner.start()
    runner.join(timeout=90)
    assert not runner.is_alive()
    assert sched._job_completion_times.get(job_id) is not None
    assert sched._total_steps_run[job_id] >= 600


@pytest.mark.slow
def test_short_jobs_backfill_idle_workers(cluster):
    """Jobs that finish within a round go stale in the mid-round plan:
    without round-start backfill a 2-slot cluster runs one short job
    per round (each planned round contains a job that completed before
    the boundary). Six sub-round jobs on 2 slots must finish in ~3-4
    working rounds, not 6+."""
    sched, tmp_path = cluster
    # ~1s of work each at 200 steps/s and 3s rounds.
    job_ids = [sched.add_job(make_job(200)) for _ in range(6)]
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 8})
    runner.start()
    runner.join(timeout=60)
    assert not runner.is_alive(), "round loop did not converge"
    done = [
        j for j in job_ids if sched._job_completion_times.get(j) is not None
    ]
    assert len(done) == 6, f"only {len(done)}/6 completed in 8 rounds"
    # The discriminating assertion: 2 jobs per round needs 3 working
    # rounds (4 with slack); the stale-plan bug's alternating
    # 2-then-0 pattern needs at least 5.
    assert sched._round_id <= 4, (
        f"took {sched._round_id} rounds for 6 sub-round jobs on 2 slots"
    )


@pytest.mark.slow
def test_preemption_resumes_across_rounds(cluster):
    sched, tmp_path = cluster
    # 3 jobs, 2 accelerators: someone must be preempted and resumed.
    job_ids = [sched.add_job(make_job(700)) for _ in range(3)]
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 30})
    runner.start()
    runner.join(timeout=150)
    assert not runner.is_alive()
    assert len(sched._job_completion_times) == 3
    for job_id in job_ids:
        assert sched._total_steps_run[job_id] >= 700


def make_failing_job(total_steps, crash_attempts, steps_per_sec=200):
    job = make_job(total_steps, steps_per_sec=steps_per_sec)
    job.command += f" --crash_attempts {crash_attempts}"
    return job


@pytest.mark.slow
def test_failed_attempts_drop_job_and_spare_healthy_one(cluster):
    """A micro-task that reports zero progress counts as a failure; after
    MAX_FAILED_ATTEMPTS the job is dropped with completion_time=None
    (reference: scheduler.py:3359-3376, 649-651) while healthy jobs
    continue unharmed."""
    sched, tmp_path = cluster
    crasher = sched.add_job(make_failing_job(400, crash_attempts=-1))
    healthy = sched.add_job(make_job(400))
    # Round budgets are headroom for loaded hosts; the loop exits as
    # soon as every job is completed or dropped.
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 40})
    runner.start()
    runner.join(timeout=300)
    assert not runner.is_alive(), "round loop wedged on the failing job"
    assert sched._job_completion_times[crasher] is None
    assert sched._job_completion_times[healthy] is not None
    assert sched._total_steps_run[healthy] >= 400


@pytest.mark.slow
def test_single_step_job_completes(cluster):
    """A 1-step job's only step happens after the iterator's last
    __next__ interval, so complete() must account it — reporting
    duration 0 made the scheduler's physical-mode merge judge every
    attempt failed and drop the job."""
    sched, tmp_path = cluster
    job_id = sched.add_job(make_job(1))
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 15})
    runner.start()
    runner.join(timeout=90)
    assert not runner.is_alive()
    assert sched._job_completion_times.get(job_id) is not None
    assert sched._total_steps_run[job_id] >= 1


@pytest.mark.slow
def test_unspawnable_job_is_dropped_not_wedged(cluster):
    """A job whose process cannot even spawn (nonexistent working
    directory) must still produce a Done report per attempt so the
    failed-attempts logic drops it — a silently dead launcher thread
    used to leave the assignment outstanding and wedge the round loop."""
    sched, tmp_path = cluster
    bad = make_job(400)
    bad.working_directory = str(tmp_path / "does-not-exist")
    bad_id = sched.add_job(bad)
    healthy = sched.add_job(make_job(400))
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 40})
    runner.start()
    runner.join(timeout=300)
    assert not runner.is_alive(), "round loop wedged on the unspawnable job"
    assert sched._job_completion_times[bad_id] is None
    assert sched._job_completion_times[healthy] is not None


@pytest.mark.slow
def test_transient_failures_are_retried_to_completion(cluster):
    """Two crash-on-launch attempts, then normal training: the scheduler
    must re-dispatch after each failure and the job must still finish."""
    sched, tmp_path = cluster
    job_id = sched.add_job(make_failing_job(400, crash_attempts=2))
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 40})
    runner.start()
    runner.join(timeout=300)
    assert not runner.is_alive()
    assert sched._job_completion_times[job_id] is not None
    assert sched._total_steps_run[job_id] >= 400
    attempts_file = tmp_path / "ckpt" / f"job_id={job_id.integer}" / "attempts.txt"
    assert int(attempts_file.read_text()) >= 3  # 2 crashes + >=1 real run


@pytest.mark.slow
def test_straggler_is_killed_and_eventually_dropped(cluster):
    """A hung workload never reports Done: the round loop must kill it at
    round end + buffer (reference: scheduler.py:3098-3170), count the
    failure, and after MAX_FAILED_ATTEMPTS drop the job."""
    sched, tmp_path = cluster
    hung = sched.add_job(
        Job(
            job_type="ResNet-18 (batch size 32)",
            command=f"{sys.executable} {WORKLOAD} --hang --batch_size 32",
            num_steps_arg="-n",
            total_steps=400,
            scale_factor=1,
            mode="static",
        )
    )
    healthy = sched.add_job(make_job(400))
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 40})
    runner.start()
    runner.join(timeout=420)
    assert not runner.is_alive(), "round loop wedged on the hung job"
    assert sched._job_completion_times[hung] is None
    assert sched._job_completion_times[healthy] is not None


@pytest.mark.slow
def test_worker_reset_kills_running_jobs_and_job_recovers(cluster):
    """The Reset RPC wipes worker-side processes (reference:
    dispatcher.py:537-545); the preempted job is retried and completes."""
    sched, tmp_path = cluster
    job_id = sched.add_job(make_job(900, steps_per_sec=100))
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 45})
    runner.start()
    # Let the first dispatch land, then reset the worker out from under it.
    deadline = time.time() + 30
    while time.time() < deadline and not sched._dispatched_worker_ids:
        time.sleep(0.2)
    assert sched._dispatched_worker_ids, "job was never dispatched"
    client = next(iter(sched._worker_connections.values()))
    client.reset()
    runner.join(timeout=360)
    assert not runner.is_alive()
    assert sched._job_completion_times.get(job_id) is not None
    assert sched._total_steps_run[job_id] >= 900


@pytest.mark.slow
def test_dead_worker_subprocess_is_reaped_and_jobs_recover(
    tmp_path, monkeypatch
):
    """Worker-death recovery, against a REAL killed worker: one worker
    agent runs as a subprocess, gets SIGKILLed mid-run, and the
    scheduler's heartbeat lease-expiry must (1) declare it dead, (2)
    requeue its outstanding micro-task without charging the job a
    failed attempt, (3) shrink capacity to the surviving in-process
    worker, and (4) finish every job there."""
    import signal
    import subprocess
    import sys

    from shockwave_tpu_torch.runtime.worker import Worker

    # Dispatches to the dead worker must give up quickly or the round
    # loop spends its completion buffer inside RunJob retries.
    monkeypatch.setenv("SHOCKWAVE_RPC_ATTEMPTS", "2")
    monkeypatch.setenv("SHOCKWAVE_RPC_DEADLINE_S", "3")
    monkeypatch.setenv("SHOCKWAVE_HEARTBEAT_S", "0.5")
    sched_port = free_port()
    victim_port, survivor_port = free_port(), free_port()
    sched = PhysicalScheduler(
        get_policy("fifo"),
        port=sched_port,
        throughputs=generate_oracle(),
        time_per_iteration=3.0,
        completion_buffer_seconds=6.0,
        minimum_time_between_allocation_resets=0.0,
        heartbeat_timeout_s=4.0,
    )
    victim = subprocess.Popen(
        [
            sys.executable, "-m", "shockwave_tpu_torch.runtime.worker",
            "-t", "v100", "-n", "1",
            "-a", "127.0.0.1", "-s", str(sched_port),
            "-p", str(victim_port), "--device", "cpu",
            "--run_dir", str(tmp_path / "victim_run"),
            "--checkpoint_dir", str(tmp_path / "victim_ckpt"),
        ],
    )
    try:
        sched.wait_for_workers(1, timeout=30)
        Worker(
            "v100", 1, "127.0.0.1", sched_port, survivor_port,
            run_dir=str(tmp_path / "run"),
            checkpoint_dir=str(tmp_path / "ckpt"), device="cpu",
        )
        sched.wait_for_workers(2, timeout=30)
        victim_wid = next(
            wid
            for wid, (_, port) in sched._worker_addrs.items()
            if port == victim_port
        )
        job_ids = [sched.add_job(make_job(800)) for _ in range(2)]
        runner = threading.Thread(
            target=sched.run, kwargs={"max_rounds": 40}
        )
        runner.start()
        # Let the victim receive work, then kill it dead (no cleanup).
        deadline = time.time() + 30
        while time.time() < deadline and not any(
            victim_wid in ids
            for ids in sched._dispatched_worker_ids.values()
        ):
            time.sleep(0.2)
        victim.send_signal(signal.SIGKILL)
        runner.join(timeout=300)
        assert not runner.is_alive(), "round loop wedged on the dead worker"
        assert victim_wid not in sched._worker_ids, "dead worker not reaped"
        assert len(sched._worker_ids) == 1
        for job_id in job_ids:
            assert sched._job_completion_times.get(job_id) is not None, (
                f"job {job_id} was lost with the dead worker"
            )
            assert sched._total_steps_run[job_id] >= 800
    finally:
        if victim.poll() is None:
            victim.kill()
        sched.shutdown()


@pytest.mark.slow
def test_injected_rpc_faults_are_retried_to_completion(cluster):
    """Injected Done/RunJob failures (runtime/faults.py) must be
    absorbed by the client retry layer: the job completes and every
    applied fault pairs with a retry-success recovery."""
    from shockwave_tpu_torch.runtime import faults

    plan = faults.FaultPlan(
        seed=0,
        events=[
            faults.FaultEvent(0, "rpc_error", method="Done", count=2),
            faults.FaultEvent(1, "rpc_delay", method="RunJob", delay_s=0.2),
        ],
    )
    injector = faults.configure(plan)
    try:
        sched, tmp_path = cluster
        job_id = sched.add_job(make_job(400))
        runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 20})
        runner.start()
        runner.join(timeout=120)
        assert not runner.is_alive()
        assert sched._job_completion_times.get(job_id) is not None
        assert sched._total_steps_run[job_id] >= 400
        summary = injector.summary()
        assert summary["applied"] >= 1, "no fault was ever delivered"
        assert summary["unrecovered"] == [], summary
    finally:
        faults.reset()


@pytest.mark.slow
def test_streaming_front_door_runs_jobs_to_completion(cluster):
    """Jobs submitted through the SubmitJobs RPC front door (not
    in-process add_job) run to completion, a verbatim token retry is
    deduplicated instead of double-admitted, and the end-of-stream
    close — not a static expected-job count — ends the round loop."""
    from shockwave_tpu_torch.runtime.rpc.submitter_client import SubmitterClient

    sched, tmp_path = cluster
    sched.expect_stream()
    runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 30})
    runner.start()
    try:
        client = SubmitterClient("127.0.0.1", sched._port, client_id="t")
        jobs = [make_job(400) for _ in range(2)]
        tokens = client.submit_stream(jobs, batch_size=1, close=False)
        # A retransmit of the first batch (lost-response model) must be
        # acknowledged via the ledger, never admitted a second time.
        response = client.submit([jobs[0]], token=tokens[0])
        assert response.status == "ACCEPTED"
        client.close_stream()
        runner.join(timeout=120)
        assert not runner.is_alive(), "close signal did not end the run"
    finally:
        sched._shutdown_requested.set()
    assert sched._num_jobs_in_trace == 2, "token retry double-admitted"
    assert len(sched._job_completion_times) == 2
    assert all(
        t is not None for t in sched._job_completion_times.values()
    )
    assert sched._admission.summary()["deduped_batches"] >= 1


@pytest.mark.slow
def test_submit_after_close_raises_not_silently_dropped(cluster):
    """A batch arriving after the stream closed is REJECTED loudly:
    the client raises SubmissionRejected instead of returning success
    while the jobs vanish (the two-submitters-racing-a-close hazard).
    An idempotent re-close stays benign."""
    from shockwave_tpu_torch.runtime.rpc.submitter_client import (
        SubmissionRejected,
        SubmitterClient,
    )

    sched, tmp_path = cluster
    client = SubmitterClient("127.0.0.1", sched._port, client_id="x")
    client.close_stream()
    with pytest.raises(SubmissionRejected, match="closed"):
        client.submit([make_job(100)])
    client.close_stream()  # benign
    assert sched._admission.summary()["closed_rejects"] == 1


@pytest.mark.slow
def test_submit_jobs_chaos_admits_each_token_exactly_once(cluster):
    """The submission-idempotency chaos contract: injected rpc_error
    (request lost), rpc_drop (response lost — the scheduler DID admit)
    and rpc_delay on SubmitJobs force the client through its retry
    loop, and every token still resolves to exactly one admission."""
    from shockwave_tpu_torch.runtime import faults
    from shockwave_tpu_torch.runtime.rpc.submitter_client import SubmitterClient

    plan = faults.FaultPlan(
        seed=0,
        events=[
            faults.FaultEvent(0, "rpc_error", method="SubmitJobs"),
            faults.FaultEvent(1, "rpc_drop", method="SubmitJobs"),
            faults.FaultEvent(
                2, "rpc_delay", method="SubmitJobs", delay_s=0.1
            ),
        ],
    )
    injector = faults.configure(plan)
    try:
        sched, tmp_path = cluster
        sched.expect_stream()
        runner = threading.Thread(
            target=sched.run, kwargs={"max_rounds": 30}
        )
        runner.start()
        client = SubmitterClient("127.0.0.1", sched._port, client_id="c")
        client.submit_stream(
            [make_job(400) for _ in range(3)], batch_size=1, close=True
        )
        runner.join(timeout=120)
        assert not runner.is_alive()
        assert sched._num_jobs_in_trace == 3, (
            "a retried submission double-admitted its batch"
        )
        assert all(
            t is not None for t in sched._job_completion_times.values()
        )
        adm = sched._admission.summary()
        assert adm["accepted_jobs"] == 3
        # The rpc_drop retransmit is the one the ledger must absorb.
        assert adm["deduped_batches"] >= 1
        summary = injector.summary()
        assert summary["applied"] >= 3, "injected faults never fired"
        assert summary["unrecovered"] == [], summary
    finally:
        faults.reset()


@pytest.mark.slow
@_needs_parallel_cpus
def test_packed_pair_shares_accelerator(tmp_path):
    """Space-sharing, for real (VERDICT r03 missing #1): a packed policy
    assigns TWO jobs to the cluster's single accelerator slot, the
    dispatcher launches both subprocesses CONCURRENTLY on it (the
    reference does this via CUDA MPS, dispatcher.py:122-161,447-525; here
    the accelerator runtime time-slices), their Done reports merge into
    one pair micro-task, and — because the spin workloads all pin to the
    same core — each packed job's measured step rate drops to about half
    its isolated rate. Rate halving IS the concurrency proof: serialized
    execution would run each process at full rate."""
    from shockwave_tpu_torch.runtime.testing import (
        make_synthetic_job,
        parse_round_rates,
        start_local_cluster,
    )

    rate = 50.0  # spin steps/sec; 20 ms of busy-work per step

    # Baseline: one spinner alone on the slot.
    sched = start_local_cluster(
        "fifo", 1,
        run_dir=str(tmp_path / "base_run"),
        checkpoint_dir=str(tmp_path / "base_ckpt"),
    )
    try:
        job_id = sched.add_job(
            make_synthetic_job(200, steps_per_sec=rate, extra_args=" --spin")
        )
        runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 8})
        runner.start()
        runner.join(timeout=90)
        assert not runner.is_alive()
        assert sched._job_completion_times.get(job_id) is not None
        base = parse_round_rates(str(tmp_path / "base_run"))
        base_rate = max(r for rr in base.values() for r in rr.values())
    finally:
        sched.shutdown()
    assert base_rate > 0.6 * rate, (
        f"isolated spin rate {base_rate:.1f} steps/s implausibly low"
    )

    # Packed: two spinners, ONE accelerator slot, a packing policy.
    sched = start_local_cluster(
        "max_min_fairness_packed", 1,
        run_dir=str(tmp_path / "packed_run"),
        checkpoint_dir=str(tmp_path / "packed_ckpt"),
    )
    try:
        job_ids = [
            sched.add_job(
                make_synthetic_job(
                    300, steps_per_sec=rate, extra_args=" --spin"
                )
            )
            for _ in range(2)
        ]
        runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 14})
        runner.start()
        runner.join(timeout=150)
        assert not runner.is_alive(), "packed round loop wedged"
        for job_id in job_ids:
            assert sched._job_completion_times.get(job_id) is not None
            assert sched._total_steps_run[job_id] >= 300
        # A pair assignment was actually dispatched (merged Done path).
        pair_rounds = [
            e for e in sched._round_log
            if e["event"] == "round"
            and any("," in key for key in e["jobs"])
        ]
        assert pair_rounds, "no packed pair was ever dispatched"
        # Co-location slowdown: in rounds where both jobs reported, the
        # spinners shared a core, so per-process rates collapse toward
        # half the isolated rate.
        per_round = parse_round_rates(str(tmp_path / "packed_run"))
        shared = [r for r in per_round.values() if len(r) == 2]
        assert shared, "no round with progress reports from both jobs"
        packed_rate = max(
            rate_ for round_rates in shared for rate_ in round_rates.values()
        )
        assert packed_rate < 0.75 * base_rate, (
            f"packed rate {packed_rate:.1f} vs isolated {base_rate:.1f} "
            "steps/s: no co-location slowdown measured — were the "
            "processes actually concurrent on one slot?"
        )
    finally:
        sched.shutdown()


def test_shockwave_tpu_policy_drives_physical_cluster(tmp_path):
    """The Shockwave planner (TPU greedy backend) running the real
    control plane end-to-end: plans rounds, dispatches over gRPC, and
    completes every job."""
    from shockwave_tpu_torch.core.physical import PhysicalScheduler
    from shockwave_tpu_torch.data.profiles import synthesize_profiles
    from shockwave_tpu_torch.runtime.worker import Worker

    oracle = generate_oracle()
    jobs = [make_job(600), make_job(600), make_job(600)]
    profiles = synthesize_profiles(jobs, oracle)

    sched_port, worker_port = free_port(), free_port()
    sched = PhysicalScheduler(
        get_policy("shockwave_tpu", device="cpu"),
        port=sched_port,
        throughputs=oracle,
        time_per_iteration=3.0,
        completion_buffer_seconds=6.0,
        minimum_time_between_allocation_resets=0.0,
        profiles=profiles,
        shockwave_config={
            "num_gpus": 2,
            "time_per_iteration": 3.0,
            "future_rounds": 6,
            "lambda": 5.0,
            "k": 10.0,
        },
    )
    worker = Worker(
        "v100",
        2,
        "127.0.0.1",
        sched_port,
        worker_port,
        run_dir=str(tmp_path / "run"),
        checkpoint_dir=str(tmp_path / "ckpt"),
        device="cpu",
    )
    try:
        sched.wait_for_workers(2, timeout=30)
        job_ids = [sched.add_job(job) for job in jobs]
        runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 45})
        runner.start()
        runner.join(timeout=300)
        assert not runner.is_alive(), "shockwave physical round loop wedged"
        assert len(sched._job_completion_times) == 3
        for job_id in job_ids:
            assert sched._job_completion_times[job_id] is not None
            assert sched._total_steps_run[job_id] >= 600
        # The planner actually planned (at least one solve happened).
        assert sched._shockwave.solve_records
    finally:
        sched.shutdown()


def test_transformer_payload_runs_to_completion(tmp_path):
    """The port's training program as the payload, at a tiny width on the
    worker's ``--device cpu``: two jobs of several leases each complete,
    every attempt's summary line names the CPU, and later attempts resume
    from the job's checkpoint."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sched = start_local_cluster(
        "fifo", 2,
        run_dir=str(tmp_path / "run"),
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    command = (f"{sys.executable} -m shockwave_tpu_torch.models.train "
               "--model Transformer --batch_size 2 --vocab_size 64 "
               "--d_model 32 --num_heads 2 --num_layers 1 --seq_len 16")
    try:
        job_ids = [
            sched.add_job(Job(job_type="Transformer (batch size 16)",
                              command=command, working_directory=repo,
                              num_steps_arg="-n", total_steps=steps))
            for steps in (40, 400)
        ]
        runner = threading.Thread(target=sched.run, kwargs={"max_rounds": 40})
        runner.start()
        runner.join(timeout=300)
        assert not runner.is_alive(), "round loop did not converge"
    finally:
        sched.shutdown()
    for job_id, steps in zip(job_ids, (40, 400)):
        assert sched._job_completion_times.get(job_id) is not None
        assert sched._total_steps_run[job_id] >= steps
    outputs = sorted((tmp_path / "run").glob("*.stdout"))
    assert outputs
    for path in outputs:
        assert "device=cpu" in path.read_text(), path.read_text()[-2000:]
    for job_id in job_ids:
        attempts = sorted(
            (tmp_path / "run").glob(f"job={job_id.integer}_*.stdout"),
            key=lambda p: int(p.name.split("round=")[1].split(".")[0]))
        for later in attempts[1:]:
            assert "RESUMED from" in later.read_text()


@pytest.mark.slow
def test_ingest_tick_admits_mid_round(cluster, monkeypatch):
    """With SHOCKWAVE_INGEST_TICK_S set, the ingest thread drains the
    front door on its own cadence: a batch submitted mid-round enters
    the job table before the next round boundary, and the tick counter
    proves the thread (not the boundary drain) did the admitting."""
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.runtime.rpc.submitter_client import SubmitterClient

    monkeypatch.setenv("SHOCKWAVE_INGEST_TICK_S", "0.2")
    obs.configure(metrics=True)
    try:
        sched, tmp_path = cluster
        sched.expect_stream()
        runner = threading.Thread(
            target=sched.run, kwargs={"max_rounds": 30}
        )
        runner.start()
        client = SubmitterClient("127.0.0.1", sched._port, client_id="ig")
        client.submit([make_job(400)])
        # Land the second batch squarely inside a running round: the
        # 0.2s tick must admit it long before the 3s boundary.
        time.sleep(1.0)
        client.submit([make_job(400)])
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(sched._jobs) < 2:
            time.sleep(0.05)
        ticks = sum(
            s["value"]
            for s in obs.counter(
                "ingest_ticks_total", ""
            ).snapshot_series()
        )
        client.close_stream()
        runner.join(timeout=120)
        assert not runner.is_alive()
        assert ticks >= 1, "ingest thread never admitted mid-round"
        assert len(sched._job_completion_times) == 2
        assert all(
            t is not None for t in sched._job_completion_times.values()
        )
    finally:
        sched._shutdown_requested.set()
        obs.reset()


@pytest.mark.slow
def test_ingest_mid_round_arrivals_replay_exactly(tmp_path, monkeypatch):
    """Acceptance for the event-driven ingest plane: mid-round
    delta-admissions (streamed arrivals absorbed into the planner via
    the delta-patched warm start) leave a flight-recorder log that
    replays BIT-EXACTLY — the streaming path must not break replay
    forensics."""
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.obs import recorder as rec
    from shockwave_tpu_torch.runtime.rpc.submitter_client import SubmitterClient

    monkeypatch.setenv("SHOCKWAVE_INGEST_TICK_S", "0.2")
    log = str(tmp_path / "decisions.jsonl")
    obs.configure_recorder(log)
    sched = start_local_cluster(
        "shockwave_tpu_pdhg", 2,
        run_dir=str(tmp_path / "run"),
        checkpoint_dir=str(tmp_path / "ckpt"),
        shockwave_config={
            "num_gpus": 2,
            "time_per_iteration": 3.0,
            "future_rounds": 6,
            "lambda": 5.0,
            "k": 10.0,
        },
    )
    try:
        sched.expect_stream()
        runner = threading.Thread(
            target=sched.run, kwargs={"max_rounds": 30}
        )
        runner.start()
        client = SubmitterClient("127.0.0.1", sched._port, client_id="rp")
        client.submit([make_job(400)])
        time.sleep(1.0)  # the second arrival is a mid-round delta
        client.submit([make_job(400)])
        client.close_stream()
        runner.join(timeout=120)
        assert not runner.is_alive()
        assert len(sched._job_completion_times) == 2
    finally:
        sched.shutdown()
        obs.get_recorder().close()
    results = rec.replay_log(log, device="cpu")
    assert results, "no plan records recorded"
    assert all(not r["diff"] for r in results), [
        r["round"] for r in results if r["diff"]
    ]
    obs.reset()


@pytest.mark.slow
def test_heartbeat_coalesces_metrics_push_with_liveness():
    """The combined heartbeat+metrics RPC: a beat carrying
    ``metrics_text`` must (1) keep the PR-7 liveness contract — the
    heartbeat callback fires exactly as for a thin beat, clock fields
    intact — and (2) deliver the dump to the fleet plane so the next
    poll tick SKIPS that target; a thin beat must leave the fleet
    store untouched. Legacy workers (no metrics_text) therefore keep
    the pull path."""
    from shockwave_tpu_torch.obs.fleet import FleetTelemetry
    from shockwave_tpu_torch.runtime.rpc import scheduler_server
    from shockwave_tpu_torch.runtime.rpc.worker_client import WorkerRpcClient

    fleet = FleetTelemetry(scrape_interval_s=30.0)
    pulls = []

    def pull():
        pulls.append(time.monotonic())
        return "# HELP pulled_series help\npulled_series 1.0\n"

    fleet.add_target("0", pull)
    beats = []

    def heartbeat(worker_id, est_offset_s=0.0, est_rtt_s=0.0):
        beats.append((int(worker_id), est_offset_s, est_rtt_s))

    def worker_metrics(worker_id, text):
        # The scheduler maps worker_id -> fleet label; this test's map
        # is the identity.
        fleet.accept_push(str(int(worker_id)), text)

    port = free_port()
    server = scheduler_server.serve(
        port,
        {
            "heartbeat": heartbeat,
            "worker_metrics": worker_metrics,
            "sched_epoch": lambda: 7,
        },
    )
    try:
        client = WorkerRpcClient("127.0.0.1", port)
        # Thin beat: liveness only, fleet store untouched.
        sample, epoch = client.send_heartbeat(
            0, est_offset_s=0.01, est_rtt_s=0.002
        )
        assert epoch == 7 and sample is not None
        assert beats == [(0, 0.01, 0.002)]
        assert fleet.poll_once() == 1  # nothing fresh: pull happens
        assert len(pulls) == 1

        # Fat beat: same liveness callback + the dump lands in the
        # fleet store under the worker's label.
        text = "# HELP pushed_series help\npushed_series 2.0\n"
        sample, epoch = client.send_heartbeat(
            0, est_offset_s=0.01, est_rtt_s=0.002, metrics_text=text
        )
        assert epoch == 7 and sample is not None
        assert len(beats) == 2 and beats[1] == beats[0]
        assert "pushed_series" in fleet.render()
        # The push is fresher than the poll interval: the next tick
        # must NOT pull this target again (the coalesced RPC already
        # carried its data) yet still counts it as answered.
        assert fleet.poll_once() == 1
        assert len(pulls) == 1
        # A push for an unknown label is dropped, not resurrected.
        assert not fleet.accept_push("99", "ghost 1.0\n")
        assert "ghost" not in fleet.render()
    finally:
        server.stop(0)
