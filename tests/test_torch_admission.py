"""The port's streaming admission (``runtime/admission.py``) against the
JAX package's.

The same seeded submit / close / drain / retry / quota sequences go
through both packages' ``AdmissionQueue`` and ``ShardedAdmissionQueue``
(and their vectorized ``submit_many``): every verdict (status, retry
delay, admitted count), every drained job in its order with its token
and enqueue time, and the queues' summaries must be equal. A streaming
simulation of the golden trace through ``StreamingSubmitter`` must equal
the JAX package's in makespan, average JCT and worst FTF within 1e-3, in
its rounds.
"""

import importlib

import numpy as np
import pytest

from shockwave_tpu.core.job import Job as JaxJob
from shockwave_tpu.runtime import admission as jax_admission
from shockwave_tpu.runtime import faults as jax_faults
from shockwave_tpu_torch.core.job import Job as PortJob
from shockwave_tpu_torch.runtime import admission as port_admission
from shockwave_tpu_torch.runtime import faults as port_faults
from shockwave_tpu_torch.tools import bench_sim

PACKAGES = {
    "jax": (jax_admission, JaxJob),
    "port": (port_admission, PortJob),
}
QUOTAS = {"a": 3, "b": 5}


@pytest.fixture(autouse=True)
def _no_faults():
    jax_faults.reset()
    port_faults.reset()
    yield
    jax_faults.reset()
    port_faults.reset()


def _spec(rng, i) -> dict:
    return dict(
        job_type=f"ResNet-18 (batch size {int(rng.choice([16, 32]))})",
        command=f"python3 main.py {i}",
        total_steps=int(rng.integers(1, 5000)),
        scale_factor=int(rng.choice([1, 1, 2])),
        priority_weight=float(rng.choice([1.0, 1.0, 2.0, 0.5])),
        tenant=str(rng.choice(["", "a", "b"])),
    )


def _script(seed: int, steps: int = 120) -> list:
    """A seeded op sequence: submits (fresh tokens and retries of old
    ones), drains and submit_many calls, then the close."""
    rng = np.random.default_rng(seed)
    ops, tokens, t, n = [], [], 0.0, 0
    for _ in range(steps):
        t += float(rng.uniform(0, 3))
        kind = rng.choice(["submit", "retry", "drain", "many"],
                          p=[.55, .2, .13, .12])
        if kind in ("submit", "retry") and (kind == "submit" or not tokens):
            specs = [_spec(rng, n + k) for k in range(int(rng.integers(0, 5)))]
            n += len(specs)
            token = f"tok-{len(tokens)}"
            tokens.append((token, specs))
            ops.append(("submit", token, specs, False, t))
        elif kind == "retry":
            token, specs = tokens[int(rng.integers(0, len(tokens)))]
            ops.append(("submit", token, specs, False, t))
        elif kind == "drain":
            ops.append(("drain", (None if rng.random() < .5
                                  else int(rng.integers(1, 6))), t))
        elif kind == "many":
            batch = []
            for _ in range(int(rng.integers(1, 4))):
                specs = [_spec(rng, n + k)
                         for k in range(int(rng.integers(0, 4)))]
                n += len(specs)
                token = f"tok-{len(tokens)}"
                tokens.append((token, specs))
                batch.append((token, specs, False))
            ops.append(("many", batch, t))
    # The stream closes on a batch; later batches bounce, a retry of an
    # accepted one is still acknowledged, and the rest drains.
    token, specs = tokens[-1]
    ops.append(("submit", "tok-last", [_spec(rng, n)], True, t + 1))
    ops.append(("close", t + 2))
    ops.append(("submit", "tok-late", [_spec(rng, n + 1)], False, t + 3))
    ops.append(("submit", token, specs, False, t + 4))
    ops.append(("drain", None, t + 5))
    return ops


def _replay(package: str, ops: list, sharded: bool, priority: bool):
    admission, Job = PACKAGES[package]
    clock = {"t": 0.0}
    kwargs = dict(capacity=8, retry_delay_s=2.0, clock=lambda: clock["t"],
                  priority_aware=priority, tenant_quotas=QUOTAS)
    queue = (admission.ShardedAdmissionQueue(3, **kwargs) if sharded
             else admission.AdmissionQueue(**kwargs))
    trail = []
    for op in ops:
        clock["t"] = op[-1]
        if op[0] == "submit":
            _, token, specs, close, now = op
            jobs = [Job(**s) for s in specs]
            trail.append(("submit", token,
                          queue.submit(token, jobs, close=close, now=now),
                          queue.depth()))
        elif op[0] == "many":
            _, batch, now = op
            requests = [(token, [Job(**s) for s in specs], close)
                        for token, specs, close in batch]
            trail.append(("many", queue.submit_many(requests, now=now),
                          queue.depth()))
        elif op[0] == "drain":
            _, max_jobs, now = op
            drained = queue.drain(max_jobs=max_jobs, now=now)
            trail.append(("drain", [
                (token, job.command, job.total_steps, job.tenant, enqueued)
                for token, job, enqueued in drained]))
        else:
            queue.close()
            trail.append(("close", queue.closed))
    summary = queue.summary()
    return trail, summary


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("priority", [False, True], ids=["fifo", "priority"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_verdicts_tokens_and_drain_order_match(seed, priority, sharded):
    ops = _script(seed)
    jax_trail, jax_summary = _replay("jax", ops, sharded, priority)
    port_trail, port_summary = _replay("port", ops, sharded, priority)
    assert port_trail == jax_trail
    assert port_summary == jax_summary
    statuses = {entry[2][0] for entry in jax_trail if entry[0] == "submit"}
    # The sequences reach backpressure, tenant quotas and the close.
    assert {"ACCEPTED", "RETRY_AFTER", "QUOTA", "CLOSED"} <= statuses
    assert jax_summary["deduped_batches"] >= 1


def test_spec_dicts_round_trip_between_the_packages():
    rng = np.random.default_rng(4)
    for i in range(20):
        spec = _spec(rng, i)
        jax_job, port_job = JaxJob(**spec), PortJob(**spec)
        jax_dict = jax_admission.job_to_spec_dict(jax_job)
        assert port_admission.job_to_spec_dict(port_job) == jax_dict
        back = port_admission.job_from_spec_dict(jax_dict)
        assert vars(back) == vars(jax_admission.job_from_spec_dict(jax_dict))
    with pytest.raises(ValueError):
        port_admission.job_from_spec_dict({"job_type": "no batch size"})


def _stream_run(package: str, policy: str) -> dict:
    """The golden trace (8 v100s, 120 s rounds) admitted through a
    StreamingSubmitter in ``package``."""
    pkg = {"jax": "shockwave_tpu", "port": "shockwave_tpu_torch"}[package]
    data = importlib.import_module(f"{pkg}.data")
    oracle_mod = importlib.import_module(f"{pkg}.data.default_oracle")
    scheduler = importlib.import_module(f"{pkg}.core.scheduler")
    policies = importlib.import_module(f"{pkg}.policies")
    admission = importlib.import_module(f"{pkg}.runtime.admission")
    trace = str(bench_sim.GOLDEN_TRACE)
    jobs, arrivals = data.parse_trace(trace)
    oracle = oracle_mod.generate_oracle()
    profiles = data.load_or_synthesize_profiles(trace, jobs, oracle,
                                                cache=False)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    config = {"num_gpus": 8, "time_per_iteration": 120,
              "future_rounds": 20, "lambda": 5.0, "k": 10.0}
    policy_obj = (policies.get_policy(policy, device="cpu", seed=0)
                  if package == "port" else policies.get_policy(policy, seed=0))
    sched = scheduler.Scheduler(
        policy_obj, throughputs=oracle, seed=0, time_per_iteration=120,
        profiles=profiles, shockwave_config=config)
    submitter = admission.StreamingSubmitter(arrivals, jobs, batch_size=2)
    makespan = sched.simulate({"v100": 8}, submitter=submitter,
                              admission_capacity=4, admission_retry_s=30.0)
    ftf, _ = sched.get_finish_time_fairness()
    return dict(makespan=makespan, avg_jct=sched.get_average_jct(),
                worst_ftf=max(ftf), rounds=sched._num_completed_rounds,
                admitted=sched._num_jobs_in_trace,
                summary=sched._admission.summary())


@pytest.mark.parametrize("policy", ["shockwave_tpu_level",
                                    "max_min_fairness"])
def test_streaming_golden_simulation_matches_the_jax_package(policy):
    ref = _stream_run("jax", policy)
    port = _stream_run("port", policy)
    assert port["rounds"] == ref["rounds"]
    assert port["admitted"] == ref["admitted"] == 12
    for key in ("makespan", "avg_jct", "worst_ftf"):
        assert port[key] == pytest.approx(ref[key], rel=1e-3), key
    assert port["summary"] == ref["summary"]
    assert ref["summary"]["closed"] and ref["summary"]["depth"] == 0


def test_streaming_simulation_refuses_a_checkpoint():
    from shockwave_tpu_torch.core.scheduler import Scheduler
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.policies import get_policy

    submitter = port_admission.StreamingSubmitter(
        [0.0], [PortJob(job_type="ResNet-18 (batch size 32)", total_steps=5)])
    sched = Scheduler(get_policy("max_min_fairness"),
                      throughputs=generate_oracle(), seed=0)
    with pytest.raises(ValueError, match="checkpoint"):
        sched.simulate({"v100": 2}, submitter=submitter,
                       checkpoint_file="never.pkl")
