"""The port's ingest soak (``tools/ingest_soak.py``) on the CPU: its
decode-parity gate; the JAX package's SubmitJobs handler and the port's on
the same requests (byte-identical acks, equal drained jobs); a reduced
campaign of two mixed hosts over the port's socket front door (zero lost,
zero double-admitted, every fault recovered, both peer kinds moving jobs);
and the pricing phase against the JAX package's ``run_pricing_phase``
(the same decisions, the lane audit bit-identical)."""

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest

from shockwave_tpu_torch.tools import ingest_soak

ROOT = Path(__file__).resolve().parent.parent


def _jax_module(name, relative):
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(name, ROOT / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_decode_parity_gate_holds():
    assert ingest_soak.parity_check() == 0


def _jax_drive(requests, columnar):
    """The requests through the JAX package's handler, decoded as its
    server decodes them (its protobuf parse, or its columnar decode)."""
    from shockwave_tpu.runtime import admission
    from shockwave_tpu.runtime.protobuf import admission_pb2 as adm_pb2
    from shockwave_tpu.runtime.protobuf import fastwire
    from shockwave_tpu.runtime.rpc.scheduler_server import (
        _admission_handlers,
    )

    queue = admission.build_queue(capacity=4096, retry_delay_s=0.05)

    def submit_jobs_many(reqs):
        outs = queue.submit_many(reqs)
        depth = queue.depth()
        return [(s, r, a, depth) for (s, r, a) in outs]

    handler = _admission_handlers(
        {"submit_jobs_many": submit_jobs_many})["SubmitJobs"]
    acks = []
    for token, specs in requests:
        if columnar:
            request = fastwire.FastSubmitRequest.FromString(
                adm_pb2.SubmitJobsRequest(
                    token=token,
                    jobs_columnar=fastwire.encode_columnar_block(specs),
                    wire_caps=fastwire.CAP_COLUMNAR).SerializeToString())
        else:
            request = adm_pb2.SubmitJobsRequest.FromString(
                adm_pb2.SubmitJobsRequest(
                    token=token, jobs=[adm_pb2.JobSpec(**s) for s in specs],
                ).SerializeToString())
        ack = handler(request, None)
        ack.wire_caps = 0
        acks.append(ack.SerializeToString())
    return acks, [(token, job) for token, job, _enq in queue.drain()]


@pytest.mark.parametrize("columnar", [False, True])
def test_the_port_handler_answers_as_the_jax_handler(columnar):
    requests = ingest_soak.parity_requests()
    jax_acks, jax_jobs = _jax_drive(requests, columnar)
    decoder = (ingest_soak.columnar_request if columnar
               else ingest_soak.scalar_request)
    port_acks, port_jobs = ingest_soak.drive_handler(requests, decoder)
    assert port_acks == jax_acks
    assert [(t, dataclasses.asdict(j)) for t, j in port_jobs] == [
        (t, dataclasses.asdict(j)) for t, j in jax_jobs]
    assert len(port_jobs) == 224  # the poisoned and repeated batches drop


def _reduced_args(tmp_path, **overrides):
    args = ingest_soak.build_parser().parse_args(
        ["--device", "cpu", "--out", str(tmp_path), "--result_name",
         "reduced.json"])
    for key, value in dict(ingest_soak.SMOKE, result_name="reduced.json",
                           jobs_per_worker=320, batch_size=16, window=4,
                           **overrides).items():
        setattr(args, key, value)
    return args


def test_a_reduced_campaign_holds_exactly_once_over_mixed_peers(tmp_path):
    """Two hosts (a columnar and a legacy peer) of 320 jobs under client
    chaos through the socket front door: every token's jobs drain once,
    every fault recovers, both peer kinds move jobs, the queue drains."""
    rep = ingest_soak.run_rep(_reduced_args(tmp_path), 0)
    assert rep["process_failures"] == []
    assert rep["total_jobs"] == 640 and rep["admitted_observed"] == 640
    assert rep["lost"] == {} and rep["double_admitted"] == {}
    assert rep["faults_applied"] == 6 and rep["faults_unrecovered"] == []
    assert rep["queue_depth_end"] == 0
    assert {m: v["jobs"] for m, v in rep["interop"].items()} == {
        "columnar": 320, "legacy": 320}
    assert rep["queue_p99_ms"] is not None
    manifests = sorted(tmp_path.glob("reduced_rep0_worker_*.json"))
    assert [json.loads(p.read_text())["wire_mode"] for p in manifests] == [
        "columnar", "legacy"]


def test_a_lost_token_is_a_violation(tmp_path):
    args = _reduced_args(tmp_path)
    rep = {"rep": 0, "process_failures": [], "interop": {
        "columnar": {"jobs": 1}, "legacy": {"jobs": 1}}, "lost": {"t": 1},
        "double_admitted": {}, "queue_depth_end": 0,
        "faults_unrecovered": [], "faults_applied": 1, "queue_p99_ms": 1.0,
        "submits_per_s": 1e9}
    pricing = {"audit": {"bit_identical": True}, "dispatches": 1,
               "lanes_priced": 6}
    assert ingest_soak.violations_of(args, [rep], pricing) == [
        "rep 0: LOST jobs: 1 tokens short"]


def test_the_pricing_phase_decides_as_the_jax_package():
    jax_soak = _jax_module("jax_ingest_soak", "scripts/ingest_soak.py")
    jax_result = jax_soak.run_pricing_phase(6)
    port = ingest_soak.run_pricing_phase(6, device="cpu")
    assert port["decisions"] == jax_result["decisions"]
    assert port["lanes_priced"] == jax_result["lanes_priced"] == 6
    assert port["audit"]["bit_identical"] is True
    assert jax_result["audit"]["bit_identical"] is True
    assert port["audit"] == jax_result["audit"]
    assert port["audit"]["mismatched"] == []
    assert port["dispatches"] < port["lanes_priced"]
    assert port["device"] == "cpu"


# A wall-clock campaign under the smoke's rate floor and p99 budget.
@pytest.mark.wallclock_retry
def test_the_smoke_exits_zero(tmp_path):
    """``--smoke``: the parity gate, then the campaign at the smoke's
    shape, floors and pricing lanes."""
    args = ingest_soak.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--out", str(tmp_path)])
    assert ingest_soak.main(args) == 0
    result = json.loads((tmp_path / "ingest_smoke.json").read_text())
    assert result["violations"] == []
    assert result["throughput"]["total_jobs"] == 3000
    assert result["config"]["min_rate"] == 4000.0


@pytest.mark.parametrize("specs", [
    # Every string column constant (one back-to-back run in the frame).
    [{"job_type": "ResNet-18 (batch size 32)", "command": "python3 x.py",
      "total_steps": 5, "tenant": "t0"}] * 9,
    # Constant but for one row, and an all-empty column beside them.
    [{"job_type": "ResNet-18 (batch size 32)", "command": "c",
      "total_steps": 5, "mode": "static" if i != 4 else "accordion"}
     for i in range(9)],
    # One job, and a multi-byte value.
    [{"job_type": "ResNet-50 (batch size 64)", "command": "é",
      "total_steps": 1}],
    # No job: the end-of-stream close.
    [],
])
def test_repeated_columns_decode_alike_from_both_encodings(specs):
    """The columnar decode's shortcuts for empty and one-valued columns
    give what the scalar parse gives, over the columnar frame and over
    legacy bytes (whose strings never lie back to back)."""
    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2
    from shockwave_tpu_torch.runtime.protobuf import fastwire

    legacy = adm_pb2.SubmitJobsRequest(
        token="t", jobs=[adm_pb2.JobSpec(**s) for s in specs],
    ).SerializeToString()
    from shockwave_tpu_torch.runtime.rpc.scheduler_server import _spec_dict

    expected = [admission.job_from_spec_dict(_spec_dict(s)) for s in (
        ingest_soak.scalar_request("t", specs).jobs)]
    for request in (ingest_soak.columnar_request("t", specs),
                    fastwire.FastSubmitRequest.FromString(legacy)):
        assert admission.jobs_from_columns(request.columns) == expected


def _mixed_specs(n: int, seed: int):
    """A batch as the soak's submitters send it (job types of one width
    in random order), with the optional fields drawn too: priorities,
    SLOs, durations, data-dir flags, tenants, modes and step arguments,
    some left at their defaults."""
    import numpy as np

    rng = np.random.default_rng(seed)
    types = ["ResNet-18 (batch size 32)", "ResNet-50 (batch size 64)",
             "LM (batch size 80)"]
    specs = []
    for i in range(n):
        spec = {"job_type": types[int(rng.integers(2 if seed % 2 else 3))],
                "command": "python3 main.py", "total_steps": int(
                    rng.integers(1, 900)), "scale_factor": int(
                    rng.integers(0, 3))}
        if rng.random() < 0.5:
            spec["priority_weight"] = float(rng.choice([0.0, 2.5, -0.0]))
        if rng.random() < 0.5:
            spec["slo"] = float(rng.choice([0.0, 1.5, -2.0]))
        if rng.random() < 0.5:
            spec["duration"] = float(rng.choice([0.0, 3600.0]))
        if rng.random() < 0.3:
            spec["needs_data_dir"] = True
        if rng.random() < 0.5:
            spec["tenant"] = f"t{int(rng.integers(3))}"
        if rng.random() < 0.5:
            spec["mode"] = str(rng.choice(["", "static", "accordion"]))
        if rng.random() < 0.3:
            spec["num_steps_arg"] = str(rng.choice(["", "--steps"]))
        specs.append(spec)
    return specs


@pytest.mark.parametrize("seed", range(4))
def test_the_columnar_decode_gives_the_scalar_jobs_in_one_pass(seed):
    """The line-rate decode (one fixed-width pass over a string column of
    one width, a job built column by column) gives the scalar parse's
    jobs over both encodings, and decodes each distinct string once."""
    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2
    from shockwave_tpu_torch.runtime.protobuf import fastwire
    from shockwave_tpu_torch.runtime.rpc.scheduler_server import _spec_dict

    specs = _mixed_specs(300, seed)
    expected = [admission.job_from_spec_dict(_spec_dict(s)) for s in (
        ingest_soak.scalar_request("t", specs).jobs)]
    legacy = fastwire.FastSubmitRequest.FromString(adm_pb2.SubmitJobsRequest(
        token="t", jobs=[adm_pb2.JobSpec(**s) for s in specs],
    ).SerializeToString())
    for request in (ingest_soak.columnar_request("t", specs), legacy):
        cols = request.columns
        assert admission.jobs_from_columns(cols) == expected
        # One decode a distinct value: the job-type column is one
        # fixed-width pass whose values are shared between jobs.
        job_types = cols.strs(0)
        assert len({id(v) for v in job_types}) == len(set(job_types))


def test_a_bad_job_type_names_the_first_offending_job():
    from shockwave_tpu_torch.runtime import admission

    specs = _mixed_specs(40, 1)
    specs[7]["job_type"] = "not a job type"
    specs[9]["total_steps"] = 0
    request = ingest_soak.columnar_request("t", specs)
    with pytest.raises(ValueError, match="'not a job type'"):
        admission.jobs_from_columns(request.columns)
    specs[7]["job_type"] = "ResNet-18 (batch size 32)"
    with pytest.raises(ValueError, match="total_steps must be positive"):
        admission.jobs_from_columns(
            ingest_soak.columnar_request("t", specs).columns)


def test_handler_threads_decode_one_batch_at_a_time(monkeypatch):
    """Concurrent SubmitJobs frames decode one at a time (the decode's
    numpy calls let the interpreter lock go, and several decodes at once
    each wait out the others' switch intervals), and every batch is
    admitted once."""
    import threading
    import time

    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.rpc.scheduler_server import (
        _admission_handlers,
    )

    inside = [0]
    most = [0]
    real = admission.jobs_from_columns

    def slow(cols):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.01)
        try:
            return real(cols)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(admission, "jobs_from_columns", slow)
    queue = admission.build_queue(capacity=100000, retry_delay_s=0.05)

    def submit_jobs_many(reqs):
        outs = queue.submit_many(reqs)
        return [(s, r, a, queue.depth()) for (s, r, a) in outs]

    handler = _admission_handlers(
        {"submit_jobs_many": submit_jobs_many})["SubmitJobs"]
    requests = [ingest_soak.columnar_request(f"b{k}", _mixed_specs(50, k))
                for k in range(12)]
    acks = [None] * len(requests)

    def call(k):
        acks[k] = handler(requests[k], None)

    threads = [threading.Thread(target=call, args=(k,))
               for k in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert most[0] == 1
    assert [a.status for a in acks] == ["ACCEPTED"] * len(requests)
    drained = queue.drain()
    assert len(drained) == 50 * len(requests)
    assert sorted({token for token, _, _ in drained}) == sorted(
        f"b{k}" for k in range(len(requests)))


def test_the_drain_observes_each_wait_and_tallies_tenants():
    """The drain's waits (one numpy pass) land in the latency histogram as
    per-job observations would, the worst wait keeps its token, and the
    tenants' tally releases what the submits reserved."""
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.core.job import Job
    from shockwave_tpu_torch.runtime import admission

    obs.reset()
    obs.configure(metrics=True)
    try:
        clock = [100.0]
        queue = admission.build_queue(capacity=1000, retry_delay_s=0.05,
                                      clock=lambda: clock[0])
        waits = {}
        for k, tenant in enumerate(["", "a", "b", None, "a"]):
            jobs = [Job(job_type="ResNet-18 (batch size 32)",
                        total_steps=10, tenant=tenant) for _ in range(k + 1)]
            queue.submit(f"tok{k}", jobs)
            waits[f"tok{k}"] = 10.0 - k
            clock[0] += 1.0
        clock[0] = 110.0
        assert admission._TenantLedger.batch_counts(
            [Job(job_type="x", tenant=t) for t in ("b", "", "a", "b", None)]
        ) == {"b": 2, "a": 1}
        drained = queue.drain()
        assert len(drained) == 15
        series = obs.get_registry().snapshot()["metrics"][
            "admission_queue_latency_seconds"]["series"][0]
        assert series["count"] == 15
        assert series["sum"] == pytest.approx(
            sum((k + 1) * (10.0 - k) for k in range(5)))
        assert series["max"] == 10.0
        assert queue._tenants.pending_of(["a", "b"]) == [0, 0]
    finally:
        obs.reset()
