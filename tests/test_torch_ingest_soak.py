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
