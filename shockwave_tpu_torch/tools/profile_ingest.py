"""Per-stage profile of the ingest wire path: where a SubmitJobs batch's
time goes, stage by stage, in one process.

    python -m shockwave_tpu_torch.tools.profile_ingest [-o results/ingest_torch/profile_ingest.json]

The port's counterpart of the JAX package's
``scripts/profiling/profile_ingest.py``, over the port's own codec
(``runtime/protobuf/admission_pb2.py``, ``fastwire.py``). The stages, each
over the same generated batches, in ns a job and jobs/s (the best of
``--repeats`` sweeps):

- ``encode_scalar`` / ``encode_columnar``: the client's request build and
  serialisation (a JobSpec list against the columnar frame);
- ``decode_scalar``: the per-message parse, a spec dict and
  ``job_from_spec_dict`` a job;
- ``decode_columnar_legacy``: the columnar decode over legacy bytes (what
  the server does for a legacy peer);
- ``decode_columnar_frame``: the columnar decode over the negotiated
  frame;
- ``ledger``: ``AdmissionQueue.submit_many`` of the decoded batches (dedup
  probe, quota, backpressure), drained between sweeps;
- ``ack_encode``: one ``SubmitJobsResponse`` serialised a batch.

The transport is the ingest soak's to measure (``tools/ingest_soak.py``),
not this profile's. Nothing here touches a device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

MODELS = [("ResNet-18", 32), ("ResNet-50", 64)]


def make_spec_dicts(num_jobs: int, seed: int = 0):
    from shockwave_tpu_torch.data.workload_info import steps_per_epoch

    rng = np.random.default_rng(seed)
    specs = []
    for i in range(num_jobs):
        model, bs = MODELS[int(rng.integers(len(MODELS)))]
        specs.append({
            "job_type": f"{model} (batch size {bs})",
            "command": "python3 main.py",
            "working_directory": "",
            "num_steps_arg": "-n",
            "total_steps": steps_per_epoch(model, bs),
            "scale_factor": 1,
            "mode": "static",
            "priority_weight": 0.0,
            "slo": 0.0,
            "duration": 0.0,
            "needs_data_dir": False,
            "tenant": f"t{i % 3}",
            "trace_context": "",
        })
    return specs


def _rates(best_ns: float, total_jobs: int) -> dict:
    return {"ns_per_job": round(best_ns / total_jobs, 1),
            "jobs_per_s": round(total_jobs / (best_ns / 1e9), 1)}


def timed(fn, batches, jobs_per_batch: int, repeats: int) -> dict:
    """ns a job and jobs/s of ``fn(batch)`` over every batch, the best of
    ``repeats`` sweeps."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for batch in batches:
            fn(batch)
        best = min(best, time.perf_counter_ns() - t0)
    return _rates(best, jobs_per_batch * len(batches))


def profile(batches: int, batch_size: int, repeats: int) -> dict:
    """Every stage's rate, the wire bytes a job and the server path's sum
    a job for each peer kind."""
    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2
    from shockwave_tpu_torch.runtime.protobuf import fastwire
    from shockwave_tpu_torch.runtime.rpc.scheduler_server import _spec_dict

    n, b = batches, batch_size
    spec_batches = [make_spec_dicts(b, seed=k) for k in range(n)]

    def encode_scalar(specs):
        return adm_pb2.SubmitJobsRequest(
            token="tok", jobs=[adm_pb2.JobSpec(**s) for s in specs],
        ).SerializeToString()

    def encode_columnar(specs):
        return adm_pb2.SubmitJobsRequest(
            token="tok", jobs_columnar=fastwire.encode_columnar_block(specs),
            wire_caps=fastwire.CAP_COLUMNAR,
        ).SerializeToString()

    stages = {
        "encode_scalar": timed(encode_scalar, spec_batches, b, repeats),
        "encode_columnar": timed(encode_columnar, spec_batches, b, repeats),
    }
    legacy_bytes = [encode_scalar(s) for s in spec_batches]
    frame_bytes = [encode_columnar(s) for s in spec_batches]
    wire_bytes = {
        "legacy_bytes_per_job": round(sum(map(len, legacy_bytes)) / (n * b),
                                      1),
        "columnar_bytes_per_job": round(sum(map(len, frame_bytes)) / (n * b),
                                        1),
    }

    def decode_scalar(data):
        request = adm_pb2.SubmitJobsRequest.FromString(data)
        return [admission.job_from_spec_dict(_spec_dict(spec))
                for spec in request.jobs]

    def decode_columnar(data):
        return admission.jobs_from_columns(
            fastwire.FastSubmitRequest.FromString(data).columns)

    stages["decode_scalar"] = timed(decode_scalar, legacy_bytes, b, repeats)
    stages["decode_columnar_legacy"] = timed(decode_columnar, legacy_bytes, b,
                                             repeats)
    stages["decode_columnar_frame"] = timed(decode_columnar, frame_bytes, b,
                                            repeats)
    # The profile never times a decoder that disagrees with the scalar one.
    for data in legacy_bytes[:2]:
        if decode_scalar(data) != decode_columnar(data):
            raise AssertionError("the columnar decode disagrees with the "
                                 "scalar one")

    queue = admission.build_queue(capacity=max(65536, 2 * n * b),
                                  retry_delay_s=0.05)
    job_batches = [decode_columnar(data) for data in frame_bytes]
    counter = {"k": 0}
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for jobs in job_batches:
            counter["k"] += 1
            queue.submit_many([(f"tok-{counter['k']}", jobs)])
        best = min(best, time.perf_counter_ns() - t0)
        queue.drain()
    stages["ledger"] = _rates(best, n * b)

    ack = adm_pb2.SubmitJobsResponse(status="ACCEPTED", admitted=b,
                                     queue_depth=1234)
    stages["ack_encode"] = timed(lambda _: ack.SerializeToString(),
                                 spec_batches, b, repeats)

    def path_ns(*names):
        return round(sum(stages[s]["ns_per_job"] for s in names), 1)

    return {
        "config": {"batches": n, "batch_size": b, "repeats": repeats,
                   "cpu_count": os.cpu_count()},
        "wire_bytes": wire_bytes,
        "stages": stages,
        "server_path_ns_per_job": {
            "scalar": path_ns("decode_scalar", "ledger", "ack_encode"),
            "columnar_legacy_peer": path_ns("decode_columnar_legacy",
                                            "ledger", "ack_encode"),
            "columnar_negotiated": path_ns("decode_columnar_frame", "ledger",
                                           "ack_encode"),
        },
    }


def main(args) -> int:
    from shockwave_tpu_torch.utils.fileio import atomic_write_json

    result = profile(args.batches, args.batch_size, args.repeats)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    atomic_write_json(args.out, result)
    print(json.dumps({k: v["ns_per_job"]
                      for k, v in result["stages"].items()}))
    print(json.dumps(result["server_path_ns_per_job"]))
    print(f"wrote {args.out}")
    return 0


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--out",
                        default="results/ingest_torch/profile_ingest.json")
    parser.add_argument("--batches", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--repeats", type=int, default=5)
    return parser


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
