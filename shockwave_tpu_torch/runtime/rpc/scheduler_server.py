"""Scheduler-side RPC server: hosts WorkerToScheduler and
IteratorToScheduler (reference: scheduler/runtime/rpc/scheduler_server.py).

Callbacks supplied by the scheduler:
  register_worker(worker_type, num_accelerators, ip_addr, port)
      -> (worker_ids, round_duration)     (raises on rejection)
  done(worker_id, job_ids, num_steps, execution_times, iterator_logs)
  init_job(job_id) -> (max_steps, max_duration, extra_time)
  update_lease(job_id, worker_id, steps, duration, max_steps, max_duration)
      -> (max_steps, max_duration, extra_time)
  submit_jobs(token, specs, close)
      -> (status, retry_after_s, admitted, queue_depth)
      (the streaming-admission front door; see runtime/admission.py)
  submit_jobs_many(requests) -> aligned [(status, retry_after_s,
      admitted, queue_depth)] for requests = [(token, jobs, close)]
      with Job objects (optional — arms the read-loop frame
      coalescer: concurrent SubmitJobs handler threads decode their
      frames in parallel, then convoy through ONE vectorized call
      here instead of N scalar ones; see _SubmitCoalescer)
  worker_metrics(worker_id, text)
      (optional — a heartbeat that coalesced the worker's due metrics
      dump delivers the Prometheus text here, saving the fleet
      telemetry pull RPC; see obs/fleet.py)
  explain_job(job_id) -> narrative dict or None
      (market explainability; optional — the ExplainJob method is
      registered only when this callback is wired, see obs/explain.py)

SubmitJobs requests are deserialized by fastwire's columnar-aware
scanner (one top-level pass; the received buffer IS the string arena —
no per-job message objects for either the legacy or the columnar
encoding). Handlers stay duck-compatible with plain
admission_pb2.SubmitJobsRequest objects for direct callers in tests.
"""

from __future__ import annotations

import logging
import threading
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.runtime.protobuf import (
    common_pb2,
    iterator_to_scheduler_pb2 as it_pb2,
    worker_to_scheduler_pb2 as w2s_pb2,
)
from shockwave_tpu_torch.runtime.rpc import wiring

LOG = logging.getLogger("runtime.scheduler_server")


def _worker_to_scheduler_handlers(callbacks):
    def RegisterWorker(request, context):
        import time

        recv_s = time.time()
        try:
            # The HA re-attach fields (prev_worker_ids /
            # outstanding_job_ids) ride as keywords so legacy callback
            # implementations — and fixtures — that don't know them
            # keep working against a new server.
            kwargs = {}
            if request.prev_worker_ids or request.outstanding_job_ids:
                kwargs = {
                    "prev_worker_ids": list(request.prev_worker_ids),
                    "outstanding_job_ids": list(
                        request.outstanding_job_ids
                    ),
                }
            result = callbacks["register_worker"](
                request.worker_type,
                request.num_accelerators,
                request.ip_addr,
                request.port,
                **kwargs,
            )
            # Callback contract: (worker_ids, round_duration) from
            # legacy schedulers; HA schedulers append (sched_epoch,
            # reattached).
            worker_ids, round_duration = result[0], result[1]
            sched_epoch = result[2] if len(result) > 2 else 0
            reattached = bool(result[3]) if len(result) > 3 else False
            # The scheduler's receive/send wall clock rides back so the
            # agent can take its first NTP-style clock-offset sample
            # (obs/propagate + merge_traces rely on these; a legacy
            # agent just skips the unknown fields).
            return w2s_pb2.RegisterWorkerResponse(
                success=True,
                worker_ids=worker_ids,
                round_duration=int(round_duration),
                sched_recv_s=recv_s,
                sched_send_s=time.time(),
                sched_epoch=int(sched_epoch),
                reattached=reattached,
            )
        except Exception as e:  # noqa: BLE001 - reported to the caller
            LOG.exception("RegisterWorker failed")
            return w2s_pb2.RegisterWorkerResponse(
                success=False, error_message=str(e)
            )

    def SendHeartbeat(request, context):
        import time

        recv_s = time.time()
        cb = callbacks.get("heartbeat")
        if cb is not None:
            cb(
                request.worker_id,
                est_offset_s=request.est_offset_s,
                est_rtt_s=request.est_rtt_s,
            )
        # Heartbeat-coalesced metrics push: a beat that carries the
        # worker's due Prometheus dump feeds the fleet store directly,
        # replacing that cycle's DumpMetrics pull RPC. The liveness
        # callback above already ran — a fat beat is never less alive
        # than a thin one. Binary sketch frames (field 8) take priority
        # over legacy text dumps (field 7): the fleet merges frame
        # histograms into exact fleet quantiles instead of
        # concatenating exposition text.
        frame = getattr(request, "metrics_frame", b"")
        if frame:
            frame_cb = callbacks.get("worker_metrics_frame")
            if frame_cb is not None:
                frame_cb(request.worker_id, frame)
        text = getattr(request, "metrics_text", "")
        if text:
            metrics_cb = callbacks.get("worker_metrics")
            if metrics_cb is not None:
                metrics_cb(request.worker_id, text)
        epoch_cb = callbacks.get("sched_epoch")
        return w2s_pb2.HeartbeatAck(
            sched_recv_s=recv_s,
            sched_send_s=time.time(),
            sched_epoch=int(epoch_cb()) if epoch_cb is not None else 0,
        )

    def Done(request, context):
        callbacks["done"](
            request.worker_id,
            list(request.job_id),
            list(request.num_steps),
            list(request.execution_time),
            list(request.iterator_log),
            trace_contexts=list(request.trace_context),
        )
        return common_pb2.Empty()

    def DumpMetrics(request, context):
        from shockwave_tpu_torch.runtime.protobuf import telemetry_pb2

        cb = callbacks.get("dump_metrics")
        text = cb() if cb is not None else "# no metrics callback wired\n"
        return telemetry_pb2.MetricsDump(text=text)

    def ExplainJob(request, context):
        import json

        from shockwave_tpu_torch.runtime.protobuf import explain_pb2

        try:
            narrative = callbacks["explain_job"](request.job_id)
        except KeyError as e:
            return explain_pb2.ExplainJobResponse(
                found=False, error=f"unknown job: {e}"
            )
        except Exception as e:  # noqa: BLE001 - reported to the caller
            LOG.exception("ExplainJob failed")
            return explain_pb2.ExplainJobResponse(
                found=False, error=str(e)
            )
        if narrative is None:
            return explain_pb2.ExplainJobResponse(
                found=False,
                error=f"no decision trail for job {request.job_id!r} "
                "(is the decision log enabled?)",
            )
        return explain_pb2.ExplainJobResponse(
            found=True,
            narrative_json=json.dumps(
                narrative, sort_keys=True, separators=(",", ":")
            ),
        )

    handlers = {
        "RegisterWorker": RegisterWorker,
        "SendHeartbeat": SendHeartbeat,
        "Done": Done,
        "DumpMetrics": DumpMetrics,
    }
    if "explain_job" in callbacks:
        handlers["ExplainJob"] = ExplainJob
    return handlers


def _iterator_to_scheduler_handlers(callbacks):
    def InitJob(request, context):
        max_steps, max_duration, extra_time = callbacks["init_job"](
            request.job_id
        )
        return it_pb2.UpdateLeaseResponse(
            max_steps=int(max_steps),
            max_duration=float(max_duration),
            extra_time=float(extra_time),
        )

    def UpdateLease(request, context):
        max_steps, max_duration, extra_time = callbacks["update_lease"](
            request.job_id,
            request.worker_id,
            request.steps,
            request.duration,
            request.max_steps,
            request.max_duration,
        )
        return it_pb2.UpdateLeaseResponse(
            max_steps=int(max_steps),
            max_duration=float(max_duration),
            extra_time=float(extra_time),
        )

    return {"InitJob": InitJob, "UpdateLease": UpdateLease}


class _SubmitCoalescer:
    """Read-loop frame coalescing for the admission front door:
    concurrent SubmitJobs handler threads have already decoded their
    frames (in parallel, zero-copy over their recv buffers); they stage
    the decoded ``(token, jobs, close)`` here, and the first thread to
    find no leader running commits the whole convoy — its own entry
    plus everything that piled up while it worked — through ONE
    ``submit_jobs_many`` call. Followers block on their entry's event
    and return the leader's aligned verdict. Mirrors the group-commit
    convoy in runtime/admission.py, lifted to the wire handler so the
    vectorized admission pass also absorbs the per-request callback
    overhead."""

    def __init__(self, submit_many):
        self._submit_many = submit_many
        self._lock = sanitize.make_lock(
            "runtime.rpc.scheduler_server._SubmitCoalescer._lock"
        )
        self._staged: list = []
        self._leader = False

    def submit(self, token, jobs, close):
        entry = [token, jobs, close, threading.Event(), None, None]
        with self._lock:
            self._staged.append(entry)
            if self._leader:
                leader = False
            else:
                self._leader = True
                leader = True
        if not leader:
            entry[3].wait()
            if entry[5] is not None:
                raise entry[5]
            return entry[4]
        try:
            while True:
                with self._lock:
                    convoy = self._staged
                    self._staged = []
                    if not convoy:
                        self._leader = False
                        break
                try:
                    outs = self._submit_many(
                        [(e[0], e[1], e[2]) for e in convoy]
                    )
                    for e, out in zip(convoy, outs):
                        e[4] = out
                        e[3].set()
                except BaseException as exc:
                    for e in convoy:
                        if e[4] is None:
                            e[5] = exc
                        e[3].set()
                    raise
        except BaseException:
            with self._lock:
                self._leader = False
                leftover = self._staged
                self._staged = []
            for e in leftover:
                e[5] = e[5] or RuntimeError(
                    "submit coalescer leader died before this entry"
                )
                e[3].set()
            raise
        if entry[5] is not None:
            raise entry[5]
        return entry[4]


def _admission_handlers(callbacks):
    from shockwave_tpu_torch.runtime import admission
    from shockwave_tpu_torch.runtime.protobuf import admission_pb2 as adm_pb2
    from shockwave_tpu_torch.runtime.protobuf import fastwire

    submit_many = callbacks.get("submit_jobs_many")
    coalescer = (
        _SubmitCoalescer(submit_many) if submit_many is not None else None
    )
    # One batch decodes at a time. The handler threads share one
    # interpreter lock, and the decode's numpy calls let it go: with
    # several frames decoding at once, each call that lets it go waits
    # out another thread's switch interval to get it back, and a batch's
    # decode costs several times its own work (the ingest soak, full
    # campaign). Threads waiting here block on this lock instead, and the
    # coalescer below still convoys whatever finished decoding.
    decode_lock = sanitize.make_lock(
        "runtime.rpc.scheduler_server._admission_handlers.decode_lock"
    )

    def SubmitJobs(request, context):
        caps = int(getattr(request, "wire_caps", 0))
        try:
            # fastwire-deserialized requests carry the batch as
            # columns (whichever encoding the peer sent); plain
            # admission_pb2 requests from direct callers still carry
            # JobSpec objects.
            if coalescer is not None:
                with decode_lock:
                    cols = getattr(request, "columns", None)
                    jobs = (
                        admission.jobs_from_columns(cols)
                        if cols is not None
                        else [
                            admission.job_from_spec_dict(
                                _spec_dict(spec)
                            )
                            for spec in request.jobs
                        ]
                    )
                status, retry_after_s, admitted, depth = coalescer.submit(
                    request.token, jobs, bool(request.close)
                )
            else:
                with decode_lock:
                    cols = getattr(request, "columns", None)
                    specs = (
                        cols.to_spec_dicts()
                        if cols is not None
                        else [_spec_dict(spec) for spec in request.jobs]
                    )
                status, retry_after_s, admitted, depth = callbacks[
                    "submit_jobs"
                ](request.token, specs, bool(request.close))
            return adm_pb2.SubmitJobsResponse(
                status=status,
                retry_after_s=float(retry_after_s),
                admitted=int(admitted),
                queue_depth=int(depth),
                # Echo columnar support only to peers that asked, so a
                # legacy client's response bytes stay byte-identical.
                wire_caps=(
                    fastwire.CAP_COLUMNAR
                    if caps & fastwire.CAP_COLUMNAR
                    else 0
                ),
            )
        except ValueError as e:
            # A malformed spec is the SUBMITTER's bug: report it on the
            # response instead of burning its retry budget — retrying
            # an unrunnable job can never succeed.
            return adm_pb2.SubmitJobsResponse(
                status="INVALID", error=str(e)
            )
        except Exception as e:  # noqa: BLE001 - reported to the caller
            LOG.exception("SubmitJobs failed")
            return adm_pb2.SubmitJobsResponse(status="ERROR", error=str(e))

    return {"SubmitJobs": SubmitJobs}


def _spec_dict(spec) -> dict:
    """Wire-facing spec dict from one admission_pb2.JobSpec (the legacy
    per-message decode path for direct/test callers)."""
    return {
        "job_type": spec.job_type,
        "command": spec.command,
        "working_directory": spec.working_directory,
        "num_steps_arg": spec.num_steps_arg,
        "total_steps": spec.total_steps,
        "scale_factor": spec.scale_factor,
        "mode": spec.mode,
        "priority_weight": spec.priority_weight,
        "slo": spec.slo,
        "duration": spec.duration,
        "needs_data_dir": spec.needs_data_dir,
        "tenant": spec.tenant,
        "trace_context": spec.trace_context,
    }


def _admission_deserializers() -> dict:
    from shockwave_tpu_torch.runtime.protobuf import fastwire

    return {"SubmitJobs": fastwire.FastSubmitRequest.FromString}


def serve(
    port: int, callbacks: dict, max_workers: int = 32
) -> wiring.Server:
    """Start (and return) the scheduler's server; non-blocking."""
    services = {
        "WorkerToScheduler": (
            _worker_to_scheduler_handlers(callbacks), None,
        ),
        "IteratorToScheduler": (
            _iterator_to_scheduler_handlers(callbacks), None,
        ),
    }
    if "submit_jobs" in callbacks or "submit_jobs_many" in callbacks:
        services["AdmissionToScheduler"] = (
            _admission_handlers(callbacks), _admission_deserializers(),
        )
    return wiring.serve(port, services, max_workers)
