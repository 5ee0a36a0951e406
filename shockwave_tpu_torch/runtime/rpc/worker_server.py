"""Worker-side RPC server: hosts SchedulerToWorker (reference:
scheduler/runtime/rpc/worker_server.py).

Callbacks: run_job(job_descriptions, worker_id, round_id),
kill_job(job_id), reset(), shutdown(). Job descriptions carry the
dispatching scheduler span's ``trace_context`` so the dispatcher's
launch/run spans join the job's cross-process causal chain
(obs/propagate.py). DumpMetrics serves the agent's own metrics
registry to the scheduler's fleet telemetry plane (obs/fleet.py).

Epoch fencing (shockwave_tpu/ha/): when the optional ``fence_epoch``
callback is wired, RunJob/KillJob requests carrying a non-zero
``sched_epoch`` below the highest epoch this worker has witnessed are
rejected with FAILED_PRECONDITION — a deposed leader's dispatches and
kills bounce instead of double-running work the successor owns.
Requests with epoch 0 (legacy / HA-off schedulers) pass unfenced.
"""

from __future__ import annotations

from shockwave_tpu_torch.runtime.protobuf import common_pb2
from shockwave_tpu_torch.runtime.rpc import wiring


def _handlers(callbacks):
    def _fence(request, context, method: str):
        """Reject a fenced (stale-epoch) control RPC; returns True when
        the request was aborted."""
        gate = callbacks.get("fence_epoch")
        epoch = getattr(request, "sched_epoch", 0)
        if gate is None or not epoch:
            return False
        witnessed = gate(int(epoch))
        if witnessed <= int(epoch):
            return False
        from shockwave_tpu_torch import obs

        obs.counter(
            "worker_fenced_rpcs_total",
            "dispatch/kill RPCs rejected for carrying a superseded "
            "scheduler epoch",
        ).inc(method=method)
        context.abort(
            wiring.StatusCode.FAILED_PRECONDITION,
            f"fenced: {method} carries scheduler epoch {epoch} but this "
            f"worker has witnessed epoch {witnessed}",
        )
        return True  # unreachable (abort raises); keeps the contract clear

    def RunJob(request, context):
        if _fence(request, context, "RunJob"):
            return common_pb2.Empty()
        jobs = [
            {
                "job_id": d.job_id,
                "job_type": d.job_type,
                "command": d.command,
                "working_directory": d.working_directory,
                "needs_data_dir": d.needs_data_dir,
                "num_steps_arg": d.num_steps_arg,
                "num_steps": d.num_steps,
                "duration": d.duration if d.has_duration else None,
                "trace_context": d.trace_context,
            }
            for d in request.job_descriptions
        ]
        callbacks["run_job"](jobs, request.worker_id, request.round_id)
        return common_pb2.Empty()

    def KillJob(request, context):
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.obs import propagate

        if _fence(request, context, "KillJob"):
            return common_pb2.Empty()
        kill_ctx = propagate.from_wire(request.trace_context)
        if kill_ctx is not None:
            # The kill lands in the job's causal chain as a child of
            # the scheduler's kill span.
            obs.instant(
                "kill_job", cat="worker", pid="worker", tid="control",
                args={"job_id": int(request.job_id),
                      "trace_id": kill_ctx.trace_id,
                      "parent_span_id": kill_ctx.span_id},
            )
        callbacks["kill_job"](request.job_id)
        return common_pb2.Empty()

    def DumpMetrics(request, context):
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.runtime.protobuf import telemetry_pb2

        return telemetry_pb2.MetricsDump(text=obs.render_prometheus())

    def Reset(request, context):
        callbacks["reset"]()
        return common_pb2.Empty()

    def Shutdown(request, context):
        callbacks["shutdown"]()
        return common_pb2.Empty()

    return {
        "RunJob": RunJob,
        "KillJob": KillJob,
        "Reset": Reset,
        "Shutdown": Shutdown,
        "DumpMetrics": DumpMetrics,
    }


def serve(
    port: int, callbacks: dict, max_workers: int = 16
) -> wiring.Server:
    """Start (and return) the worker agent's server; non-blocking."""
    return wiring.serve(
        port, {"SchedulerToWorker": (_handlers(callbacks), None)},
        max_workers,
    )
