"""Training-loop iterator -> scheduler RPC client (reference:
scheduler/runtime/rpc/iterator_client.py)."""

from __future__ import annotations

from shockwave_tpu_torch.runtime.protobuf import iterator_to_scheduler_pb2 as it_pb2
from shockwave_tpu_torch.runtime.rpc.wiring import insecure_channel, make_stubs


class IteratorRpcClient:
    def __init__(self, job_id: int, worker_id: int, sched_ip_addr: str, sched_port: int):
        self._job_id = int(job_id)
        self._worker_id = int(worker_id)
        self._addr = f"{sched_ip_addr}:{sched_port}"
        # One persistent connection for the process's lease protocol.
        self._stubs = make_stubs(
            insecure_channel(self._addr), "IteratorToScheduler"
        )

    def init(self):
        """Returns (max_steps, max_duration, extra_time)."""
        r = self._stubs.InitJob(it_pb2.InitJobRequest(job_id=self._job_id))
        return r.max_steps, r.max_duration, r.extra_time

    def update_lease(self, steps: int, duration: float, max_steps: int, max_duration: float):
        """Returns (max_steps, max_duration, extra_time)."""
        r = self._stubs.UpdateLease(
            it_pb2.UpdateLeaseRequest(
                job_id=self._job_id,
                worker_id=self._worker_id,
                steps=int(steps),
                duration=float(duration),
                max_steps=int(max_steps),
                max_duration=float(max_duration),
            )
        )
        return r.max_steps, r.max_duration, r.extra_time
