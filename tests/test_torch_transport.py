"""The port's socket transport (``runtime/rpc/wiring.py``) and the RPC
clients on it.

Concurrent calls from many threads on shared persistent connections,
deadlines, ``UNAVAILABLE`` once the server stopped, ``UNIMPLEMENTED`` for
a method the server does not serve, a handler's ``abort`` with
``FAILED_PRECONDITION`` surfacing as ``PermanentRpcError`` in the
scheduler's client without a retry, a 4 MB metrics text, and the retry
layer absorbing injected faults (``faults.check_rpc``).
"""

import socket
import threading
import time

import pytest

from shockwave_tpu_torch.runtime import faults
from shockwave_tpu_torch.runtime.protobuf import (
    telemetry_pb2,
    worker_to_scheduler_pb2 as w2s_pb2,
)
from shockwave_tpu_torch.runtime.retry import PermanentRpcError, RetryPolicy
from shockwave_tpu_torch.runtime.rpc import (
    scheduler_server,
    wiring,
    worker_server,
)
from shockwave_tpu_torch.runtime.rpc.scheduler_client import (
    SchedulerRpcClient,
)
from shockwave_tpu_torch.runtime.rpc.worker_client import WorkerRpcClient

FAST = RetryPolicy(attempts=4, base_delay_s=0.01, max_delay_s=0.05,
                   deadline_s=10.0, call_timeout_s=5.0)


def _echo_server(slow_s: float = 0.0, max_workers: int = 8):
    """A WorkerToScheduler server whose heartbeat echoes the worker id in
    ``sched_epoch`` (after ``slow_s``) and whose DumpMetrics returns a
    4 MB text."""
    big = ("shockwave_metric{worker=\"0\"} 1\n" * 140000)[: 4 << 20]

    def heartbeat(request, context):
        if slow_s:
            time.sleep(slow_s)
        return w2s_pb2.HeartbeatAck(sched_recv_s=1.0, sched_send_s=2.0,
                                    sched_epoch=request.worker_id)

    def metrics(request, context):
        return telemetry_pb2.MetricsDump(text=big)

    srv = wiring.serve(0, {"WorkerToScheduler": (
        {"SendHeartbeat": heartbeat, "DumpMetrics": metrics}, None)},
        max_workers)
    return srv, big


def _stubs(port: int):
    return wiring.make_stubs(
        wiring.insecure_channel(f"127.0.0.1:{port}"), "WorkerToScheduler")


def test_concurrent_calls_from_many_threads_share_connections():
    srv, _ = _echo_server(slow_s=0.01)
    try:
        stubs = _stubs(srv.port)
        results, errors = {}, []

        def call(i):
            try:
                for k in range(5):
                    ack = stubs.SendHeartbeat(
                        w2s_pb2.Heartbeat(worker_id=100 * i + k), timeout=10)
                    results[(i, k)] = ack.sched_epoch
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert errors == []
        assert results == {(i, k): 100 * i + k
                           for i in range(24) for k in range(5)}
        # Persistent connections: no more than one per concurrent caller.
        assert len(srv._open) <= 24
    finally:
        srv.stop(0)


def test_a_missed_deadline_raises_and_the_channel_recovers():
    srv, _ = _echo_server(slow_s=0.5)
    try:
        stubs = _stubs(srv.port)
        start = time.monotonic()
        with pytest.raises(wiring.RpcError) as info:
            stubs.SendHeartbeat(w2s_pb2.Heartbeat(worker_id=1), timeout=0.1)
        assert info.value.code() is wiring.StatusCode.DEADLINE_EXCEEDED
        assert time.monotonic() - start < 0.45
        ack = stubs.SendHeartbeat(w2s_pb2.Heartbeat(worker_id=2), timeout=5)
        assert ack.sched_epoch == 2
    finally:
        srv.stop(0)


def test_unavailable_after_stop_and_when_nothing_listens():
    srv, _ = _echo_server()
    stubs = _stubs(srv.port)
    assert stubs.SendHeartbeat(w2s_pb2.Heartbeat(worker_id=4)).sched_epoch == 4
    stopped = srv.stop(grace=1.0)
    assert stopped.is_set()
    with pytest.raises(wiring.RpcError) as info:
        stubs.SendHeartbeat(w2s_pb2.Heartbeat(worker_id=5), timeout=2)
    assert info.value.code() is wiring.StatusCode.UNAVAILABLE
    with pytest.raises(wiring.RpcError) as info:
        _stubs(srv.port).SendHeartbeat(w2s_pb2.Heartbeat(), timeout=2)
    assert info.value.code() is wiring.StatusCode.UNAVAILABLE


def test_stop_lets_calls_in_flight_finish_within_the_grace():
    srv, _ = _echo_server(slow_s=0.3)
    stubs = _stubs(srv.port)
    box = {}
    caller = threading.Thread(target=lambda: box.setdefault(
        "ack", stubs.SendHeartbeat(w2s_pb2.Heartbeat(worker_id=9),
                                   timeout=5)))
    caller.start()
    time.sleep(0.1)
    srv.stop(grace=2.0)
    caller.join(5)
    assert box["ack"].sched_epoch == 9


def test_unknown_method_is_unimplemented():
    srv, _ = _echo_server()
    try:
        # ExplainJob is in the service table but this server does not
        # serve it.
        with pytest.raises(wiring.RpcError) as info:
            _stubs(srv.port).ExplainJob(
                wiring.SERVICES["WorkerToScheduler"]["ExplainJob"][0](
                    job_id="3"), timeout=2)
        assert info.value.code() is wiring.StatusCode.UNIMPLEMENTED
    finally:
        srv.stop(0)


def test_a_handler_exception_is_internal():
    def broken(request, context):
        raise KeyError("boom")

    srv = wiring.serve(0, {"WorkerToScheduler": (
        {"SendHeartbeat": broken}, None)}, 2)
    try:
        with pytest.raises(wiring.RpcError) as info:
            _stubs(srv.port).SendHeartbeat(w2s_pb2.Heartbeat(), timeout=2)
        assert info.value.code() is wiring.StatusCode.INTERNAL
        assert "boom" in info.value.details()
    finally:
        srv.stop(0)


def test_fenced_dispatch_is_a_permanent_error_without_retries():
    """The worker's epoch gate aborts with FAILED_PRECONDITION; the
    scheduler's client raises PermanentRpcError on the first attempt."""
    calls = []
    srv = worker_server.serve(0, {
        "run_job": lambda *a: calls.append(a),
        "kill_job": lambda *a: calls.append(a),
        "reset": lambda: None, "shutdown": lambda: None,
        "fence_epoch": lambda epoch: 5,
    })
    attempts = []
    real_check = faults.check_rpc
    try:
        faults.check_rpc = lambda method, **kw: attempts.append(method)
        client = SchedulerRpcClient("127.0.0.1", srv.port, retry=FAST)
        with pytest.raises(PermanentRpcError, match="fenced"):
            client.run_job([{"job_id": 1, "job_type": "T", "command": "x",
                             "num_steps": 3}], worker_id=0, round_id=1,
                           sched_epoch=3)
        assert attempts == ["RunJob"]
        assert calls == []
        # An unfenced epoch (0, HA off) passes the gate.
        client.run_job([{"job_id": 1, "job_type": "T", "command": "x",
                         "num_steps": 3}], worker_id=0, round_id=1)
        assert len(calls) == 1
    finally:
        faults.check_rpc = real_check
        srv.stop(0)


def test_four_megabyte_metrics_text_round_trips():
    srv = scheduler_server.serve(0, {
        "register_worker": None, "done": None, "init_job": None,
        "update_lease": None,
        "dump_metrics": lambda: "m 1\n" * (1 << 20),
    })
    try:
        text = WorkerRpcClient("127.0.0.1", srv.port, retry=FAST).dump_metrics()
        assert len(text) == 4 << 20 and text == "m 1\n" * (1 << 20)
    finally:
        srv.stop(0)


def test_injected_faults_are_retried_through_the_clients():
    """Two injected Done errors and a delayed heartbeat: the retry layer
    absorbs them, the scheduler sees the report once, and every applied
    fault pairs with a recovery."""
    received = []
    srv = scheduler_server.serve(0, {
        "register_worker": None,
        "done": lambda *a, **k: received.append(a),
        "init_job": None, "update_lease": None,
    })
    plan = faults.FaultPlan(seed=0, events=[
        faults.FaultEvent(0, "rpc_error", method="Done", count=2),
        faults.FaultEvent(1, "rpc_delay", method="SendHeartbeat",
                          delay_s=0.05),
    ])
    injector = faults.configure(plan)
    try:
        client = WorkerRpcClient("127.0.0.1", srv.port, retry=FAST)
        client.notify_scheduler(0, [7], [120], [3.5], ["steps=120"])
        sample, epoch = client.send_heartbeat(0)
        assert epoch == 0 and sample is not None
        assert received == [(0, [7], [120], [3.5], ["steps=120"])]
        summary = injector.summary()
        assert summary["applied"] >= 2
        assert summary["unrecovered"] == [], summary
    finally:
        faults.reset()
        srv.stop(0)


def test_future_calls_resolve_on_their_own_connections():
    srv, _ = _echo_server(slow_s=0.05)
    try:
        stubs = _stubs(srv.port)
        futures = [stubs.SendHeartbeat.future(
            w2s_pb2.Heartbeat(worker_id=i), timeout=5) for i in range(8)]
        assert [f.result().sched_epoch for f in futures] == list(range(8))
    finally:
        srv.stop(0)


class _OneShotServer:
    """A raw socket peer that answers the first request of every
    connection with a ``HeartbeatAck`` and then closes it: at once after
    the answer (``close_after_answer``), or once the connection's second
    request has been read and counted but not answered."""

    def __init__(self, close_after_answer: bool):
        self.close_after_answer = close_after_answer
        self.handled = 0
        self.closed = threading.Event()
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _read_request(self, conn) -> bool:
        header = conn.recv(4, socket.MSG_WAITALL)
        if len(header) < 4:
            return False
        (length,) = wiring._LEN.unpack(header)
        body = b""
        while len(body) < length:
            chunk = conn.recv(length - len(body))
            if not chunk:
                return False
            body += chunk
        self.handled += 1
        return True

    def _accept(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with conn:
                if not self._read_request(conn):
                    continue
                ack = w2s_pb2.HeartbeatAck(sched_epoch=self.handled)
                message = wiring._CODE.pack(0) + ack.SerializeToString()
                conn.sendall(wiring._LEN.pack(len(message)) + message)
                if not self.close_after_answer:
                    self._read_request(conn)
            self.closed.set()

    def stop(self):
        self._listener.close()


def test_a_request_the_peer_read_is_not_sent_again():
    """The peer reads the second request on a reused connection, runs it
    and closes without answering: the call fails ``UNAVAILABLE`` and the
    request ran once, not again on a fresh connection."""
    peer = _OneShotServer(close_after_answer=False)
    try:
        stubs = _stubs(peer.port)
        assert stubs.SendHeartbeat(w2s_pb2.Heartbeat(), timeout=5
                                   ).sched_epoch == 1
        with pytest.raises(wiring.RpcError) as info:
            stubs.SendHeartbeat(w2s_pb2.Heartbeat(), timeout=5)
        assert info.value.code() is wiring.StatusCode.UNAVAILABLE
        assert peer.closed.wait(5)
        assert peer.handled == 2
    finally:
        peer.stop()


def test_an_idle_connection_the_peer_closed_is_replaced():
    """The peer closes each connection after its answer: the next call
    sees the idle connection closed before it sends and goes on a fresh
    one."""
    peer = _OneShotServer(close_after_answer=True)
    try:
        stubs = _stubs(peer.port)
        assert stubs.SendHeartbeat(w2s_pb2.Heartbeat(), timeout=5
                                   ).sched_epoch == 1
        assert peer.closed.wait(5)
        assert stubs.SendHeartbeat(w2s_pb2.Heartbeat(), timeout=5
                                   ).sched_epoch == 2
        assert peer.handled == 2
    finally:
        peer.stop()
