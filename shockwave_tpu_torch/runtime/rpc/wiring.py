"""The control plane's transport: unary calls over plain TCP sockets.

The JAX package carries these services on gRPC (its
``runtime/rpc/wiring.py``); the port keeps the service table, the
method paths and every message's bytes, and replaces only the transport
with the standard library's sockets, so it needs neither ``grpcio`` nor
``google.protobuf``. The bytes of each message equal the JAX package's;
the framing around them does not (ROADMAP.md, queue 3).

A call is one frame each way on a persistent connection, one call in
flight per connection:

    request   >I length | >H path length | path | >d timeout_s | message
    response  >I length | >B status code | message (OK) or details (utf-8)

``path`` is ``/shockwave_tpu.<Service>/<Method>``; ``timeout_s`` is the
caller's remaining deadline in seconds (0: none), relative so that the
two hosts' clocks need not agree.

Client: :func:`insecure_channel` returns a :class:`Channel` holding a
pool of idle connections to one address; a call borrows one (or
connects), and returns it when the exchange completed. An idle
connection the peer has closed is dropped before it is lent out, and a
request whose send fails on a reused connection goes once more on a
fresh one; a request that was sent is never sent again, since the peer
may have run it (the callers' retry policy decides).
Errors come back as :class:`RpcError` with a :class:`StatusCode`: a
refused or reset connection is ``UNAVAILABLE``, a missed deadline
``DEADLINE_EXCEEDED`` (the connection is dropped, since its late answer
would desynchronise the stream), an unknown path ``UNIMPLEMENTED``, a
handler's ``context.abort(code, details)`` that code, and any other
handler exception ``INTERNAL``.

Server: :func:`serve` starts a :class:`Server` whose one I/O thread
accepts connections and watches the idle ones; a connection with a
request ready goes to a bounded thread pool (``max_workers``), whose
thread reads the frame, runs the handler and writes the answer, then
hands the connection back to the I/O thread. ``stop(grace)`` stops
taking calls at once (a request arriving after it is answered
``UNAVAILABLE``), lets calls in flight finish for up to ``grace``
seconds, then closes every connection and the listening socket.
"""

from __future__ import annotations

import concurrent.futures
import enum
import logging
import select
import selectors
import socket
import struct
import threading
import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

from shockwave_tpu_torch.runtime.protobuf import (
    admission_pb2 as adm_pb2,
    common_pb2,
    explain_pb2,
    iterator_to_scheduler_pb2 as it_pb2,
    scheduler_to_worker_pb2 as s2w_pb2,
    telemetry_pb2,
    worker_to_scheduler_pb2 as w2s_pb2,
)

LOG = logging.getLogger("runtime.rpc.wiring")

# The proto package: the method paths are the JAX package's.
PACKAGE = "shockwave_tpu"

SERVICES = {
    "WorkerToScheduler": {
        "RegisterWorker": (
            w2s_pb2.RegisterWorkerRequest,
            w2s_pb2.RegisterWorkerResponse,
        ),
        # The ack carries the scheduler's receive/send timestamps for the
        # NTP-style clock-offset exchange.
        "SendHeartbeat": (w2s_pb2.Heartbeat, w2s_pb2.HeartbeatAck),
        "Done": (w2s_pb2.DoneRequest, common_pb2.Empty),
        # The scheduler's metrics registry as Prometheus text.
        "DumpMetrics": (
            telemetry_pb2.MetricsRequest,
            telemetry_pb2.MetricsDump,
        ),
        # One job's decision narrative; registered only when the
        # scheduler wires an explain_job callback.
        "ExplainJob": (
            explain_pb2.ExplainJobRequest,
            explain_pb2.ExplainJobResponse,
        ),
    },
    "SchedulerToWorker": {
        "RunJob": (s2w_pb2.RunJobRequest, common_pb2.Empty),
        "KillJob": (s2w_pb2.KillJobRequest, common_pb2.Empty),
        "Reset": (common_pb2.Empty, common_pb2.Empty),
        "Shutdown": (common_pb2.Empty, common_pb2.Empty),
        # The fleet telemetry plane polls each worker agent's registry.
        "DumpMetrics": (
            telemetry_pb2.MetricsRequest,
            telemetry_pb2.MetricsDump,
        ),
    },
    "IteratorToScheduler": {
        "InitJob": (it_pb2.InitJobRequest, it_pb2.UpdateLeaseResponse),
        "UpdateLease": (it_pb2.UpdateLeaseRequest, it_pb2.UpdateLeaseResponse),
    },
    # Streaming admission front door (runtime/admission.py).
    "AdmissionToScheduler": {
        "SubmitJobs": (
            adm_pb2.SubmitJobsRequest,
            adm_pb2.SubmitJobsResponse,
        ),
    },
}

# Largest frame either side takes: a 4 MB metrics text fits with room.
MAX_FRAME_BYTES = 64 << 20
# Connect timeout of a call without a deadline: a black-holed host must
# not hang its caller.
CONNECT_TIMEOUT_S = 20.0
# How long a server thread waits for the rest of a frame whose first
# byte arrived.
FRAME_READ_TIMEOUT_S = 30.0
_LEN = struct.Struct(">I")
_PATH_LEN = struct.Struct(">H")
_TIMEOUT = struct.Struct(">d")
_CODE = struct.Struct(">B")


class StatusCode(enum.Enum):
    """The status codes the plane reads or produces (gRPC's numbers)."""

    OK = 0
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14


_CODES = {c.value: c for c in StatusCode}


class RpcError(Exception):
    """A call that did not return a response: ``code()`` says why and
    ``details()`` gives the message."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


def _parse_target(target: str) -> Tuple[str, int]:
    host, sep, port = target.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"target {target!r} is not host:port")
    host = host.strip("[]")
    if host in ("", "::", "0.0.0.0"):
        host = "127.0.0.1"
    return host, int(port)


def _recv_exact(sock: socket.socket, n: int, deadline=None) -> bytes:
    """``n`` bytes from ``sock``; EOFError when the peer closes before
    the first of them (or mid-frame), socket.timeout past ``deadline``
    (time.monotonic)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("deadline passed")
            sock.settimeout(remaining)
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise EOFError(f"peer closed after {got} of {n} bytes")
        got += k
    return bytes(buf)


# -- client -------------------------------------------------------------


def _dropped(sock: socket.socket) -> bool:
    """Whether an idle connection was closed or reset by its peer: with
    no call in flight nothing may be readable on it but the end of the
    stream."""
    poller = select.poll()
    poller.register(sock, select.POLLIN | select.POLLERR | select.POLLHUP)
    return bool(poller.poll(0))


class Channel:
    """Persistent connections to one ``host:port``: a pool of idle
    sockets, one call in flight on each."""

    def __init__(self, target: str):
        self.target = target
        self._addr = _parse_target(target)
        self._lock = threading.Lock()
        self._idle: list = []
        self._closed = False

    def _connect(self, deadline) -> socket.socket:
        timeout = CONNECT_TIMEOUT_S
        if deadline is not None:
            timeout = max(min(timeout, deadline - time.monotonic()), 1e-3)
        try:
            sock = socket.create_connection(self._addr, timeout=timeout)
        except socket.timeout:
            raise RpcError(
                StatusCode.DEADLINE_EXCEEDED,
                f"connect to {self.target} timed out",
            ) from None
        except OSError as e:
            raise RpcError(
                StatusCode.UNAVAILABLE, f"connect to {self.target}: {e}"
            ) from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _acquire(self, deadline) -> Tuple[socket.socket, bool]:
        with self._lock:
            while self._idle:
                sock = self._idle.pop()
                if not _dropped(sock):
                    return sock, True
                sock.close()
        return self._connect(deadline), False

    def _release(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed:
                self._idle.append(sock)
                return
        sock.close()

    def call(self, path: str, payload: bytes, timeout=None) -> bytes:
        """One unary exchange; returns the response message's bytes or
        raises :class:`RpcError`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if timeout is not None and timeout <= 0:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "deadline passed")
        path_bytes = path.encode("utf-8")
        body_len = _PATH_LEN.size + len(path_bytes) + _TIMEOUT.size + len(
            payload)
        if body_len > MAX_FRAME_BYTES:
            raise RpcError(
                StatusCode.RESOURCE_EXHAUSTED,
                f"request of {body_len} bytes exceeds {MAX_FRAME_BYTES}",
            )
        for attempt in range(2):
            sock, reused = self._acquire(deadline)
            remaining = 0.0 if deadline is None else max(
                deadline - time.monotonic(), 1e-6)
            frame = b"".join((
                _LEN.pack(body_len), _PATH_LEN.pack(len(path_bytes)),
                path_bytes, _TIMEOUT.pack(remaining), payload,
            ))
            try:
                sock.settimeout(
                    None if deadline is None
                    else max(deadline - time.monotonic(), 1e-6))
                sock.sendall(frame)
            except socket.timeout:
                sock.close()
                raise RpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"{path} to {self.target}: deadline of {timeout} s "
                    "exceeded",
                ) from None
            except OSError as e:
                sock.close()
                if reused and attempt == 0:
                    # The peer closed this connection while it sat idle
                    # (a restart) and no whole request reached it: once
                    # more on a fresh one.
                    continue
                raise RpcError(
                    StatusCode.UNAVAILABLE, f"{path} to {self.target}: {e}"
                ) from None
            try:
                (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size, deadline))
                if length < 1 or length > MAX_FRAME_BYTES:
                    sock.close()
                    raise RpcError(
                        StatusCode.INTERNAL,
                        f"response frame of {length} bytes",
                    )
                body = _recv_exact(sock, length, deadline)
            except socket.timeout:
                sock.close()
                raise RpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"{path} to {self.target}: deadline of {timeout} s "
                    "exceeded",
                ) from None
            except (EOFError, OSError) as e:
                # The request was sent: the peer may have run it.
                sock.close()
                raise RpcError(
                    StatusCode.UNAVAILABLE, f"{path} to {self.target}: {e}"
                ) from None
            self._release(sock)
            code = _CODES.get(body[0], StatusCode.INTERNAL)
            if code is StatusCode.OK:
                return body[1:]
            raise RpcError(code, body[1:].decode("utf-8", "replace"))
        raise AssertionError("unreachable")

    def unary_unary(self, path: str, request_serializer: Callable,
                    response_deserializer: Callable) -> "_UnaryMethod":
        return _UnaryMethod(self, path, request_serializer,
                            response_deserializer)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            sock.close()


_FUTURES: Optional[concurrent.futures.ThreadPoolExecutor] = None
_FUTURES_LOCK = threading.Lock()


def _futures_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _FUTURES
    with _FUTURES_LOCK:
        if _FUTURES is None:
            _FUTURES = concurrent.futures.ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="rpc-future"
            )
        return _FUTURES


class _UnaryMethod:
    """A client stub's method: ``stub(request, timeout=None)`` blocks for
    the response; ``stub.future(request, timeout=None)`` returns a
    ``concurrent.futures.Future`` of it (the call on a connection of its
    own)."""

    def __init__(self, channel, path, serializer, deserializer):
        self._channel = channel
        self._path = path
        self._serializer = serializer
        self._deserializer = deserializer

    def __call__(self, request, timeout=None):
        payload = self._serializer(request)
        return self._deserializer(
            self._channel.call(self._path, payload, timeout)
        )

    def future(self, request, timeout=None) -> concurrent.futures.Future:
        payload = self._serializer(request)

        def run():
            return self._deserializer(
                self._channel.call(self._path, payload, timeout)
            )

        return _futures_pool().submit(run)


def insecure_channel(target: str) -> Channel:
    """A channel to ``host:port`` (the name is gRPC's; there is no
    transport security on either)."""
    return Channel(target)


def make_stubs(channel: Channel, service: str) -> SimpleNamespace:
    """Client stubs for every method of ``service`` on ``channel``."""
    stubs = {}
    for method, (req_cls, resp_cls) in SERVICES[service].items():
        stubs[method] = channel.unary_unary(
            f"/{PACKAGE}.{service}/{method}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
    return SimpleNamespace(**stubs)


# -- server -------------------------------------------------------------


class _Context:
    """What a handler gets beside its request: ``abort(code, details)``
    ends the call with that status."""

    @staticmethod
    def abort(code: StatusCode, details: str = ""):
        raise RpcError(code, details)


class Server:
    """Threaded unary server (see the module docstring)."""

    def __init__(self, max_workers: int):
        self._max_workers = int(max_workers)
        self._methods: Dict[str, tuple] = {}
        self._listener: Optional[socket.socket] = None
        self._port = 0
        self._selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._returned: list = []
        self._lock = threading.Lock()
        self._idle_cv = threading.Condition(self._lock)
        self._in_flight: set = set()
        self._open: set = set()
        self._stopping = False
        self._stopped = threading.Event()
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._io_thread: Optional[threading.Thread] = None

    def add_method(self, path: str, handler: Callable,
                   request_deserializer: Callable,
                   response_serializer: Callable) -> None:
        self._methods[path] = (handler, request_deserializer,
                               response_serializer)

    def add_insecure_port(self, address: str) -> int:
        """Listen on ``host:port`` (``[::]`` or an empty host: every IPv4
        interface; port 0: a free one); returns the bound port."""
        host, _, port = address.rpartition(":")
        host = host.strip("[]")
        if host in ("", "::"):
            host = "0.0.0.0"
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, int(port)))
        listener.listen(128)
        listener.setblocking(False)
        self._listener = listener
        self._port = listener.getsockname()[1]
        return self._port

    @property
    def port(self) -> int:
        """The bound port (kept after stop)."""
        return self._port

    def start(self) -> None:
        if self._listener is None:
            raise RuntimeError("add_insecure_port before start")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._max_workers, thread_name_prefix="rpc-server"
        )
        self._selector.register(self._listener, selectors.EVENT_READ, "accept")
        self._selector.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._io_thread = threading.Thread(
            target=self._io_loop, name="rpc-server-io", daemon=True
        )
        self._io_thread.start()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass

    def _io_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    break
                returned, self._returned = self._returned, []
            for conn in returned:
                try:
                    self._selector.register(conn, selectors.EVENT_READ, "conn")
                except (ValueError, KeyError, OSError):
                    self._close(conn)
            for key, _ in self._selector.select(timeout=0.5):
                if key.data == "accept":
                    self._accept()
                elif key.data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    conn = key.fileobj
                    self._selector.unregister(conn)
                    with self._lock:
                        if self._stopping:
                            self._returned.append(conn)
                            continue
                        self._in_flight.add(conn)
                    self._pool.submit(self._serve_one, conn)

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            conn.setblocking(True)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._open.add(conn)
            self._selector.register(conn, selectors.EVENT_READ, "conn")

    def _close(self, conn: socket.socket) -> None:
        with self._lock:
            self._open.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def _serve_one(self, conn: socket.socket) -> None:
        keep = False
        try:
            keep = self._exchange(conn)
        except Exception:  # noqa: BLE001 - the connection is dropped
            LOG.debug("rpc connection dropped", exc_info=True)
            keep = False
        finally:
            with self._lock:
                self._in_flight.discard(conn)
                stopping = self._stopping
                if keep and not stopping:
                    self._returned.append(conn)
                self._idle_cv.notify_all()
            if keep and not stopping:
                self._wake()
            else:
                self._close(conn)

    def _exchange(self, conn: socket.socket) -> bool:
        """Serve one request on ``conn``; False when it must be closed."""
        read_deadline = time.monotonic() + FRAME_READ_TIMEOUT_S
        try:
            header = _recv_exact(conn, _LEN.size, read_deadline)
        except EOFError:
            return False  # the client closed its idle connection
        (length,) = _LEN.unpack(header)
        if length < _PATH_LEN.size + _TIMEOUT.size or length > MAX_FRAME_BYTES:
            return False
        body = _recv_exact(conn, length, read_deadline)
        received = time.monotonic()
        (path_len,) = _PATH_LEN.unpack_from(body, 0)
        pos = _PATH_LEN.size
        path = body[pos:pos + path_len].decode("utf-8", "replace")
        pos += path_len
        (timeout_s,) = _TIMEOUT.unpack_from(body, pos)
        pos += _TIMEOUT.size
        payload = body[pos:]
        deadline = received + timeout_s if timeout_s > 0 else None
        code, out = self._dispatch(path, payload, deadline)
        answer = _CODE.pack(code.value) + out
        conn.settimeout(FRAME_READ_TIMEOUT_S)
        conn.sendall(_LEN.pack(len(answer)) + answer)
        return True

    def _dispatch(self, path, payload, deadline):
        with self._lock:
            stopping = self._stopping
        if stopping:
            return StatusCode.UNAVAILABLE, b"server is stopping"
        entry = self._methods.get(path)
        if entry is None:
            return (StatusCode.UNIMPLEMENTED,
                    f"method {path} not found".encode("utf-8"))
        if deadline is not None and time.monotonic() >= deadline:
            return StatusCode.DEADLINE_EXCEEDED, b"deadline passed in queue"
        handler, deserializer, serializer = entry
        try:
            request = deserializer(payload)
            response = handler(request, _Context())
            return StatusCode.OK, serializer(response)
        except RpcError as e:
            return e.code(), e.details().encode("utf-8")
        except Exception as e:  # noqa: BLE001 - reported to the caller
            LOG.exception("handler of %s raised", path)
            return (StatusCode.INTERNAL,
                    f"exception calling {path}: {e!r}".encode("utf-8"))

    def stop(self, grace: Optional[float] = None) -> threading.Event:
        """Stop taking calls, let those in flight finish for up to
        ``grace`` seconds, then close every connection and the listening
        socket. Returns an event set when the server is down."""
        with self._lock:
            if self._stopping:
                return self._stopped
            self._stopping = True
        self._wake()
        if self._io_thread is not None:
            self._io_thread.join(timeout=5.0)
        deadline = time.monotonic() + (grace or 0.0)
        with self._lock:
            while self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._idle_cv.wait(remaining)
            conns = list(self._open)
            self._open.clear()
            self._returned = []
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                if sock is not None:
                    sock.close()
            except OSError:
                pass
        try:
            self._selector.close()
        except (OSError, RuntimeError):
            pass
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self._stopped.set()
        return self._stopped


def add_servicer(
    server: Server,
    service: str,
    handlers: dict,
    request_deserializers: dict = None,
) -> None:
    """Register ``handlers`` ({method: fn(request, context) -> response})
    for ``service``. ``request_deserializers`` overrides the request
    decoder per method (the admission server swaps in fastwire's
    columnar-aware scan for SubmitJobs); the bytes on the wire are
    unchanged."""
    for method, fn in handlers.items():
        req_cls, resp_cls = SERVICES[service][method]
        deserializer = (request_deserializers or {}).get(
            method, req_cls.FromString
        )
        server.add_method(
            f"/{PACKAGE}.{service}/{method}", fn, deserializer,
            resp_cls.SerializeToString,
        )


def serve(port: int, services: dict, max_workers: int) -> Server:
    """Start a server on ``port`` with ``services``:
    {service: (handlers, request_deserializers or None)}."""
    srv = Server(max_workers)
    for service, (handlers, deserializers) in services.items():
        add_servicer(srv, service, handlers, deserializers)
    srv.add_insecure_port(f"[::]:{port}")
    srv.start()
    return srv
