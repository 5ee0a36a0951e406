"""Structured event tracer emitting Chrome trace-event JSON.

Any sim or physical run can produce a timeline loadable in Perfetto /
``chrome://tracing``: the export is ``{"traceEvents": [...]}`` with
``X`` (complete spans), ``B``/``E`` (open spans), ``i`` (instants) and
``M`` (process/thread naming) phases. Tracks are addressed by NAME —
``pid`` is the emitting plane ("scheduler", "solver", a worker host),
``tid`` the lane within it ("rounds", "job 3", "accel 0") — and mapped
to the integer pid/tid the format requires, with ``process_name`` /
``thread_name`` metadata emitted on first use so the viewer shows the
names.

Clock: timestamps are microseconds from a settable clock returning
SECONDS. The default is wall time since tracer creation; the simulator
installs its virtual clock (``Scheduler.get_current_timestamp``) so sim
traces are laid out in simulated time. Spans whose wall duration is
interesting even when the installed clock does not advance during them
(a planner solve inside a sim round) get their measured wall seconds
recorded in ``args.wall_s`` as well.

Disabled tracers hand every ``span()`` caller one shared no-op context
manager — a flag check and no allocation — so instrumented paths are
near-free when tracing is off.
"""

from __future__ import annotations

import json
from shockwave_tpu_torch.analysis import sanitize
import time
from typing import Callable, Dict, Optional, Tuple


class _NullSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting one X event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_pid", "_tid", "_args",
                 "_ts", "_wall_start")

    def __init__(self, tracer, name, cat, pid, tid, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._pid = pid
        self._tid = tid
        self._args = args

    def __enter__(self):
        self._ts = self._tracer._now_us()
        self._wall_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall_s = time.perf_counter() - self._wall_start
        dur = max(self._tracer._now_us() - self._ts, 0.0)
        args = dict(self._args or {})
        args.setdefault("wall_s", round(wall_s, 6))
        if exc_type is not None:
            args["error"] = exc_type.__name__
        self._tracer._emit(
            {
                "name": self._name,
                "cat": self._cat,
                "ph": "X",
                "ts": self._ts,
                "dur": dur if dur > 0 else wall_s * 1e6,
                "args": args,
            },
            self._pid,
            self._tid,
        )
        return False


class EventTracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = sanitize.make_lock("obs.trace.EventTracer._lock")
        self._events: list = []
        self._epoch = time.perf_counter()
        # Wall clock at the tracer's zero point: the anchor
        # merge_traces.py uses to place this process's timeline on the
        # fleet-wide (scheduler) clock. A process that installs its own
        # clock (the physical scheduler's wall-since-start) overrides
        # it via set_meta({"clock": {...}}).
        self._epoch_wall = time.time()
        self._clock: Optional[Callable[[], float]] = None
        # Export metadata (role, worker identity, clock anchor/offset)
        # merged into the dump's otherData.
        self._meta: dict = {}
        # track name -> integer id maps (pids and per-pid tids)
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[str, str], int] = {}

    # -- clock ----------------------------------------------------------
    def set_clock(self, clock: Optional[Callable[[], float]]) -> None:
        """Install a clock returning seconds (e.g. the simulator's
        virtual timestamp); ``None`` restores wall time since tracer
        creation."""
        with self._lock:
            self._clock = clock

    def set_meta(self, meta: dict) -> None:
        """Merge export metadata into the dump's ``otherData`` (one
        level deep: dict values update the existing dict). Processes
        record their role and clock anchor here —
        ``{"clock": {"wall_at_zero_s": ..., "offset_to_scheduler_s":
        ...}}`` is what ``merge_traces.py`` aligns timelines with."""
        with self._lock:
            for key, value in meta.items():
                if isinstance(value, dict) and isinstance(
                    self._meta.get(key), dict
                ):
                    self._meta[key].update(value)
                else:
                    self._meta[key] = dict(value) if isinstance(
                        value, dict
                    ) else value

    def _now_s(self) -> float:
        if self._clock is not None:
            return self._clock()
        return time.perf_counter() - self._epoch

    def _now_us(self) -> float:
        return self._now_s() * 1e6

    # -- track naming ---------------------------------------------------
    def _track(self, pid_name: str, tid_name: str) -> Tuple[int, int]:
        """(pid, tid) ints for named tracks, emitting M naming events on
        first use. Caller holds the lock."""
        pid = self._pids.get(pid_name)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[pid_name] = pid
            self._events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": pid_name},
                }
            )
        tid_key = (pid_name, tid_name)
        tid = self._tids.get(tid_key)
        if tid is None:
            tid = sum(1 for p, _ in self._tids if p == pid_name) + 1
            self._tids[tid_key] = tid
            self._events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tid_name},
                }
            )
        return pid, tid

    def _emit(
        self, event: dict, pid_name: str, tid_name: str,
        stamp_now: bool = False,
    ) -> None:
        if not self.enabled:
            return
        with self._lock:
            if stamp_now:
                # ts sampled under the lock: concurrent emitters on one
                # track (gRPC handler threads) would otherwise append
                # out of timestamp order.
                event["ts"] = self._now_us()
            pid, tid = self._track(pid_name, tid_name)
            event["pid"] = pid
            event["tid"] = tid
            self._events.append(event)

    # -- emission API ---------------------------------------------------
    def span(
        self,
        name: str,
        cat: str = "",
        pid: str = "scheduler",
        tid: str = "main",
        args: Optional[dict] = None,
    ):
        """Context manager producing one X (complete) event."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, pid, tid, args)

    def complete(
        self,
        name: str,
        ts_s: float,
        dur_s: float,
        cat: str = "",
        pid: str = "scheduler",
        tid: str = "main",
        args: Optional[dict] = None,
    ) -> None:
        """Explicit X event (the simulator's path: it knows both
        endpoints in virtual time)."""
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": ts_s * 1e6,
                "dur": max(dur_s, 0.0) * 1e6,
                "args": args or {},
            },
            pid,
            tid,
        )

    def begin(self, name, cat="", pid="scheduler", tid="main", args=None):
        if not self.enabled:
            return
        self._emit(
            {"name": name, "cat": cat, "ph": "B", "args": args or {}},
            pid, tid, stamp_now=True,
        )

    def end(self, name, cat="", pid="scheduler", tid="main", args=None):
        if not self.enabled:
            return
        self._emit(
            {"name": name, "cat": cat, "ph": "E", "args": args or {}},
            pid, tid, stamp_now=True,
        )

    def instant(
        self,
        name: str,
        cat: str = "",
        pid: str = "scheduler",
        tid: str = "main",
        args: Optional[dict] = None,
        ts_s: Optional[float] = None,
    ) -> None:
        if not self.enabled:
            return
        event = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "args": args or {},
        }
        if ts_s is not None:
            event["ts"] = ts_s * 1e6
        self._emit(event, pid, tid, stamp_now=ts_s is None)

    # -- export ---------------------------------------------------------
    def export_dict(self) -> dict:
        with self._lock:
            events = list(self._events)
            other = {"producer": "shockwave_tpu_torch.obs"}
            other["clock"] = {"wall_at_zero_s": self._epoch_wall}
            for key, value in self._meta.items():
                if isinstance(value, dict) and isinstance(
                    other.get(key), dict
                ):
                    other[key] = {**other[key], **value}
                else:
                    other[key] = value
        # Stable sort per track: X spans from concurrent threads (whose
        # ts is their enter time but whose append happens at exit) can
        # land out of order; sorting restores the per-tid monotonic-ts
        # property the schema validator asserts. M (naming) events carry
        # no ts and stay ahead of their track's first timed event.
        events.sort(
            key=lambda e: (
                e.get("pid", 0),
                e.get("tid", 0),
                "ts" in e,
                e.get("ts", 0.0),
            )
        )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def export(self, path: str) -> None:
        from shockwave_tpu_torch.utils.fileio import atomic_write_text

        atomic_write_text(path, json.dumps(self.export_dict()))

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._pids.clear()
            self._tids.clear()
            self._meta.clear()
            self._epoch = time.perf_counter()
            self._epoch_wall = time.time()
