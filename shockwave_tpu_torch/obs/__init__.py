"""Telemetry calls of the simulation path, with telemetry off.

The JAX package's ``shockwave_tpu/obs`` (metrics registry, event tracer,
flight recorder, calibration tracker, watchdog) is disabled by default,
and then every call hands out a shared null instrument after one flag
check. The port keeps exactly that default: the calls its scheduler,
planner, its degradation ladder, the cells market and the solves make
(``counter``, ``gauge``, ``histogram``, ``instant``, ``span``,
``backend_phases``) are here and do nothing, and ``get_recorder`` hands
out a disabled flight recorder. The reference's other
calls on this path sit in blocks that run only with a plane on, which
the port does not carry. Turning any plane on is not ported yet and
raises ``NotImplementedError`` naming ``ROADMAP.md``.
"""

from __future__ import annotations

_NOT_PORTED = (
    "{} is not ported to shockwave_tpu_torch yet (telemetry, flight "
    "recorder and watchdog: ROADMAP.md, queue 1)"
)


class _Null:
    """No-op counter, gauge, histogram, span and backend-phase timer."""

    __slots__ = ()

    def inc(self, amount=1.0, **labels):
        pass

    def set(self, value, **labels):
        pass

    def observe(self, value, **labels):
        pass

    def phase(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def configure(metrics=None, trace=None) -> None:
    if metrics or trace:
        raise NotImplementedError(_NOT_PORTED.format("telemetry"))


def configure_recorder(path: str) -> None:
    raise NotImplementedError(_NOT_PORTED.format("the flight recorder"))


def configure_watchdog(rules=None) -> None:
    raise NotImplementedError(_NOT_PORTED.format("the health watchdog"))


def counter(name: str, help: str = "") -> _Null:
    return _NULL


def gauge(name: str, help: str = "") -> _Null:
    return _NULL


def histogram(name: str, help: str = "") -> _Null:
    return _NULL


def span(name: str, **kwargs) -> _Null:
    return _NULL


def backend_phases(backend: str, num_jobs: int, total: bool = True) -> _Null:
    return _NULL


def instant(name: str, **kwargs) -> None:
    pass


class _DisabledRecorder:
    """The flight recorder with no log configured: ``enabled`` is False,
    so the callers' fault and recovery records are skipped."""

    enabled = False


_RECORDER = _DisabledRecorder()


def get_recorder() -> _DisabledRecorder:
    return _RECORDER
