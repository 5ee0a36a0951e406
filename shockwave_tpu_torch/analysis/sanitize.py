"""Runtime lock sanitizer: the port's copy of the lock half of the JAX
package's ``shockwave_tpu/analysis/sanitize.py`` (:98-645).

``SHOCKWAVE_SANITIZE=locks`` (comma-separated kinds) makes every lock the
telemetry planes create through :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition` an instrumented wrapper that records the
per-thread acquisition order into a process-global lockdep-style graph
and RAISES on:

- an **order inversion**: a thread acquires B while holding A after any
  thread acquired A while holding B;
- a **self-deadlock**: a blocking re-acquisition of a non-reentrant lock
  the same thread already holds (raised instead of hanging);
- a **hold-time ceiling** breach: a critical section held longer than
  ``SHOCKWAVE_SANITIZE_HOLD_S`` seconds (default 10).

``threads`` adds per-field write tracking on classes patched with
:func:`instrument_class` (Eraser-style lock sets; a write pair from two
threads with disjoint lock sets raises) and instruments the lock
factories too. The static half that picks those classes for the JAX
package (``instrument_for_threads``) and the JAX entry-point guards
(``watch_jit``, ``jax_entry``, ``check_recompiles``) are not in the
port (ROADMAP.md, queue 1 item 12).

Disabled (the default), every factory returns the raw ``threading``
primitive: zero overhead, the same behaviour. Violations raise
immediately and are recorded; :func:`report` returns a JSON-ready
summary.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "SanitizerError",
    "LockOrderViolation",
    "LockHoldViolation",
    "ThreadRaceViolation",
    "configure",
    "enabled",
    "make_lock",
    "make_rlock",
    "make_condition",
    "instrument_class",
    "report",
    "reset",
    "violations",
]

# Violation sites are reported relative to the checkout holding the port.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SanitizerError(RuntimeError):
    """Base class for sanitizer-detected violations."""


class LockOrderViolation(SanitizerError):
    pass


class LockHoldViolation(SanitizerError):
    pass


class ThreadRaceViolation(SanitizerError):
    pass


# -- configuration ------------------------------------------------------

_DEFAULT_HOLD_S = 10.0

# Explicit override (tests / drivers); None means "read the env".
_configured: Optional[frozenset] = None


def configure(kinds=None) -> None:
    """Explicitly enable sanitizer kinds (an iterable of ``"locks"`` /
    ``"threads"``), overriding ``SHOCKWAVE_SANITIZE``; ``configure(None)``
    returns control to the environment variable."""
    global _configured
    _configured = None if kinds is None else frozenset(kinds)


def active_kinds() -> frozenset:
    if _configured is not None:
        return _configured
    raw = os.environ.get("SHOCKWAVE_SANITIZE", "")
    return frozenset(k.strip() for k in raw.split(",") if k.strip())


def enabled(kind: str) -> bool:
    return kind in active_kinds()


def hold_ceiling_s() -> float:
    try:
        return float(os.environ.get("SHOCKWAVE_SANITIZE_HOLD_S", ""))
    except ValueError:
        return _DEFAULT_HOLD_S


# -- shared violation ledger -------------------------------------------

_state_lock = threading.Lock()
_violations: List[dict] = []


def _caller_site() -> Tuple[str, int, str]:
    """(relpath, line, source text) of the first stack frame outside
    this module — the production line that committed the violation."""
    import linecache
    import sys

    frame = sys._getframe(1)
    here = os.path.abspath(__file__)

    def _internal(f) -> bool:
        filename = f.f_code.co_filename
        # Condition routes acquisitions through threading.py
        # (__enter__/wait/_acquire_restore); the witness the operator
        # needs is the production `with self._cv:` line, not stdlib.
        return filename == here or filename.endswith(
            os.sep + "threading.py"
        )

    while frame is not None and _internal(frame):
        frame = frame.f_back
    if frame is None:  # pragma: no cover - defensive
        return "<unknown>", 0, ""
    filename = frame.f_code.co_filename
    line = frame.f_lineno
    text = linecache.getline(filename, line).strip()
    root = _REPO_ROOT
    try:
        rel = os.path.relpath(filename, root)
    except ValueError:  # pragma: no cover - different drive (windows)
        rel = filename
    if rel.startswith(".."):
        rel = filename
    return rel.replace(os.sep, "/"), line, text


def _record_violation(kind: str, rule: str, message: str) -> dict:
    path, line, text = _caller_site()
    entry = {
        "kind": kind,
        "rule": rule,
        "path": path,
        "line": line,
        "line_text": text,
        "message": message,
        "thread": threading.current_thread().name,
    }
    with _state_lock:
        _violations.append(entry)
    return entry


def violations() -> List[dict]:
    with _state_lock:
        return list(_violations)


# -- lock sanitizer -----------------------------------------------------

# (held_name, acquired_name) -> first witness {thread, site}
_lock_edges: Dict[Tuple[str, str], dict] = {}
_tls = threading.local()


def _held_stack() -> List["_Held"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = []
        _tls.held = stack
    return stack


class _Held:
    __slots__ = ("lock", "t_acquired", "count")

    def __init__(self, lock):
        self.lock = lock
        self.t_acquired = time.monotonic()
        self.count = 1


class SanitizedLock:
    """Instrumented wrapper around ``threading.Lock``/``RLock`` that
    maintains the per-thread held stack and the global acquisition-order
    graph. Exposes the ``Condition`` integration surface
    (``_release_save``/``_acquire_restore``/``_is_owned``) so
    ``threading.Condition(sanitized_lock)`` works unchanged — a
    ``wait()`` correctly pops the lock from the held stack for its
    duration."""

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    # -- core protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        stack = _held_stack()
        mine = next((h for h in stack if h.lock is self), None)
        if mine is not None and not self._reentrant and blocking:
            entry = _record_violation(
                "locks",
                "sanitize-self-deadlock",
                f"blocking re-acquisition of non-reentrant lock "
                f"{self.name} already held by this thread — this would "
                "deadlock; raised instead",
            )
            raise LockOrderViolation(entry["message"])
        if blocking and mine is None:
            # Inversion check BEFORE the blocking acquire: when the
            # other side of an AB/BA pair is live (the other thread
            # holds what we want and wants what we hold), checking
            # after acquire() returns would never run — the deadlock
            # the sanitizer exists to catch would hang undiagnosed.
            self._precheck_inversion(stack)
        ok = (
            self._inner.acquire(blocking, timeout)
            if timeout != -1 or not blocking
            else self._inner.acquire()
        )
        if not ok:
            return ok
        if mine is not None and self._reentrant:
            mine.count += 1
            return ok
        self._note_acquired(stack)
        stack.append(_Held(self))
        return ok

    def _precheck_inversion(self, stack: List[_Held]) -> None:
        held_names = {h.lock.name for h in stack if h.lock is not self}
        if not held_names:
            return
        with _state_lock:
            inverted = sorted(
                held
                for held in held_names
                if (self.name, held) in _lock_edges
            )
        if inverted:
            witness = _lock_edges[(self.name, inverted[0])]
            entry = _record_violation(
                "locks",
                "sanitize-lock-order",
                f"lock-order inversion: acquiring {self.name} while "
                f"holding {inverted[0]}, but {witness['thread']} "
                f"previously acquired {inverted[0]} while holding "
                f"{self.name} (at {witness['site']}) — AB/BA deadlock "
                "hazard; raised before blocking",
            )
            raise LockOrderViolation(entry["message"])

    def _note_acquired(self, stack: List[_Held]) -> None:
        held_names = {h.lock.name for h in stack if h.lock is not self}
        if not held_names:
            return
        path, line, _ = _caller_site()
        site = f"{path}:{line}"
        with _state_lock:
            for held in held_names:
                _lock_edges.setdefault(
                    (held, self.name),
                    {
                        "thread": threading.current_thread().name,
                        "site": site,
                    },
                )
            inverted = sorted(
                held
                for held in held_names
                if (self.name, held) in _lock_edges
            )
        if inverted:
            witness = _lock_edges[(self.name, inverted[0])]
            entry = _record_violation(
                "locks",
                "sanitize-lock-order",
                f"lock-order inversion: acquiring {self.name} while "
                f"holding {inverted[0]}, but {witness['thread']} "
                f"previously acquired {inverted[0]} while holding "
                f"{self.name} (at {witness['site']}) — AB/BA deadlock "
                "hazard",
            )
            self._inner.release()
            raise LockOrderViolation(entry["message"])

    def release(self):
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self:
                held = stack[i]
                if self._reentrant and held.count > 1:
                    held.count -= 1
                    self._inner.release()
                    return
                del stack[i]
                self._inner.release()
                dt = time.monotonic() - held.t_acquired
                ceiling = hold_ceiling_s()
                if dt > ceiling:
                    import sys

                    entry = _record_violation(
                        "locks",
                        "sanitize-lock-hold",
                        f"lock {self.name} held for {dt:.3f}s, over the "
                        f"{ceiling:.3f}s ceiling — long critical "
                        "sections stall every contending thread",
                    )
                    # If the with-body is already unwinding a real
                    # error, record only: replacing it with the hold
                    # violation would misattribute the run's failure
                    # to a slow critical section.
                    if sys.exc_info()[0] is None:
                        raise LockHoldViolation(entry["message"])
                return
        # Not held by this thread (foreign release) — delegate and let
        # threading raise its own error.
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- Condition integration ------------------------------------------
    def _release_save(self):
        stack = _held_stack()
        saved_entry = None
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self:
                saved_entry = stack.pop(i)
                break
        if hasattr(self._inner, "_release_save"):
            inner_state = self._inner._release_save()
        else:
            self._inner.release()
            inner_state = None
        return (inner_state, saved_entry)

    def _acquire_restore(self, state):
        inner_state, saved_entry = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        stack = _held_stack()
        if saved_entry is not None:
            saved_entry.t_acquired = time.monotonic()
            stack.append(saved_entry)
        else:  # pragma: no cover - defensive
            stack.append(_Held(self))

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return any(h.lock is self for h in _held_stack())

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<SanitizedLock {self.name} {self._inner!r}>"


def _locks_instrumented() -> bool:
    """The thread sanitizer reads the held-lock stack, so enabling
    ``threads`` instruments the lock factories too."""
    return enabled("locks") or enabled("threads")


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented when the lock (or thread)
    sanitizer is active. ``name`` is the project-wide lock identity,
    conventionally matching the static analyzer's node names
    (``"obs.metrics.MetricsRegistry._lock"``)."""
    if _locks_instrumented():
        return SanitizedLock(name, threading.Lock(), reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    if _locks_instrumented():
        return SanitizedLock(name, threading.RLock(), reentrant=True)
    return threading.RLock()


def make_condition(lock=None, name: str = "condition"):
    """``threading.Condition`` over ``lock`` (itself typically from
    :func:`make_lock`/:func:`make_rlock`); creates a sanitized RLock
    when none is given."""
    return threading.Condition(lock if lock is not None else make_rlock(name))


def observed_lock_graph() -> dict:
    """The dynamically observed acquisition-order edges."""
    with _state_lock:
        return {
            "edges": [
                {"held": a, "acquired": b, **w}
                for (a, b), w in sorted(_lock_edges.items())
            ]
        }


# -- thread-race sanitizer ----------------------------------------------

# Classes patched by instrument_class (qname -> class), for report()
# and idempotency across repeated instrument_for_threads() calls.
_instrumented: Dict[str, type] = {}
_tracked_write_count = 0

# Attribute names never tracked: the sanitizer's own bookkeeping slot
# plus lock objects (their wrappers maintain the held stack already).
_TRACK_SKIP_PREFIX = "_san_"


def _held_lock_names() -> frozenset:
    return frozenset(h.lock.name for h in _held_stack())


_OWNER_KEY = "\x00owner"


def _note_field_write(owner: str, obj, attr: str) -> None:
    """Record one field write on an instrumented instance and raise on
    an observed unsynchronized cross-thread write pair.

    Eraser-style lockset states per (instance, field): writes stay in
    an EXCLUSIVE phase while a single thread owns the field
    (construction and pre-publication setup — a driver configuring the
    scheduler before starting its round-loop thread — are lock-free by
    design and never pair). The first write from a SECOND thread moves
    the field to the shared phase: from then on each writer thread's
    entry is the INTERSECTION of the sanitized locks it held across
    its writes, and two threads whose entries are disjoint raced."""
    global _tracked_write_count
    inst = getattr(obj, "__dict__", None)
    if inst is None:  # __slots__ instance: nowhere to hang the table
        return
    thread = threading.current_thread().name
    held = _held_lock_names()
    track = inst.setdefault("_san_writes", {})
    with _state_lock:
        _tracked_write_count += 1
        seen = track.get(attr)
        if seen is None:
            track[attr] = {_OWNER_KEY: thread}  # exclusive phase
            return
        if _OWNER_KEY in seen:
            if seen[_OWNER_KEY] == thread:
                return  # still exclusive: setup writes are free
            # Second thread arrived: the field is shared from HERE.
            # The exclusive owner's setup history is forgiven (it
            # happened-before this thread could exist).
            del seen[_OWNER_KEY]
        prev = seen.get(thread)
        seen[thread] = held if prev is None else (prev & held)
        mine = seen[thread]
        conflict = next(
            (
                (other, locks)
                for other, locks in seen.items()
                if other != thread and not (locks & mine)
            ),
            None,
        )
    if conflict is not None:
        other, locks = conflict
        entry = _record_violation(
            "threads",
            "sanitize-thread-race",
            f"unsynchronized cross-thread write to {owner}.{attr}: "
            f"{thread} wrote holding "
            f"{{{', '.join(sorted(mine)) or 'no locks'}}} but {other} "
            f"wrote holding "
            f"{{{', '.join(sorted(locks)) or 'no locks'}}} — the "
            "guaranteed lock sets are disjoint, so these writes "
            "interleave",
        )
        raise ThreadRaceViolation(entry["message"])


def instrument_class(cls: type, owner: Optional[str] = None) -> type:
    """Patch ``cls.__setattr__`` to track per-(instance, field) writes
    while the thread sanitizer is active. Idempotent per CLASS (the
    marker lives in ``cls.__dict__``, not inherited, so a subclass can
    still be instrumented independently while the same class is never
    double-wrapped under two owner labels); returns ``cls``. The
    underlying write always happens BEFORE the race check raises, so
    state is not corrupted by the diagnostic."""
    owner = owner or f"{cls.__module__}.{cls.__qualname__}"
    if cls.__dict__.get("_san_instrumented"):
        return cls
    orig = cls.__setattr__

    def __setattr__(self, name, value, _orig=orig, _owner=owner):
        _orig(self, name, value)
        # Gate per write, not just at patch time: the patch is
        # irreversible, so a process that instrumented under
        # ``threads`` and later turned it off (test suites) must stop
        # tracking — locks made AFTER the switch-off are raw and
        # invisible to the held stack, and pairing their correctly
        # guarded writes as "lock-free" would raise spuriously.
        if not name.startswith(_TRACK_SKIP_PREFIX) and enabled(
            "threads"
        ):
            _note_field_write(_owner, self, name)

    cls.__setattr__ = __setattr__
    cls._san_instrumented = True
    _instrumented[owner] = cls
    return cls


# -- reporting ----------------------------------------------------------

def report() -> dict:
    """JSON-ready summary of everything the active sanitizers saw."""
    with _state_lock:
        return {
            "active": sorted(active_kinds()),
            "violations": list(_violations),
            "locks": {
                "edges": [
                    {"held": a, "acquired": b, **w}
                    for (a, b), w in sorted(_lock_edges.items())
                ],
            },
            "threads": {
                "instrumented": sorted(_instrumented),
                "tracked_writes": _tracked_write_count,
            },
        }


def reset() -> None:
    """Tests only: drop all recorded sanitizer state. Instrumented
    classes stay patched (their tracking is per-instance)."""
    global _violations, _tracked_write_count
    with _state_lock:
        _violations = []
        _lock_edges.clear()
        _tracked_write_count = 0
    _tls.held = []
