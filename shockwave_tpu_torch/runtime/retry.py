"""Jittered exponential retry/backoff for the runtime's RPC client paths.

Every scheduler<->worker RPC used to be one-shot: a single dropped
packet lost a Done report (and with it a round of training progress)
or left a kill request unsent. This helper gives every client call the
same disciplined shape:

  * up to ``attempts`` tries, exponential backoff with full jitter
    (0.5x-1x of the nominal delay, capped at ``max_delay_s``);
  * a per-attempt RPC deadline (``call_timeout_s``) so a black-holed
    TCP connection cannot hang a dispatcher thread;
  * an overall per-call deadline (``deadline_s``) across all attempts,
    after which the last error is re-raised to the caller — callers
    decide whether a final failure is fatal (registration) or
    absorbable (a Done report the straggler-kill path will reconcile).

Retries and final give-ups are visible as
``rpc_client_retries_total{method}`` / ``rpc_client_giveups_total{method}``
so a flaky network is observable before it becomes a lost-work incident.

Defaults are env-tunable (``SHOCKWAVE_RPC_*``) so tests and chaos runs
can tighten them without threading knobs through every constructor.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple, Type

from shockwave_tpu_torch import obs

_ENV_DEFAULTS = {
    "attempts": ("SHOCKWAVE_RPC_ATTEMPTS", 4),
    "base_delay_s": ("SHOCKWAVE_RPC_BASE_DELAY_S", 0.1),
    "max_delay_s": ("SHOCKWAVE_RPC_MAX_DELAY_S", 2.0),
    "deadline_s": ("SHOCKWAVE_RPC_DEADLINE_S", 20.0),
    "call_timeout_s": ("SHOCKWAVE_RPC_TIMEOUT_S", 10.0),
}

# Module RNG for backoff jitter only — never part of replayable state.
_JITTER_RNG = random.Random()


class PermanentRpcError(RuntimeError):
    """A definitive rejection retrying can never fix — the fenced-epoch
    refusal (this sender's epoch is superseded; every future attempt is
    rejected identically) being the canonical case. call_with_retry
    re-raises it immediately without consuming the retry budget."""


class SchedulerOutage:
    """Worker-side scheduler-unreachability tracker.

    The per-call retry budget answers "did THIS call fail"; this class
    answers the different question "is the SCHEDULER gone" — consecutive
    heartbeat-ack failures past a threshold flip the worker into outage
    mode, in which the dispatcher buffers Done notifications instead of
    burning each report's full retry/backoff budget against a dead
    address, and the agent starts hunting the front-door map for a
    successor. Outage wall time is loud:
    ``worker_scheduler_outage_seconds`` is the counter an operator's
    dashboard alarms on.
    """

    def __init__(self, threshold: Optional[int] = None):
        if threshold is None:
            threshold = int(os.environ.get("SHOCKWAVE_OUTAGE_BEATS", "3"))
        self.threshold = max(1, int(threshold))
        # One leaf lock; nothing is called while held except the obs
        # registry (an established leaf).
        from shockwave_tpu_torch.analysis import sanitize

        self._lock = sanitize.make_lock(
            "runtime.retry.SchedulerOutage._lock"
        )
        self._consecutive_failures = 0
        self._outage_started_monotonic: Optional[float] = None
        self._accounted_s = 0.0

    def record_failure(self) -> bool:
        """One failed heartbeat/ack exchange; returns True when this
        crossed (or is past) the outage threshold."""
        with self._lock:
            self._consecutive_failures += 1
            if (
                self._consecutive_failures >= self.threshold
                and self._outage_started_monotonic is None
            ):
                self._outage_started_monotonic = time.monotonic()
                obs.counter(
                    "worker_scheduler_outages_total",
                    "times the scheduler was declared unreachable "
                    "(consecutive heartbeat failures past threshold)",
                ).inc()
            self._account_locked()
            return self._outage_started_monotonic is not None

    def record_success(self) -> None:
        """Contact restored (a heartbeat ack or a successful
        re-register): close the outage window."""
        with self._lock:
            self._account_locked()
            self._consecutive_failures = 0
            self._outage_started_monotonic = None

    def in_outage(self) -> bool:
        with self._lock:
            self._account_locked()
            return self._outage_started_monotonic is not None

    def outage_seconds(self) -> float:
        """Total wall seconds spent in outage so far (accounted
        incrementally into ``worker_scheduler_outage_seconds``)."""
        with self._lock:
            self._account_locked()
            return self._accounted_s

    def _account_locked(self) -> None:
        """Caller holds the lock. Fold elapsed outage time into the
        loud counter exactly once per elapsed second."""
        if self._outage_started_monotonic is None:
            return
        now = time.monotonic()
        elapsed = now - self._outage_started_monotonic
        if elapsed > 0:
            obs.counter(
                "worker_scheduler_outage_seconds",
                "wall seconds this worker spent with the scheduler "
                "unreachable (Done reports buffered, not retried)",
            ).inc(elapsed)
            self._accounted_s += elapsed
            self._outage_started_monotonic = now


@dataclass(frozen=True)
class RetryPolicy:
    attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 2.0
    # Total budget across attempts (sleeps included); None = unbounded.
    deadline_s: Optional[float] = 20.0
    # Per-attempt RPC deadline handed to the stub call.
    call_timeout_s: float = 10.0
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)

    @classmethod
    def from_env(cls, env=None) -> "RetryPolicy":
        env = os.environ if env is None else env
        kwargs = {}
        for field, (var, default) in _ENV_DEFAULTS.items():
            raw = env.get(var)
            if raw is None:
                kwargs[field] = default
            else:
                kwargs[field] = (
                    int(raw) if field == "attempts" else float(raw)
                )
        return cls(**kwargs)

    def single_shot(self) -> "RetryPolicy":
        """One attempt, same deadlines — for best-effort periodic calls
        (heartbeats) where the next tick IS the retry."""
        return replace(self, attempts=1)


def call_with_retry(
    attempt: Callable[[Optional[float]], object],
    policy: RetryPolicy,
    method: str = "",
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
):
    """Run ``attempt(per_attempt_timeout_s)`` under ``policy``.

    ``attempt`` receives the RPC deadline to pass to the stub (clipped
    to whatever remains of the overall deadline) and must raise on
    failure. The last error is re-raised once attempts or the deadline
    are exhausted.
    """
    rng = rng or _JITTER_RNG
    deadline = (
        time.monotonic() + policy.deadline_s
        if policy.deadline_s is not None
        else None
    )
    last_error: Optional[BaseException] = None
    for i in range(max(policy.attempts, 1)):
        timeout = policy.call_timeout_s
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            timeout = min(timeout, max(remaining, 1e-3))
        try:
            return attempt(timeout)
        except PermanentRpcError:
            # A fenced/definitive rejection: retrying re-asks a question
            # whose answer cannot change. No giveup counter either —
            # this is a verdict, not an exhausted budget.
            raise
        except policy.retry_on as e:  # noqa: BLE001 - policy-defined
            last_error = e
            if i >= policy.attempts - 1:
                break
            delay = min(
                policy.max_delay_s, policy.base_delay_s * (2.0 ** i)
            )
            delay *= 0.5 + rng.random() * 0.5  # full jitter, never 0
            if deadline is not None:
                delay = min(delay, max(deadline - time.monotonic(), 0.0))
            obs.counter(
                "rpc_client_retries_total",
                "RPC attempts that failed and were retried",
            ).inc(method=method)
            if delay > 0:
                sleep(delay)
    obs.counter(
        "rpc_client_giveups_total",
        "RPC calls that exhausted every retry attempt",
    ).inc(method=method)
    if last_error is None:
        raise TimeoutError(
            f"RPC {method or '<call>'}: deadline of {policy.deadline_s}s "
            "exhausted before the first attempt"
        )
    raise last_error
