"""Streaming admission front door: bounded queue, idempotent tokens,
backpressure, and the end-of-stream close signal.

The scheduler used to assume the whole job trace was known up front
(``expect_jobs(count)`` + an in-process submit thread). This module is
the serving-system replacement: submitters push batches through the
``SubmitJobs`` RPC (or, in simulation, a :class:`StreamingSubmitter`
in virtual time) into one :class:`AdmissionQueue` per scheduler, and
the round loop drains it at round boundaries — batched admission, so a
burst of arrivals costs one replan, not one per job.

Contract:

  * **Idempotent tokens.** Every batch carries a client-supplied token.
    The queue keeps a token ledger; a retried submit (lost response,
    injected ``rpc_drop``) re-offers the same token and is acknowledged
    without re-admitting — a token resolves to admission exactly once.
  * **Backpressure.** The queue is bounded. A batch that would overflow
    it is rejected with ``RETRY_AFTER`` and a queue-depth-derived delay;
    the submitter resubmits the SAME token after the delay. Nothing is
    silently dropped — rejection is explicit and observable
    (``admission_rejected_total``).
  * **End of stream.** ``close()`` replaces the static expected-job
    count: the scheduler idles through arrival gaps while the stream is
    open and exits once it is closed, the queue is drained, and every
    admitted job completed.

Admission, rejection, dedup, and close events are stamped into the
flight recorder (when enabled) so a streaming run's timeline is
replayable forensic data, and surfaced as metrics for the
``admission_backlog`` watchdog rule.
"""

from __future__ import annotations

import bisect
import itertools
import os
import re
import threading
import time
from collections import Counter, OrderedDict, deque
from operator import attrgetter, itemgetter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.core.job import Job

STATUS_ACCEPTED = "ACCEPTED"
STATUS_RETRY_AFTER = "RETRY_AFTER"
STATUS_CLOSED = "CLOSED"
# Hard (non-retryable-as-is) rejection: the batch would push its
# tenant past its admission quota. Deciding WHO gets queued when the
# cluster is full is policy, not backpressure — the submitter must
# shed or wait for its tenant's backlog to drain, not hammer retries.
# Rejection is batch-granular (the token ledger is), so submitters
# keep batches single-tenant — both in-repo submitters do — and one
# tenant's quota never sheds another tenant's jobs.
STATUS_QUOTA = "QUOTA"
# Hard rejection by the marginal-price admission pricer (whatif
# 2-scenario solve): admitting the batch would cost the incumbents
# more Nash welfare than the configured threshold. Same retry
# semantics as QUOTA — resubmitting the identical batch re-prices the
# identical externality, so submitters shed instead of retrying.
STATUS_PRICED = "PRICED"

# A job's tenant and a queue entry's enqueue time, for the C-level
# tallies of the line-rate paths.
_TENANT_OF = attrgetter("tenant")
_ENQUEUED_OF = itemgetter(2)

# Default bound on pending (accepted-but-not-admitted) jobs; the env
# knob SHOCKWAVE_ADMISSION_QUEUE_CAP overrides it in physical mode.
DEFAULT_CAPACITY = 1024

# Default recent-window size of the bounded token ledger
# (SHOCKWAVE_LEDGER_WINDOW overrides): tokens past the window compact
# into per-prefix resolved ranges — lossless dedup for the
# ``prefix-NNNNNN`` shape both in-repo token mints use.
DEFAULT_LEDGER_WINDOW = 4096

# The compactable token shape: any prefix, a trailing dash-delimited
# decimal sequence number (SubmitterClient and StreamingSubmitter both
# mint ``f"{id}-{seq:06d}"``).
_TOKEN_RANGE_RE = re.compile(r"^(.*)-(\d{1,18})$")


def job_to_spec_dict(job: Job) -> dict:
    """Wire-facing dict for one job (the SubmitterClient turns these
    into admission_pb2.JobSpec messages)."""
    # Optional string fields ride proto3 string slots, which reject
    # None: a trace job with no working directory must submit as ""
    # (job_from_spec_dict already normalizes "" back to a falsy value
    # on the receiving side).
    return {
        "job_type": job.job_type,
        "command": job.command or "",
        "working_directory": job.working_directory or "",
        "num_steps_arg": job.num_steps_arg or "-n",
        "total_steps": int(job.total_steps),
        "scale_factor": int(job.scale_factor),
        "mode": job.mode,
        "priority_weight": float(job.priority_weight),
        "slo": float(job.SLO) if job.SLO is not None else 0.0,
        "duration": float(job.duration) if job.duration else 0.0,
        "needs_data_dir": bool(job.needs_data_dir),
        "tenant": str(getattr(job, "tenant", "") or ""),
        "trace_context": str(getattr(job, "trace_context", "") or ""),
    }


def job_from_spec_dict(spec: dict) -> Job:
    """Validated Job from a wire-facing spec dict; raises ValueError on
    specs the scheduler could not run (the RPC handler reports these
    back to the submitter instead of poisoning the queue)."""
    from shockwave_tpu_torch.data.workload_info import parse_job_type

    job_type = str(spec.get("job_type", ""))
    try:
        model, batch_size = parse_job_type(job_type)
        if not model or batch_size <= 0:
            raise ValueError(job_type)
    except ValueError:
        raise ValueError(
            f"job_type {job_type!r} is not of the form "
            "'Model (batch size N)'"
        ) from None
    total_steps = int(spec.get("total_steps", 0))
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    scale_factor = int(spec.get("scale_factor", 1)) or 1
    if scale_factor < 1:
        raise ValueError(f"scale_factor must be >= 1, got {scale_factor}")
    slo = float(spec.get("slo", 0.0))
    duration = float(spec.get("duration", 0.0))
    return Job(
        job_type=job_type,
        command=str(spec.get("command", "")),
        working_directory=str(spec.get("working_directory", "")),
        num_steps_arg=str(spec.get("num_steps_arg", "-n")) or "-n",
        total_steps=total_steps,
        scale_factor=scale_factor,
        mode=str(spec.get("mode", "static")) or "static",
        priority_weight=float(spec.get("priority_weight", 1.0)) or 1.0,
        SLO=slo if slo > 0 else None,
        duration=duration if duration > 0 else None,
        needs_data_dir=bool(spec.get("needs_data_dir", False)),
        tenant=str(spec.get("tenant", "") or ""),
        trace_context=str(spec.get("trace_context", "") or ""),
    )


def jobs_from_columns(cols) -> List[Job]:
    """Vectorized :func:`job_from_spec_dict` over one
    :class:`~shockwave_tpu_torch.runtime.protobuf.fastwire.JobColumns` block:
    validation is per-UNIQUE job_type plus three array comparisons, and
    no per-job spec dict ever exists. Decision-identical to mapping
    ``job_from_spec_dict`` over the batch in order — the same Jobs on
    success, and on failure the same ValueError (same message) for the
    FIRST offending job, checked in the same per-job order (job_type,
    then total_steps, then scale_factor) — pinned by
    tests/test_admission.py and the ingest smoke parity gate."""
    import numpy as np

    from shockwave_tpu_torch.data.workload_info import parse_job_type

    n = cols.n
    if n == 0:
        return []
    job_types = cols.strs(0)
    # Batches are homogeneous in practice: validate each DISTINCT
    # job_type once instead of regex-free parsing n strings.
    type_ok = {}
    for jt in set(job_types):
        try:
            model, batch_size = parse_job_type(jt)
            type_ok[jt] = bool(model) and batch_size > 0
        except ValueError:
            type_ok[jt] = False
    total_steps = cols.total_steps
    # Scalar contract: int(spec.get("scale_factor", 1)) or 1 -> an
    # absent/zero scale is 1, and only then is < 1 an error.
    scale = np.where(cols.scale_factor == 0, 1, cols.scale_factor)
    bad_steps = total_steps <= 0
    bad_scale = scale < 1
    if all(type_ok.values()):
        bad_type = np.zeros(n, dtype=bool)
    else:
        bad_type = np.fromiter(
            (not type_ok[jt] for jt in job_types), dtype=bool, count=n
        )
    bad = bad_type | bad_steps | bad_scale
    if bad.any():
        i = int(np.argmax(bad))
        if bad_type[i]:
            raise ValueError(
                f"job_type {job_types[i]!r} is not of the form "
                "'Model (batch size N)'"
            )
        if bad_steps[i]:
            raise ValueError(
                f"total_steps must be positive, got {int(total_steps[i])}"
            )
        raise ValueError(
            f"scale_factor must be >= 1, got {int(scale[i])}"
        )

    def column(values, fix):
        """``fix`` of each value, applied once per distinct value."""
        fixed = {v: fix(v) for v in set(values)}
        return list(map(fixed.__getitem__, values))

    num_steps_args = column(cols.strs(3), lambda v: v or "-n")
    modes = column(cols.strs(4), lambda v: v or "static")
    priority_weights = column(cols.priority_weight.tolist(),
                              lambda v: v or 1.0)
    slos = column(cols.slo.tolist(), lambda v: v if v > 0 else None)
    durations = column(cols.duration.tolist(),
                       lambda v: v if v > 0 else None)
    needs_data_dir = column(cols.needs_data_dir.tolist(), bool)
    # Positional, in Job's field order (job_type, command,
    # working_directory, num_steps_arg, total_steps, duration, mode,
    # scale_factor, priority_weight, SLO, needs_data_dir, job_id, tenant,
    # trace_context), and one ``map`` over the columns: keywords or a
    # per-job comprehension cost the line-rate path a third or more of
    # its construction time.
    return list(map(
        Job, job_types, cols.strs(1), cols.strs(2), num_steps_args,
        total_steps.tolist(), durations, modes, scale.tolist(),
        priority_weights, slos, needs_data_dir, itertools.repeat(None, n),
        cols.strs(5), cols.strs(6),
    ))


class _TenantLedger:
    """Pending-job counts per tenant. One private instance per plain
    queue; ONE SHARED instance across every shard of a sharded front
    door, so a tenant's quota bounds the FLEET's pending backlog — not
    per-shard backlog (which would multiply the quota by the shard
    count) — and rebalancing moves between shards net to zero.
    ``reserve`` is check-and-increment in a single critical section, so
    two handler threads racing a tenant's last quota slot cannot both
    win. Always acquired under a shard's queue lock (queue -> ledger,
    never the reverse)."""

    def __init__(self):
        self._lock = sanitize.make_lock(
            "runtime.admission._TenantLedger._lock"
        )
        self._pending: Dict[str, int] = {}

    @staticmethod
    def batch_counts(jobs: Sequence[Job]) -> Dict[str, int]:
        """Jobs per non-empty tenant, in the batch's order of first
        appearance: one C-level tally of the tenants, then a pass over
        the distinct ones."""
        try:
            tally = Counter(map(_TENANT_OF, jobs))
        except AttributeError:
            tally = Counter(getattr(job, "tenant", "") for job in jobs)
        counts: Dict[str, int] = {}
        for tenant, count in tally.items():
            tenant = str(tenant or "")
            if tenant:
                counts[tenant] = counts.get(tenant, 0) + count
        return counts

    def reserve(
        self, counts: Dict[str, int], quotas: Dict[str, int]
    ) -> Optional[str]:
        """Atomically add ``counts`` to the pending tallies; returns
        the first tenant the batch would push past ``quotas`` (and
        reserves nothing), else None."""
        with self._lock:
            for tenant, count in counts.items():
                if (
                    tenant in quotas
                    and self._pending.get(tenant, 0) + count
                    > quotas[tenant]
                ):
                    return tenant
            for tenant, count in counts.items():
                self._pending[tenant] = self._pending.get(tenant, 0) + count
            return None

    def release(self, counts: Dict[str, int]) -> None:
        """Undo a ``reserve`` whose batch was then rejected."""
        with self._lock:
            for tenant, count in counts.items():
                self._dec_locked(tenant, count)

    def dec(self, tenant: str, count: int = 1) -> None:
        with self._lock:
            self._dec_locked(tenant, count)

    def _dec_locked(self, tenant: str, count: int) -> None:
        if tenant in self._pending:
            self._pending[tenant] -= count
            if self._pending[tenant] <= 0:
                del self._pending[tenant]

    def force_add(self, counts: Dict[str, int]) -> None:
        """Re-apply pending tallies during an HA journal restore —
        quota checks don't re-run (the batch was already admitted by
        the previous leader; re-judging it could strand journaled
        jobs)."""
        with self._lock:
            for tenant, count in counts.items():
                self._pending[tenant] = self._pending.get(tenant, 0) + count

    def pending_of(self, tenants: Sequence[str]) -> List[int]:
        """Snapshot of the pending tallies for ``tenants`` (the
        vectorized quota pass reads these once, then commits its
        accepted total through one atomic :meth:`reserve`)."""
        with self._lock:
            return [self._pending.get(t, 0) for t in tenants]

    def state_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._pending)

    def restore_state(self, state: Dict[str, int]) -> None:
        with self._lock:
            self._pending = {
                str(t): int(c) for t, c in (state or {}).items()
            }


class _TokenLedger:
    """Bounded exactly-once token ledger.

    The original ledger (token -> admitted count, retained forever)
    is unbounded memory at line rate: 10k submits/s is ~1 GB of token
    strings a day. This structure keeps a RECENT window of tokens with
    their admitted counts (OrderedDict, FIFO-evicted past ``window``)
    and compacts each evicted token of the form ``prefix-NNNN…`` —
    the shape both in-repo token mints use — into per-prefix sorted
    disjoint integer ranges. Range compaction is LOSSLESS for
    membership (dedup holds arbitrarily long after eviction at
    O(prefixes + gaps) memory); only the admitted-count metadata is
    lost, so a range-hit dedup ack reports ``admitted=0`` (both
    in-repo submitters ignore the field on dedup — see USAGE.md).
    A token that does not parse is dropped outright on eviction —
    dedup coverage genuinely lost — and counted loudly
    (``admission_ledger_evictions_total{reason="dropped"}``).

    Not thread-safe: owned by one AdmissionQueue under its lock.
    """

    def __init__(self, window: int = DEFAULT_LEDGER_WINDOW):
        self.window = max(1, int(window))
        self._recent: "OrderedDict[str, int]" = OrderedDict()
        # prefix -> sorted disjoint [lo, hi] spans (inclusive).
        self._ranges: Dict[str, list] = {}
        # Lazily-rebuilt sorted int64 hashes of _recent's keys for the
        # vectorized membership probe; None = dirty. In-memory only
        # (str hashes are per-process), never serialized.
        self._hash_cache = None
        self.evictions = {"compacted": 0, "dropped": 0}

    def __contains__(self, token) -> bool:
        return self.get(token) is not None

    def get(self, token: str) -> Optional[int]:
        """Admitted count recorded under ``token``; 0 when the token
        resolved but its count was compacted away; None when absent."""
        count = self._recent.get(token)
        if count is not None:
            return count
        match = _TOKEN_RANGE_RE.match(token)
        if match and self._in_ranges(match.group(1), int(match.group(2))):
            return 0
        return None

    def _in_ranges(self, prefix: str, seq: int) -> bool:
        spans = self._ranges.get(prefix)
        if not spans:
            return False
        i = bisect.bisect_right(spans, [seq, float("inf")]) - 1
        return i >= 0 and spans[i][0] <= seq <= spans[i][1]

    def add(self, token: str, count: int) -> None:
        self._recent[token] = int(count)
        self._hash_cache = None
        while len(self._recent) > self.window:
            self._evict_oldest()

    def _evict_oldest(self) -> None:
        token, _count = self._recent.popitem(last=False)
        match = _TOKEN_RANGE_RE.match(token)
        if match:
            self._merge_range(match.group(1), int(match.group(2)))
            self.evictions["compacted"] += 1
            reason = "compacted"
        else:
            self.evictions["dropped"] += 1
            reason = "dropped"
        obs.counter(
            "admission_ledger_evictions_total",
            "tokens evicted from the bounded ledger's recent window "
            "(compacted = lossless range merge; dropped = unparseable "
            "token, dedup coverage LOST past the window)",
        ).inc(reason=reason)

    def _merge_range(self, prefix: str, seq: int) -> None:
        spans = self._ranges.setdefault(prefix, [])
        i = bisect.bisect_left(spans, [seq, seq])
        if i > 0 and spans[i - 1][1] >= seq - 1:
            i -= 1
            if seq <= spans[i][1]:
                return  # already covered
            spans[i][1] = seq
        else:
            spans.insert(i, [seq, seq])
        if i + 1 < len(spans) and spans[i + 1][0] <= spans[i][1] + 1:
            spans[i][1] = max(spans[i][1], spans[i + 1][1])
            del spans[i + 1]

    def contains_many(self, tokens: Sequence[str]):
        """Vectorized membership: one sorted-hash ``searchsorted``
        probe over the recent window (possible hits confirmed against
        the dict, killing hash collisions) plus a per-prefix range
        probe for the misses. Returns a bool array aligned with
        ``tokens``."""
        import numpy as np

        out = np.zeros(len(tokens), dtype=bool)
        if not len(tokens):
            return out
        if self._recent:
            if self._hash_cache is None:
                self._hash_cache = np.sort(
                    np.fromiter(
                        (hash(t) for t in self._recent),
                        dtype=np.int64,
                        count=len(self._recent),
                    )
                )
            cache = self._hash_cache
            probe = np.fromiter(
                (hash(t) for t in tokens),
                dtype=np.int64,
                count=len(tokens),
            )
            pos = np.minimum(
                np.searchsorted(cache, probe), len(cache) - 1
            )
            for i in np.nonzero(cache[pos] == probe)[0]:
                out[i] = tokens[i] in self._recent
        if self._ranges:
            for i in np.nonzero(~out)[0]:
                match = _TOKEN_RANGE_RE.match(tokens[i])
                if match and self._in_ranges(
                    match.group(1), int(match.group(2))
                ):
                    out[i] = True
        return out

    def size(self) -> int:
        """Total tokens the ledger still answers for (window + every
        range-compacted token)."""
        return len(self._recent) + sum(
            hi - lo + 1
            for spans in self._ranges.values()
            for lo, hi in spans
        )

    def state_dict(self) -> dict:
        """Checkpointable snapshot. ``token_jobs`` keeps the legacy key
        (old snapshots restore into the window unchanged); the ranges
        ride alongside."""
        return {
            "token_jobs": OrderedDict(self._recent),
            "token_ranges": {
                prefix: [list(span) for span in spans]
                for prefix, spans in self._ranges.items()
            },
            "ledger_evictions": dict(self.evictions),
        }

    def restore(self, recent, ranges=None, evictions=None) -> None:
        self._recent = OrderedDict(
            (str(t), int(n)) for t, n in (recent or {}).items()
        )
        self._ranges = {
            str(prefix): sorted(
                [int(lo), int(hi)] for lo, hi in spans
            )
            for prefix, spans in (ranges or {}).items()
        }
        for key, value in (evictions or {}).items():
            if key in self.evictions:
                self.evictions[key] = int(value)
        self._hash_cache = None
        # A legacy (unbounded) snapshot restores into the window and
        # compacts down to the bound here — exactly-once is preserved
        # through the ranges, the memory bound through the eviction.
        while len(self._recent) > self.window:
            self._evict_oldest()


class AdmissionQueue:
    """Bounded, token-deduplicated buffer between submitters and the
    scheduler's round loop.

    ``submit`` runs on RPC handler threads (or the simulated
    submitter), ``drain``/``depth``/state reads on the round loop; all
    state is guarded by one leaf lock (no calls out while held except
    the obs registry, an established leaf)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        retry_delay_s: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
        priority_aware: bool = False,
        tenant_quotas: Optional[dict] = None,
        shard_label: Optional[str] = None,
        tenant_ledger: Optional[_TenantLedger] = None,
        pricer=None,
        ledger_window: Optional[int] = None,
        group_commit: bool = False,
    ):
        self.capacity = max(1, int(capacity))
        # Base unit of the queue-depth-derived backpressure delay: a
        # rejected submitter waits retry_delay_s scaled by how full the
        # queue is (full queue => one whole unit, plus a term for how
        # far over the batch would have gone).
        self.retry_delay_s = float(retry_delay_s)
        # Priority-aware drain: highest Job.priority_weight first
        # (FIFO within a weight class). Off by default — arrival order
        # is the historical contract.
        self.priority_aware = bool(priority_aware)
        # Per-tenant bound on PENDING jobs (who gets queued when the
        # cluster is full): tenant -> max pending. Tenants not listed
        # (and the anonymous "" tenant) are unbounded short of the
        # queue capacity itself.
        self.tenant_quotas = {
            str(t): max(0, int(q)) for t, q in (tenant_quotas or {}).items()
        }
        # Optional marginal-price admission
        # (:class:`shockwave_tpu_torch.whatif.AdmissionPricer`): prices a
        # fresh batch's Nash-welfare externality BEFORE the queue lock
        # is taken (the 2-scenario solve must never serialize other
        # submitters), and only ever adds a rejection reason — every
        # pricer failure/budget-overrun falls back to this queue's
        # quota-only path unchanged. A priced solve still costs its
        # own wall clock once (the budget is consulted after the
        # solve); repeated overruns open the pricer's circuit breaker
        # so a chronically slow market stops being solved at all.
        self._pricer = pricer
        # token -> verdict (STATUS_PRICED or None) for batches already
        # priced: a backpressure-bounced batch retries the SAME token,
        # and re-pricing the identical batch would pay the 2-scenario
        # solve once per retry for the identical answer.
        self._priced_tokens: "OrderedDict[str, Optional[str]]" = (
            OrderedDict()
        )
        self._clock = clock or time.monotonic
        self._lock = sanitize.make_lock(
            "runtime.admission.AdmissionQueue._lock"
        )
        # (token, job, enqueue_time, seq) in arrival order; seq breaks
        # priority ties deterministically.
        self._pending: deque = deque()
        self._seq = 0
        # Shared across all shards of a sharded front door so quotas
        # bound fleet-wide pending, not per-shard pending.
        self._tenants = tenant_ledger or _TenantLedger()
        # Sharded front door: this queue's shard identity, used only to
        # label its metrics series (the ShardedAdmissionQueue owns the
        # unlabeled aggregate the watchdog's backlog rule reads).
        self._shard_label = shard_label
        # token -> number of jobs recorded under it (the idempotency
        # ledger). Bounded: tokens past the recent window compact into
        # per-prefix resolved ranges, so a token can still never be
        # admitted twice, even long after its batch drained, without
        # the ledger growing without bound at line rate.
        if ledger_window is None:
            ledger_window = int(
                os.environ.get(
                    "SHOCKWAVE_LEDGER_WINDOW", DEFAULT_LEDGER_WINDOW
                )
            )
        self._tokens = _TokenLedger(window=ledger_window)
        # Group commit: concurrent submit() calls convoy behind one
        # leader thread that prices and admits the whole convoy as a
        # single vectorized submit_many pass — N handler threads pay
        # one lock walk and one lane-amortized pricing dispatch
        # instead of N. Zero added latency when idle (a lone submit is
        # its own leader).
        self._group_commit = bool(group_commit)
        self._group_lock = sanitize.make_lock(
            "runtime.admission.AdmissionQueue._group_lock"
        )
        self._group_staged: list = []
        self._group_leader = False
        self._closed = False
        self._opened = False  # any submit ever arrived
        # Counters mirrored into the metrics registry (kept here too so
        # summaries don't depend on metrics being enabled).
        self.stats = {
            "accepted_batches": 0,
            "accepted_jobs": 0,
            "rejected_batches": 0,
            "deduped_batches": 0,
            "closed_rejects": 0,
            "quota_rejects": 0,
            "priced_rejects": 0,
            "priced_accepts": 0,
            "priced_fallbacks": 0,
            "admitted_jobs": 0,
        }
        # Published once so the admission_backlog watchdog rule can
        # judge depth as a fraction of the bound.
        if shard_label is None:
            obs.gauge(
                "admission_queue_capacity",
                "bound on pending jobs in the admission queue",
            ).set(float(self.capacity))
        else:
            obs.gauge(
                "admission_queue_capacity",
                "bound on pending jobs in the admission queue",
            ).set(float(self.capacity), shard=shard_label)

    def _set_depth_gauge_locked(self) -> None:
        """Caller holds the lock."""
        gauge = obs.gauge(
            "admission_queue_depth",
            "jobs accepted but not yet admitted by the round loop",
        )
        if self._shard_label is None:
            gauge.set(float(len(self._pending)))
        else:
            gauge.set(float(len(self._pending)), shard=self._shard_label)

    # -- submitter side -------------------------------------------------
    def submit(
        self,
        token: str,
        jobs: Sequence[Job],
        close: bool = False,
        now: Optional[float] = None,
    ) -> Tuple[str, float, int]:
        """Offer one batch. Returns ``(status, retry_after_s, admitted)``
        where ``admitted`` is the number of jobs recorded under the
        token (0 on rejection; also 0 on a dedup ack whose count was
        compacted out of the bounded ledger's window). Close may ride
        any accepted batch (or an empty one) and is idempotent."""
        token = str(token)
        now = self._clock() if now is None else now
        if self._pricer is not None and jobs:
            status = self._maybe_price(token, jobs)
            if status is not None:
                return status, 0.0, 0
        if self._group_commit and not close:
            return self._submit_grouped(token, jobs, now)
        with self._lock:
            return self._submit_locked(token, jobs, close, now)

    def _submit_locked(
        self,
        token: str,
        jobs: Sequence[Job],
        close: bool,
        now: float,
    ) -> Tuple[str, float, int]:
        """Caller holds the lock. The scalar REFERENCE admission path
        (dedup -> closed -> quota -> backpressure -> append); the
        vectorized :meth:`submit_many` must be decision-for-decision
        equivalent to running batches through here in order, and the
        exactly-once property test holds it to that."""
        self._opened = True
        if token and token in self._tokens:
            # Retried submit: the token already resolved — ack
            # without re-admitting. Close still applies (the retry
            # may be the close-carrying resend).
            if close:
                self._close_locked()
            self.stats["deduped_batches"] += 1
            obs.counter(
                "admission_deduped_total",
                "retried submissions acknowledged via the token "
                "ledger without re-admitting",
            ).inc()
            return STATUS_ACCEPTED, 0.0, self._tokens.get(token) or 0
        if self._closed:
            self.stats["closed_rejects"] += 1
            obs.counter(
                "admission_rejected_total",
                "submissions rejected (backpressure, quota, or "
                "closed stream)",
            ).inc(reason="closed")
            return STATUS_CLOSED, 0.0, 0
        # Check-and-reserve in one ledger critical section: the
        # reservation is released below if backpressure then
        # bounces the batch.
        batch_counts = _TenantLedger.batch_counts(jobs)
        over_quota = (
            self._tenants.reserve(batch_counts, self.tenant_quotas)
            if batch_counts
            else None
        )
        if over_quota is not None:
            self.stats["quota_rejects"] += 1
            obs.counter(
                "admission_rejected_total",
                "submissions rejected (backpressure, quota, or "
                "closed stream)",
            ).inc(reason="quota")
            self._record_event_locked(
                "rejected", token, len(jobs), len(self._pending),
                reason="quota", tenant=over_quota,
            )
            return STATUS_QUOTA, 0.0, 0
        depth = len(self._pending)
        # The bound is on BACKLOG, not on a single batch: an empty
        # queue admits any batch (otherwise a batch larger than
        # the capacity could never be admitted and its submitter
        # would retry the same token forever — a livelock, since
        # rejection never shrinks the batch).
        if jobs and depth and depth + len(jobs) > self.capacity:
            if batch_counts:
                self._tenants.release(batch_counts)
            overflow = depth + len(jobs) - self.capacity
            # Depth-derived delay: how full the queue already is,
            # plus how far over this batch would push it — a deeper
            # backlog earns a longer wait, so a thundering herd
            # spreads out instead of hammering a full queue.
            retry_after = self.retry_delay_s * (
                depth / self.capacity + overflow / max(len(jobs), 1)
            )
            self.stats["rejected_batches"] += 1
            obs.counter(
                "admission_rejected_total",
                "submissions rejected (backpressure or closed "
                "stream)",
            ).inc(reason="backpressure")
            self._record_event_locked(
                "rejected", token, len(jobs), depth,
                retry_after_s=round(retry_after, 3),
            )
            return STATUS_RETRY_AFTER, retry_after, 0
        for job in jobs:
            self._pending.append((token, job, now, self._seq))
            self._seq += 1
        if token:
            self._tokens.add(token, len(jobs))
        self.stats["accepted_batches"] += 1
        self.stats["accepted_jobs"] += len(jobs)
        obs.counter(
            "admission_accepted_total", "submission batches accepted"
        ).inc()
        self._set_depth_gauge_locked()
        self._record_event_locked(
            "accepted", token, len(jobs), len(self._pending)
        )
        if close:
            self._close_locked()
        return STATUS_ACCEPTED, 0.0, len(jobs)

    def submit_many(
        self,
        requests: Sequence[tuple],
        now: Optional[float] = None,
    ) -> List[Tuple[str, float, int]]:
        """Vectorized :meth:`submit` for a whole drain tick's worth of
        batches: ``requests`` is a sequence of ``(token, jobs)`` or
        ``(token, jobs, close)`` tuples; returns one
        ``(status, retry_after_s, admitted)`` per request, aligned.

        Decision-for-decision equivalent to submitting the requests
        through the scalar path in order — token dedup is one hashed
        ledger probe for the whole batch, quota check-and-reserve one
        segmented reduction over the per-tenant count matrix, and
        backpressure one prefix-sum over the depth vector — so a
        4k-submission tick costs one lock walk, not 4k. Requests that
        carry a close flag or repeat a token within the call fall back
        to the scalar path (close ordering and intra-call dedup are
        inherently sequential)."""
        now = self._clock() if now is None else now
        reqs = []
        for request in requests:
            token, jobs = str(request[0]), list(request[1])
            close = bool(request[2]) if len(request) > 2 else False
            reqs.append((token, jobs, close))
        tokens = [r[0] for r in reqs]
        if (
            not reqs
            or any(r[2] for r in reqs)
            or len(set(tokens)) != len(tokens)
        ):
            return [
                self.submit(token, jobs, close=close, now=now)
                for token, jobs, close in reqs
            ]
        results: List[Optional[Tuple[str, float, int]]] = [None] * len(reqs)
        if self._pricer is not None:
            self._price_many(reqs, results, now)
        with self._lock:
            self._submit_many_locked(reqs, results, now)
        return results  # type: ignore[return-value]

    def _submit_many_locked(self, reqs, results, now) -> None:
        """Caller holds the lock: the vectorized dedup / quota /
        backpressure / commit pass. ``results`` already carries PRICED
        verdicts for shed batches; every other slot is filled here."""
        import numpy as np

        self._opened = True
        n = len(reqs)
        live = [i for i in range(n) if results[i] is None]
        # -- dedup: one hashed-ledger probe for the whole batch -------
        if live:
            dup = self._tokens.contains_many(
                [reqs[i][0] for i in live]
            )
            deduped = [i for k, i in enumerate(live) if dup[k]]
            for i in deduped:
                self.stats["deduped_batches"] += 1
                results[i] = (
                    STATUS_ACCEPTED,
                    0.0,
                    self._tokens.get(reqs[i][0]) or 0,
                )
            if deduped:
                obs.counter(
                    "admission_deduped_total",
                    "retried submissions acknowledged via the token "
                    "ledger without re-admitting",
                ).inc(len(deduped))
            live = [i for k, i in enumerate(live) if not dup[k]]
        if self._closed:
            for i in live:
                self.stats["closed_rejects"] += 1
                obs.counter(
                    "admission_rejected_total",
                    "submissions rejected (backpressure, quota, or "
                    "closed stream)",
                ).inc(reason="closed")
                results[i] = (STATUS_CLOSED, 0.0, 0)
            return
        if not live:
            return
        # -- quota + backpressure fixpoint ----------------------------
        # Vector state for the candidates: batch sizes, the
        # per-candidate × quota-tenant count matrix, and the tenants'
        # pending tallies as of this tick. The scalar path evaluates
        # candidates in order, each seeing its predecessors' accepted
        # reservations/appends; the prefix-sum reproduces exactly
        # that, and each rejection only ever SHRINKS later candidates'
        # prefix sums — so knocking out the earliest failure and
        # re-running converges in <= len(live) passes with the same
        # verdicts the sequential walk would give.
        sizes = np.array([len(reqs[i][1]) for i in live], dtype=np.int64)
        counts = [_TenantLedger.batch_counts(reqs[i][1]) for i in live]
        qt = sorted(self.tenant_quotas)
        quota_vec = np.array(
            [self.tenant_quotas[t] for t in qt], dtype=np.int64
        )
        cmat = np.array(
            [[c.get(t, 0) for t in qt] for c in counts], dtype=np.int64
        ) if qt else np.zeros((len(live), 0), dtype=np.int64)
        pending0 = np.array(
            self._tenants.pending_of(qt), dtype=np.int64
        ) if qt else np.zeros(0, dtype=np.int64)
        depth0 = len(self._pending)
        mask = np.ones(len(live), dtype=bool)
        while True:
            sized = sizes * mask
            before = depth0 + np.concatenate(
                ([0], np.cumsum(sized)[:-1])
            )
            prior = np.concatenate(
                (
                    np.zeros((1, len(qt)), dtype=np.int64),
                    np.cumsum(cmat * mask[:, None], axis=0)[:-1],
                ),
                axis=0,
            ) if qt else np.zeros((len(live), 0), dtype=np.int64)
            # Quota first (scalar order: quota precedes backpressure).
            quota_fail = mask & (
                ((pending0 + prior + cmat > quota_vec) & (cmat > 0)).any(
                    axis=1
                )
                if qt
                else np.zeros(len(live), dtype=bool)
            )
            cap_fail = (
                mask
                & ~quota_fail
                & (sizes > 0)
                & (before > 0)
                & (before + sizes > self.capacity)
            )
            fails = np.nonzero(quota_fail | cap_fail)[0]
            if not len(fails):
                break
            k = int(fails[0])
            i = live[k]
            token, jobs, _close = reqs[i]
            mask[k] = False
            if quota_fail[k]:
                # Name the over-quota tenant the way the scalar walk
                # would: first tenant in the batch's iteration order
                # that the reservation would push past its quota.
                tally = pending0 + prior[k]
                over = next(
                    (
                        t
                        for t in counts[k]
                        if t in self.tenant_quotas
                        and tally[qt.index(t)] + counts[k][t]
                        > self.tenant_quotas[t]
                    ),
                    next(iter(counts[k]), ""),
                )
                self.stats["quota_rejects"] += 1
                obs.counter(
                    "admission_rejected_total",
                    "submissions rejected (backpressure, quota, or "
                    "closed stream)",
                ).inc(reason="quota")
                self._record_event_locked(
                    "rejected", token, len(jobs), int(before[k]),
                    reason="quota", tenant=over,
                )
                results[i] = (STATUS_QUOTA, 0.0, 0)
            else:
                depth = int(before[k])
                overflow = depth + len(jobs) - self.capacity
                retry_after = self.retry_delay_s * (
                    depth / self.capacity + overflow / max(len(jobs), 1)
                )
                self.stats["rejected_batches"] += 1
                obs.counter(
                    "admission_rejected_total",
                    "submissions rejected (backpressure or closed "
                    "stream)",
                ).inc(reason="backpressure")
                self._record_event_locked(
                    "rejected", token, len(jobs), depth,
                    retry_after_s=round(retry_after, 3),
                )
                results[i] = (STATUS_RETRY_AFTER, retry_after, 0)
        # -- commit the accepted candidates in one pass ---------------
        accepted = [live[k] for k in np.nonzero(mask)[0]]
        if not accepted:
            return
        merged: Dict[str, int] = {}
        for k in np.nonzero(mask)[0]:
            for tenant, count in counts[k].items():
                merged[tenant] = merged.get(tenant, 0) + count
        if merged and self._tenants.reserve(
            merged, self.tenant_quotas
        ) is not None:
            # The shared ledger moved under us (a sibling shard raced a
            # reservation between our snapshot and the commit): replay
            # the accepted candidates through the scalar reference path
            # — rare, and correctness beats the vector win here.
            for i in accepted:
                token, jobs, close = reqs[i]
                results[i] = self._submit_locked(token, jobs, close, now)
            return
        for i in accepted:
            token, jobs, _close = reqs[i]
            for job in jobs:
                self._pending.append((token, job, now, self._seq))
                self._seq += 1
            if token:
                self._tokens.add(token, len(jobs))
            self.stats["accepted_batches"] += 1
            self.stats["accepted_jobs"] += len(jobs)
            self._record_event_locked(
                "accepted", token, len(jobs), len(self._pending)
            )
            results[i] = (STATUS_ACCEPTED, 0.0, len(jobs))
        obs.counter(
            "admission_accepted_total", "submission batches accepted"
        ).inc(len(accepted))
        self._set_depth_gauge_locked()

    def _price_many(self, reqs, results, now) -> None:
        """Lane-amortized pricing for the fresh, unpriced batches in
        ``reqs``: ONE ScenarioBatch dispatch with a masked overlay lane
        per burst (pricer.price_batch) instead of one 2-scenario solve
        each. Runs OUTSIDE the queue lock; fills ``results`` slots for
        shed batches (STATUS_PRICED) and leaves the rest None for the
        vectorized admission pass."""
        fresh = []
        with self._lock:
            self._opened = True
            for i, (token, jobs, _close) in enumerate(reqs):
                if not jobs:
                    continue
                if (token and token in self._tokens) or self._closed:
                    continue  # dedup / closed semantics own this one
                if token and token in self._priced_tokens:
                    if self._priced_tokens[token] is not None:
                        results[i] = (self._priced_tokens[token], 0.0, 0)
                    continue
                fresh.append(i)
        if not fresh:
            return
        price_batch = getattr(self._pricer, "price_batch", None)
        if price_batch is not None:
            decisions = price_batch([reqs[i][1] for i in fresh])
        else:
            decisions = [self._pricer.price(reqs[i][1]) for i in fresh]
        priced_rejects = 0
        with self._lock:
            for i, decision in zip(fresh, decisions):
                token = reqs[i][0]
                if token and token in self._priced_tokens:
                    # Raced a concurrent scalar submit: first verdict
                    # wins, exactly like _maybe_price.
                    if self._priced_tokens[token] is not None:
                        results[i] = (self._priced_tokens[token], 0.0, 0)
                    continue
                stat = {
                    "accept": "priced_accepts",
                    "reject": "priced_rejects",
                    "fallback": "priced_fallbacks",
                }.get(decision.action, "priced_fallbacks")
                verdict = (
                    STATUS_PRICED if decision.action == "reject" else None
                )
                self.stats[stat] += 1
                if token:
                    self._priced_tokens[token] = verdict
                    while len(self._priced_tokens) > 1024:
                        self._priced_tokens.popitem(last=False)
                self._record_event_locked(
                    "priced", token, len(reqs[i][1]), len(self._pending),
                    **decision.as_record(),
                )
                if verdict is not None:
                    priced_rejects += 1
                    results[i] = (verdict, 0.0, 0)
        if priced_rejects:
            obs.counter(
                "admission_rejected_total",
                "submissions rejected (backpressure, quota, pricing, "
                "or closed stream)",
            ).inc(priced_rejects, reason="priced")

    def _submit_grouped(
        self, token: str, jobs: Sequence[Job], now: float
    ) -> Tuple[str, float, int]:
        """Group commit: stage this submission; the first thread to
        find no leader running becomes the leader and commits every
        staged entry (its own included, plus any that pile up while it
        works) through one vectorized :meth:`submit_many` pass per
        convoy. Followers block on their entry's event and return the
        leader's verdict — N concurrent handler threads pay one lock
        walk and one lane-amortized pricing dispatch."""
        entry = [token, list(jobs), now, threading.Event(), None, None]
        with self._group_lock:
            self._group_staged.append(entry)
            if self._group_leader:
                leader = False
            else:
                self._group_leader = True
                leader = True
        if not leader:
            entry[3].wait()
            if entry[5] is not None:
                raise entry[5]
            return entry[4]
        try:
            while True:
                with self._group_lock:
                    convoy = self._group_staged
                    self._group_staged = []
                    if not convoy:
                        self._group_leader = False
                        break
                try:
                    outs = self.submit_many(
                        [(e[0], e[1]) for e in convoy],
                        now=min(e[2] for e in convoy),
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
            with self._group_lock:
                self._group_leader = False
                leftover = self._group_staged
                self._group_staged = []
            for e in leftover:
                e[5] = e[5] or RuntimeError(
                    "group-commit leader died before this entry"
                )
                e[3].set()
            raise
        if entry[5] is not None:
            raise entry[5]
        return entry[4]

    def _maybe_price(self, token: str, jobs: Sequence[Job]):
        """Marginal-price pass for one fresh batch, OUTSIDE the queue
        lock (a pricing solve must not serialize sibling submitters).
        Returns :data:`STATUS_PRICED` when the batch is shed, else
        None — the normal submit path (dedup, quota, backpressure)
        then decides. A retried token is never re-priced (the ledger
        already resolved it); two handler threads racing the same
        FRESH token may both pay the pricing solve, but the ledger
        still admits exactly one."""
        with self._lock:
            self._opened = True
            if (token and token in self._tokens) or self._closed:
                return None  # dedup / closed-stream semantics own this
            if token and token in self._priced_tokens:
                # A backpressure-bounced retry of an already-priced
                # batch: same token, same batch, same externality —
                # reuse the verdict instead of re-solving.
                return self._priced_tokens[token]
        decision = self._pricer.price(jobs)
        stat = {
            "accept": "priced_accepts",
            "reject": "priced_rejects",
            "fallback": "priced_fallbacks",
        }.get(decision.action, "priced_fallbacks")
        verdict = STATUS_PRICED if decision.action == "reject" else None
        with self._lock:
            if token and token in self._priced_tokens:
                # Two handler threads raced the same fresh token; the
                # first verdict written wins so both callers see ONE
                # consistent answer (a split accept/shed response
                # would desynchronize the client from the ledger).
                return self._priced_tokens[token]
            self.stats[stat] += 1
            if token:
                self._priced_tokens[token] = verdict
                while len(self._priced_tokens) > 1024:
                    self._priced_tokens.popitem(last=False)
            self._record_event_locked(
                "priced", token, len(jobs), len(self._pending),
                **decision.as_record(),
            )
        if verdict is not None:
            obs.counter(
                "admission_rejected_total",
                "submissions rejected (backpressure, quota, pricing, "
                "or closed stream)",
            ).inc(reason="priced")
        return verdict

    def close(self, token: str = "") -> None:
        """End of stream: no further submissions will be accepted.
        Idempotent."""
        with self._lock:
            self._opened = True
            self._close_locked(token)

    def open(self) -> None:
        """Declare the stream open before the first submit arrives, so
        a round loop started ahead of its submitter idles instead of
        concluding the run is empty (the startup race every
        out-of-process front door has)."""
        with self._lock:
            self._opened = True

    def _close_locked(self, token: str = "") -> None:
        """Caller holds the lock."""
        if self._closed:
            return
        self._closed = True
        obs.instant(
            "admission_closed", cat="admission", tid="admission",
            args={"pending": len(self._pending)},
        )
        recorder = obs.get_recorder()
        if recorder.enabled:
            recorder.record_admission(
                {"kind": "close", "token": token,
                 "pending": len(self._pending)}
            )

    def _record_event_locked(
        self, kind: str, token: str, jobs: int, depth: int, **detail
    ) -> None:
        """Caller holds the lock."""
        obs.instant(
            f"admission_{kind}", cat="admission", tid="admission",
            args={"token": token, "jobs": jobs, "depth": depth, **detail},
        )
        recorder = obs.get_recorder()
        if recorder.enabled:
            recorder.record_admission(
                {"kind": kind, "token": token, "jobs": jobs,
                 "depth": depth, **detail}
            )

    # -- scheduler side -------------------------------------------------
    def drain(
        self, max_jobs: Optional[int] = None, now: Optional[float] = None
    ) -> List[Tuple[str, Job, float]]:
        """Pop up to ``max_jobs`` pending jobs (all of them by default)
        in arrival order for admission into the scheduler. Observes
        per-job queue latency."""
        now = self._clock() if now is None else now
        with self._lock:
            budget = len(self._pending) if max_jobs is None else max_jobs
            if self.priority_aware and len(self._pending) > 1:
                # Highest priority_weight first; FIFO within a weight
                # class by ARRIVAL time (seq breaks exact-time ties) —
                # enqueue_time is the stamp that stays comparable when
                # the sharded front door rebalances entries between
                # shards, where per-shard seq counters are not, and it
                # is the key _peek_priority reports for the cross-shard
                # merge drain.
                ordered = sorted(
                    self._pending,
                    key=lambda e: (
                        -float(getattr(e[1], "priority_weight", 1.0) or 1.0),
                        e[2],
                        e[3],
                    ),
                )
                self._pending = deque(ordered)
            latency = obs.histogram(
                "admission_queue_latency_seconds",
                "time a job waited in the admission queue before the "
                "round loop admitted it",
            )
            if budget >= len(self._pending):
                # Full drain: take the whole deque in one move instead
                # of 4k popleft calls on a line-rate tick.
                entries = list(self._pending)
                self._pending.clear()
            else:
                entries = [
                    self._pending.popleft()
                    for _ in range(max(0, int(budget)))
                    if self._pending
                ]
            out = [
                (token, job, enqueued)
                for token, job, enqueued, _seq in entries
            ]
            if entries:
                released = _TenantLedger.batch_counts(
                    [e[1] for e in entries]
                )
                if released:
                    self._tenants.release(released)
                import numpy as np

                waits = np.maximum(now - np.fromiter(
                    map(_ENQUEUED_OF, entries), dtype=np.float64,
                    count=len(entries)), 0.0)
                latency.observe_many(waits)
                # Worst offender of the batch keeps its identity: the
                # histogram above is a rollup, so without this a
                # pathological straggler is invisible past its quantile.
                # One offer per drain (not per job) keeps line-rate
                # drains O(batch) with a single reservoir touch.
                worst = int(np.argmax(waits))
                worst_wait = float(waits[worst])
                obs.offer_exemplar(
                    "admission_worst_wait",
                    str(entries[worst][0]),
                    worst_wait,
                    help="submit tokens that waited longest in the "
                    "admission queue",
                    wait_s=round(worst_wait, 6),
                )
            if out:
                self.stats["admitted_jobs"] += len(out)
                obs.counter(
                    "admission_jobs_admitted_total",
                    "jobs drained from the admission queue into the "
                    "scheduler",
                ).inc(len(out))
            self._set_depth_gauge_locked()
            return out

    # -- sharded-front-door internals (ShardedAdmissionQueue only) -----
    def _peek_priority(self) -> Optional[Tuple[float, float]]:
        """Drain key ``(-priority_weight, enqueue_time)`` of the entry
        a priority-aware ``drain(max_jobs=1)`` would pop next, or None
        when empty — lets the sharded front door merge-drain across
        shards in global priority order."""
        with self._lock:
            if not self._pending:
                return None
            return min(
                (
                    -float(getattr(e[1], "priority_weight", 1.0) or 1.0),
                    e[2],
                )
                for e in self._pending
            )

    def _take_newest(self, count: int) -> list:
        """Pop up to ``count`` NEWEST pending entries (for backlog
        rebalancing: the oldest jobs keep their position in their home
        shard, the freshest spill to an emptier one)."""
        with self._lock:
            out = []
            while self._pending and len(out) < count:
                out.append(self._pending.pop())
            self._set_depth_gauge_locked()
            return list(reversed(out))

    def _give(self, entries: list) -> int:
        """Accept entries rebalanced from a sibling shard (bypasses
        the token ledger — the routing shard keeps dedup ownership).
        Tenant tallies don't move either: shards share one fleet-wide
        :class:`_TenantLedger`, and a rebalanced job is still pending."""
        with self._lock:
            for entry in entries:
                self._pending.append(entry)
            self._set_depth_gauge_locked()
            return len(entries)

    def _free_space(self) -> int:
        with self._lock:
            return max(0, self.capacity - len(self._pending))

    # -- HA survivability (shockwave_tpu/ha/) ---------------------------
    def state_dict(self, include_tenants: bool = True) -> dict:
        """Snapshot for the control-plane journal: the token ledger
        (exactly-once survives failover), the pending backlog, and the
        stream open/close state. ``include_tenants=False`` for shards
        of a sharded front door (the SHARED ledger is captured once by
        the wrapper)."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        with self._lock:
            state = {
                "pending": [
                    (token, ha_codec.job_state(job), enqueued, seq)
                    for token, job, enqueued, seq in self._pending
                ],
                "seq": self._seq,
                "closed": self._closed,
                "opened": self._opened,
                "stats": dict(self.stats),
                # token_jobs (the legacy key) + token_ranges +
                # ledger_evictions: the bounded ledger's snapshot.
                **self._tokens.state_dict(),
            }
        if include_tenants:
            state["tenant_pending"] = self._tenants.state_dict()
        return state

    def restore_state(self, state: dict) -> None:
        """Install a decoded :meth:`state_dict` snapshot (freshly
        constructed queue with the same capacity/policy config)."""
        from shockwave_tpu_torch.ha import codec as ha_codec

        with self._lock:
            self._pending = deque(
                (
                    str(token),
                    ha_codec.job_from_state(job_fields),
                    float(enqueued),
                    int(seq),
                )
                for token, job_fields, enqueued, seq in (
                    state.get("pending") or []
                )
            )
            self._seq = int(state.get("seq", 0))
            self._tokens.restore(
                state.get("token_jobs"),
                state.get("token_ranges"),
                state.get("ledger_evictions"),
            )
            self._closed = bool(state.get("closed"))
            self._opened = bool(state.get("opened"))
            for key, value in (state.get("stats") or {}).items():
                if key in self.stats:
                    self.stats[key] = value
            self._set_depth_gauge_locked()
        if "tenant_pending" in state:
            self._tenants.restore_state(state["tenant_pending"])

    def restore_submission(
        self, token: str, jobs: Sequence[Job], close: bool = False
    ) -> int:
        """WAL-tail replay of one ACCEPTED batch: force the token into
        the ledger and its jobs into the backlog, bypassing quota and
        backpressure (the previous leader already admitted it — this
        queue must converge to that decision, not re-judge it).
        Idempotent on the token. Returns the jobs queued."""
        token = str(token)
        with self._lock:
            self._opened = True
            if token and token in self._tokens:
                if close:
                    self._close_locked(token)
                return 0  # checkpoint (or a duplicate entry) had it
            now = self._clock()
            for job in jobs:
                self._pending.append((token, job, now, self._seq))
                self._seq += 1
            if token:
                self._tokens.add(token, len(jobs))
            counts = _TenantLedger.batch_counts(jobs)
            self._set_depth_gauge_locked()
            if close:
                self._close_locked(token)
        if counts:
            self._tenants.force_add(counts)
        return len(jobs)

    def discard_pending(self, token: str, count: int = 1) -> int:
        """WAL-tail replay of an admission: the previous leader drained
        ``count`` of this token's jobs into its scheduler (replayed
        separately through add_job), so they must leave the restored
        backlog or the successor's drain would admit them twice.
        Returns the entries removed."""
        token = str(token)
        removed = 0
        with self._lock:
            kept = deque()
            while self._pending:
                entry = self._pending.popleft()
                if removed < count and entry[0] == token:
                    removed += 1
                    tenant = str(getattr(entry[1], "tenant", "") or "")
                    if tenant:
                        self._tenants.dec(tenant)
                    continue
                kept.append(entry)
            self._pending = kept
            self._set_depth_gauge_locked()
        return removed

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def opened(self) -> bool:
        """True once any submit/close ever arrived — the signal that a
        run is using the streaming front door (and the round loop
        should idle on an empty job table instead of exiting)."""
        with self._lock:
            return self._opened

    def summary(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "depth": len(self._pending),
                "closed": self._closed,
                "tokens": self._tokens.size(),
                "ledger_window": len(self._tokens._recent),
                "ledger_evictions": dict(self._tokens.evictions),
                **dict(self.stats),
            }


class ShardedAdmissionQueue:
    """The admission front door sharded for the cell-decomposed
    planner: N :class:`AdmissionQueue` shards behind the single-queue
    interface, each owning a slice of the total bound.

    * **Routing.** A batch routes to ``crc32(token) % shards`` — a
      retried token always lands on the shard holding its ledger
      entry, so exactly-once admission survives sharding.
    * **Coordinator rebalancing.** A shard that would reject a batch
      under backpressure first pulls the coordinator: backlog spills
      from the fullest shards into the emptiest (newest entries move;
      the token ledger stays with the routing shard), so one hot
      submitter cannot brown out its shard while the fleet has queue
      room. The same rebalance runs before every drain.
    * **Aggregate observability.** Shards label their gauges
      (``shard=sN``); this wrapper maintains the unlabeled
      ``admission_queue_depth``/``capacity`` series the
      ``admission_backlog`` watchdog rule reads.

    Same submit/drain/close/depth/opened/closed/summary vocabulary as
    :class:`AdmissionQueue` — the scheduler cannot tell them apart.
    """

    def __init__(
        self,
        num_shards: int,
        capacity: int = DEFAULT_CAPACITY,
        retry_delay_s: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
        priority_aware: bool = False,
        tenant_quotas: Optional[dict] = None,
        pricer=None,
        ledger_window: Optional[int] = None,
        group_commit: bool = False,
    ):
        self.num_shards = max(1, int(num_shards))
        self.capacity = max(self.num_shards, int(capacity))
        # Shard capacities sum EXACTLY to the configured bound (first
        # `extra` shards take the remainder) — a ceil split would let
        # the fleet hold up to shards-1 jobs more than the capacity
        # the aggregate gauge and the backlog watchdog advertise.
        base, extra = divmod(self.capacity, self.num_shards)
        # ONE ledger for all shards: a tenant's quota bounds the
        # fleet's pending jobs, however the batches hash across shards
        # and wherever rebalancing later moves them.
        ledger = _TenantLedger()
        self.shards: List[AdmissionQueue] = [
            AdmissionQueue(
                capacity=base + (1 if i < extra else 0),
                retry_delay_s=retry_delay_s,
                clock=clock,
                priority_aware=priority_aware,
                tenant_quotas=tenant_quotas,
                shard_label=f"s{i:02d}",
                tenant_ledger=ledger,
                # One pricer for the fleet: the externality is a
                # fleet-wide quantity, whichever shard a token hashes
                # to.
                pricer=pricer,
                ledger_window=ledger_window,
                group_commit=group_commit,
            )
            for i in range(self.num_shards)
        ]
        self.priority_aware = bool(priority_aware)
        obs.gauge(
            "admission_queue_capacity",
            "bound on pending jobs in the admission queue",
        ).set(float(self.capacity))
        obs.gauge(
            "admission_queue_shards", "admission front-door shard count"
        ).set(float(self.num_shards))

    def _shard_index(self, token: str) -> int:
        import zlib

        return zlib.crc32(str(token).encode("utf-8")) % self.num_shards

    def _shard_of(self, token: str) -> AdmissionQueue:
        return self.shards[self._shard_index(token)]

    def _set_depth_gauge(self) -> None:
        obs.gauge(
            "admission_queue_depth",
            "jobs accepted but not yet admitted by the round loop",
        ).set(float(self.depth()))

    def rebalance(self) -> int:
        """Coordinator-level backlog rebalancing: move the newest
        pending entries from over-full shards into shards with free
        space until depths are within one batch of even. Returns the
        number of jobs moved. Token ledgers do not move — dedup
        ownership stays with the routing shard."""
        moved = 0
        for _ in range(self.num_shards * 2):
            depths = [q.depth() for q in self.shards]
            hi = max(range(self.num_shards), key=lambda i: depths[i])
            lo = min(range(self.num_shards), key=lambda i: depths[i])
            excess = depths[hi] - depths[lo]
            space = self.shards[lo]._free_space()
            if excess <= 1 or space <= 0:
                break
            count = min(excess // 2, space)
            if count <= 0:
                break
            entries = self.shards[hi]._take_newest(count)
            if not entries:
                break
            moved += self.shards[lo]._give(entries)
        if moved:
            obs.counter(
                "admission_rebalanced_total",
                "pending jobs moved between admission shards by the "
                "coordinator",
            ).inc(moved)
        return moved

    # -- submitter side -------------------------------------------------
    def submit(
        self,
        token: str,
        jobs: Sequence[Job],
        close: bool = False,
        now: Optional[float] = None,
    ) -> Tuple[str, float, int]:
        shard = self._shard_of(token)
        status, retry_after, admitted = shard.submit(
            token, jobs, close=close, now=now
        )
        if status == STATUS_RETRY_AFTER:
            # The shard is full but the fleet may not be: spill the
            # routing shard's newest backlog into siblings with free
            # space until this batch fits, then offer it once more
            # before bouncing the submitter.
            if self._make_room(shard, len(jobs)):
                status, retry_after, admitted = shard.submit(
                    token, jobs, close=close, now=now
                )
        if close and status == STATUS_ACCEPTED:
            # Propagate end-of-stream to the sibling shards only once
            # the close-carrying batch is actually in (the routing
            # shard closed inside submit). A rejected close-carrying
            # batch keeps the fleet open — its backoff retry is the
            # close-carrying resend, and closing now would turn that
            # retry into a permanently lost final batch.
            self.close(token)
        self._set_depth_gauge()
        return status, retry_after, admitted

    def submit_many(
        self,
        requests: Sequence[tuple],
        now: Optional[float] = None,
    ) -> List[Tuple[str, float, int]]:
        """Vectorized submit across the fleet: requests partition by
        token hash, one vector pass per shard. A batch the vector pass
        bounced with RETRY_AFTER gets the same second chance the
        scalar path gives — rebalance room out of its routing shard,
        then one scalar re-offer."""
        reqs = []
        for request in requests:
            token, jobs = str(request[0]), list(request[1])
            close = bool(request[2]) if len(request) > 2 else False
            reqs.append((token, jobs, close))
        results: List[Optional[Tuple[str, float, int]]] = [None] * len(reqs)
        by_shard: Dict[int, List[int]] = {}
        for i, (token, _jobs, _close) in enumerate(reqs):
            by_shard.setdefault(self._shard_index(token), []).append(i)
        for shard_i, positions in by_shard.items():
            shard = self.shards[shard_i]
            outs = shard.submit_many(
                [reqs[i] for i in positions], now=now
            )
            for i, out in zip(positions, outs):
                results[i] = out
        for i, out in enumerate(results):
            if out is None or out[0] != STATUS_RETRY_AFTER:
                continue
            token, jobs, close = reqs[i]
            shard = self.shards[self._shard_index(token)]
            if self._make_room(shard, len(jobs)):
                results[i] = shard.submit(
                    token, jobs, close=close, now=now
                )
        for i, out in enumerate(results):
            if reqs[i][2] and out is not None and out[0] == STATUS_ACCEPTED:
                self.close(reqs[i][0])
        self._set_depth_gauge()
        return results  # type: ignore[return-value]

    def _make_room(self, shard: AdmissionQueue, incoming: int) -> int:
        """Spill backlog out of ``shard`` until ``incoming`` more jobs
        fit (or the fleet is genuinely full). Returns jobs moved."""
        needed = shard.depth() + int(incoming) - shard.capacity
        if needed <= 0:
            return 0
        moved = 0
        order = sorted(
            (s for s in self.shards if s is not shard),
            key=lambda s: s.depth(),
        )
        for sibling in order:
            space = sibling._free_space()
            if space <= 0:
                continue
            entries = shard._take_newest(min(space, needed - moved))
            if not entries:
                break
            moved += sibling._give(entries)
            if moved >= needed:
                break
        if moved:
            obs.counter(
                "admission_rebalanced_total",
                "pending jobs moved between admission shards by the "
                "coordinator",
            ).inc(moved)
        return moved

    def close(self, token: str = "") -> None:
        for shard in self.shards:
            shard.close(token)

    def open(self) -> None:
        for shard in self.shards:
            shard.open()

    # -- scheduler side -------------------------------------------------
    def drain(
        self, max_jobs: Optional[int] = None, now: Optional[float] = None
    ) -> List[Tuple[str, Job, float]]:
        self.rebalance()
        out: List[Tuple[str, Job, float]] = []
        if self.priority_aware:
            # Global priority order, not shard order: a weight-10 job
            # must not wait behind a sibling shard's weight-1 backlog
            # just because of where its token hashed. Whole-fleet
            # drains merge-sort; budgeted drains pop the best shard
            # head one job at a time (shard index breaks exact ties
            # deterministically).
            total = self.depth()
            budget = total if max_jobs is None else min(int(max_jobs), total)
            if budget >= total:
                for shard in self.shards:
                    out.extend(shard.drain(max_jobs=None, now=now))
                out.sort(
                    key=lambda e: (
                        -float(
                            getattr(e[1], "priority_weight", 1.0) or 1.0
                        ),
                        e[2],
                    )
                )
            else:
                while len(out) < budget:
                    best = None
                    best_shard = None
                    for shard in self.shards:
                        head = shard._peek_priority()
                        if head is not None and (
                            best is None or head < best
                        ):
                            best, best_shard = head, shard
                    if best_shard is None:
                        break
                    out.extend(best_shard.drain(max_jobs=1, now=now))
        else:
            budget = max_jobs
            for shard in self.shards:
                take = None if budget is None else budget - len(out)
                if take is not None and take <= 0:
                    break
                out.extend(shard.drain(max_jobs=take, now=now))
        self._set_depth_gauge()
        return out

    # -- HA survivability (shockwave_tpu/ha/) ---------------------------
    def state_dict(self) -> dict:
        """Per-shard snapshots plus ONE copy of the shared tenant
        ledger (capturing it per shard would restore N× the tallies)."""
        return {
            "shards": [
                shard.state_dict(include_tenants=False)
                for shard in self.shards
            ],
            "tenant_pending": self.shards[0]._tenants.state_dict(),
        }

    def restore_state(self, state: dict) -> None:
        shard_states = state.get("shards") or []
        if len(shard_states) != self.num_shards:
            raise ValueError(
                f"admission snapshot has {len(shard_states)} shards but "
                f"this front door is configured with {self.num_shards} — "
                "the successor must run the same cell/shard config"
            )
        for shard, shard_state in zip(self.shards, shard_states):
            shard.restore_state(shard_state)
        self.shards[0]._tenants.restore_state(
            state.get("tenant_pending") or {}
        )
        self._set_depth_gauge()

    def restore_submission(
        self, token: str, jobs: Sequence[Job], close: bool = False
    ) -> int:
        queued = self._shard_of(token).restore_submission(
            token, jobs, close=close
        )
        if close:
            self.close(token)
        self._set_depth_gauge()
        return queued

    def discard_pending(self, token: str, count: int = 1) -> int:
        # Route like submit; rebalancing may have moved the entries to
        # a sibling, so sweep the rest when the routing shard comes up
        # short.
        removed = self._shard_of(token).discard_pending(token, count)
        for shard in self.shards:
            if removed >= count:
                break
            removed += shard.discard_pending(token, count - removed)
        self._set_depth_gauge()
        return removed

    def depth(self) -> int:
        return sum(q.depth() for q in self.shards)

    @property
    def closed(self) -> bool:
        return all(q.closed for q in self.shards)

    @property
    def opened(self) -> bool:
        return any(q.opened for q in self.shards)

    def summary(self) -> dict:
        merged: dict = {
            "capacity": self.capacity,
            "depth": self.depth(),
            "closed": self.closed,
            "shards": self.num_shards,
            "tokens": 0,
        }
        for key in self.shards[0].stats:
            merged[key] = 0
        for shard in self.shards:
            s = shard.summary()
            merged["tokens"] += s["tokens"]
            for key in shard.stats:
                merged[key] += s[key]
        merged["per_shard_depth"] = [q.depth() for q in self.shards]
        return merged


def build_queue(
    capacity: int,
    retry_delay_s: float,
    clock: Optional[Callable[[], float]] = None,
    shards: int = 1,
    priority_aware: Optional[bool] = None,
    tenant_quotas: Optional[dict] = None,
    pricer=None,
    group_commit: Optional[bool] = None,
):
    """Front-door factory: one queue, or a sharded one when the planner
    is cell-decomposed. Env knobs fill unset policy arguments:
    ``SHOCKWAVE_ADMISSION_PRIORITY=1`` turns on priority-aware drain,
    ``SHOCKWAVE_ADMISSION_QUOTAS="teamA=32,teamB=8"`` sets per-tenant
    pending quotas, ``SHOCKWAVE_ADMISSION_GROUP_COMMIT=1`` convoys
    concurrent handler threads through the vectorized group-commit
    path, and ``SHOCKWAVE_LEDGER_WINDOW`` sizes the bounded token
    ledger's recent window."""
    if group_commit is None:
        group_commit = os.environ.get(
            "SHOCKWAVE_ADMISSION_GROUP_COMMIT", ""
        ).strip() in ("1", "true", "yes")
    if priority_aware is None:
        priority_aware = os.environ.get(
            "SHOCKWAVE_ADMISSION_PRIORITY", ""
        ).strip() in ("1", "true", "yes")
    if tenant_quotas is None:
        raw = os.environ.get("SHOCKWAVE_ADMISSION_QUOTAS", "").strip()
        if raw:
            tenant_quotas = {}
            for part in raw.split(","):
                tenant, _, quota = part.partition("=")
                if tenant.strip() and quota.strip().isdigit():
                    tenant_quotas[tenant.strip()] = int(quota.strip())
    if int(shards) > 1:
        return ShardedAdmissionQueue(
            int(shards),
            capacity=capacity,
            retry_delay_s=retry_delay_s,
            clock=clock,
            priority_aware=priority_aware,
            tenant_quotas=tenant_quotas,
            pricer=pricer,
            group_commit=group_commit,
        )
    return AdmissionQueue(
        capacity=capacity,
        retry_delay_s=retry_delay_s,
        clock=clock,
        priority_aware=priority_aware,
        tenant_quotas=tenant_quotas,
        pricer=pricer,
        group_commit=group_commit,
    )


class StreamingSubmitter:
    """Deterministic virtual-time submitter over an (arrival_time, job)
    trace, for driving the simulator through the admission front door.

    Batches due arrivals, offers each batch to the queue under a
    deterministic token, honors backpressure by resubmitting the SAME
    token after the returned delay, and exercises the fault-injection
    hooks for ``SubmitJobs`` so injected ``rpc_error``/``rpc_drop``
    events force retried (and therefore deduplicated) submissions —
    the same exactly-once path a real network client takes.
    """

    def __init__(
        self,
        arrivals: Sequence[float],
        jobs: Sequence[Job],
        batch_size: int = 4,
        token_prefix: str = "sub",
    ):
        if len(arrivals) != len(jobs):
            raise ValueError(
                f"{len(arrivals)} arrival times for {len(jobs)} jobs"
            )
        order = sorted(range(len(jobs)), key=lambda i: (arrivals[i], i))
        self._queue_in: deque = deque(
            (float(arrivals[i]), jobs[i]) for i in order
        )
        self.total_jobs = len(jobs)
        self.batch_size = max(1, int(batch_size))
        self._token_prefix = token_prefix
        self._seq = 0
        # Batch awaiting (re)submission: (token, jobs, arrival, not_before).
        self._inflight: Optional[tuple] = None
        self._close_sent = False
        self.stats = {
            "submit_attempts": 0,
            "batches_accepted": 0,
            "rpc_faults": 0,
            "backpressure_retries": 0,
            "quota_rejects": 0,
            "priced_rejects": 0,
        }

    def exhausted(self) -> bool:
        """Every job handed to the queue and the close signal sent."""
        return (
            not self._queue_in and self._inflight is None and self._close_sent
        )

    def next_due_time(self) -> Optional[float]:
        """The next virtual time this submitter needs the clock to reach
        (next arrival, or a backpressure retry)."""
        if self._inflight is not None:
            return self._inflight[3]
        if self._queue_in:
            return self._queue_in[0][0]
        return None

    def _next_batch(self, now: float) -> Optional[tuple]:
        """Caller ensured no batch is in flight. Collect due arrivals
        into one batch under a fresh token."""
        if not self._queue_in or self._queue_in[0][0] > now:
            return None
        batch, arrival = [], self._queue_in[0][0]
        # Batches never mix tenants: a QUOTA rejection is batch-
        # granular (the token ledger is), so one over-quota tenant in
        # a mixed batch would shed compliant tenants' jobs with it.
        tenant = str(getattr(self._queue_in[0][1], "tenant", "") or "")
        while (
            self._queue_in
            and self._queue_in[0][0] <= now
            and len(batch) < self.batch_size
            and str(getattr(self._queue_in[0][1], "tenant", "") or "")
            == tenant
        ):
            _, job = self._queue_in.popleft()
            batch.append(job)
        token = f"{self._token_prefix}-{self._seq:06d}"
        self._seq += 1
        return (token, batch, arrival, now)

    def pump(
        self, queue: AdmissionQueue, now: float
    ) -> List[Tuple[str, Job, float]]:
        """Advance the submitter to virtual time ``now``: submit every
        due batch (with fault-injected retries and backpressure
        honored), send close when the trace is exhausted, and return
        ``queue.drain(now=now)`` — the jobs the scheduler should admit
        this iteration, as (token, job, arrival_time) tuples."""
        from shockwave_tpu_torch.runtime import faults

        while True:
            if self._inflight is None:
                self._inflight = self._next_batch(now)
                if self._inflight is None:
                    break
            token, batch, arrival, not_before = self._inflight
            if not_before > now:
                break  # backpressure delay still running
            self.stats["submit_attempts"] += 1
            try:
                # Pre-send faults (rpc_error/rpc_delay): the request
                # never reaches the queue; the retry re-sends the same
                # token. Injected delays are virtual here (the sim owns
                # the clock), so they only count, not sleep.
                faults.check_rpc(
                    "SubmitJobs", kinds=("rpc_error", "rpc_delay"),
                    sleep=lambda s: None,
                )
                status, retry_after, _ = queue.submit(
                    token, batch, now=now
                )
                # Post-send faults (rpc_drop): the queue DID record the
                # token but the response is lost — the retry must be
                # deduplicated by the ledger.
                faults.check_rpc("SubmitJobs", kinds=("rpc_drop",))
                faults.note_rpc_success("SubmitJobs")
            except faults.InjectedRpcError:
                self.stats["rpc_faults"] += 1
                continue  # immediate retry, same token
            if status == STATUS_RETRY_AFTER:
                self.stats["backpressure_retries"] += 1
                self._inflight = (token, batch, arrival, now + retry_after)
                break
            if status == STATUS_QUOTA:
                # Hard policy rejection: the batch's tenant is over its
                # pending quota. Retrying the same batch would spin —
                # the jobs are shed (counted, never silently).
                self.stats["quota_rejects"] += 1
                self._inflight = None
                continue
            if status == STATUS_PRICED:
                # Marginal-price rejection: same shed-don't-spin
                # semantics as QUOTA (re-pricing the identical batch
                # yields the identical externality).
                self.stats["priced_rejects"] += 1
                self._inflight = None
                continue
            # ACCEPTED (fresh or deduplicated): stamp each job's true
            # arrival time for JCT accounting, then move on.
            for job in batch:
                job.arrival_time = arrival
            self.stats["batches_accepted"] += 1
            self._inflight = None
        if (
            not self._queue_in
            and self._inflight is None
            and not self._close_sent
        ):
            queue.close(token=f"{self._token_prefix}-close")
            self._close_sent = True
        return queue.drain(now=now)
