"""Mergeable relative-error quantile sketches (DDSketch-style).

The fixed-bucket histogram in :mod:`shockwave_tpu_torch.obs.metrics` answers
"how many observations fell under each boundary" cheaply, but its
quantiles are interpolations whose error is whatever the bucket table
happens to be — useless for a p99 SLO gate, and two processes' tables
cannot be combined into an exact fleet quantile. This module supplies
the scale-proof primitive underneath the telemetry plane:

:class:`QuantileSketch` bins each observation into logarithmically
spaced buckets index = ceil(log_gamma(value)) with
gamma = (1 + alpha) / (1 - alpha), which guarantees every quantile
estimate is within a RELATIVE error ``alpha`` of the true value
(default 1%), using O(log(max/min)/alpha) integer counters regardless
of how many observations arrive. Two sketches with the same ``alpha``
merge by adding counters — the merge is EXACT (the merged sketch is
bit-identical to having observed both streams in one process), which
is what lets the scheduler combine per-worker sketches into true
fleet-wide quantiles instead of concatenating text dumps.

Negative observations (the calibration plane's signed forecast error)
get a mirrored store; exact zeros get a dedicated counter. Memory is
hard-bounded: past ``max_bins`` per store the LOWEST bins collapse
into one (DDSketch's standard policy — accuracy degrades only at the
cheap end of the distribution, never at the p99 tail the watchdog
reads).

Serialization: :meth:`to_dict`/:meth:`from_dict` round-trip through
the JSON metrics snapshot, and :func:`encode_snapshot_frame` /
:func:`decode_snapshot_frame` wrap a whole registry snapshot into the
compact binary frame workers push over the coalesced-heartbeat path
(magic ``SKF1`` + zlib-compressed JSON — stdlib only, versioned, and
forward-compatible because unknown snapshot keys pass through).
"""

from __future__ import annotations

import json
import math
import zlib
from typing import Dict, Optional

DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BINS = 1024

# Values with |v| below this are counted as zero: log-binning cannot
# represent 0 and float dust below it carries no scheduling signal.
_MIN_TRACKABLE = 1e-12

FRAME_MAGIC = b"SKF1"


class QuantileSketch:
    """DDSketch-style mergeable quantile sketch.

    Not thread-safe on its own: the metrics registry mutates it under
    its lock, exactly like the bucket tables it rides next to.
    """

    __slots__ = (
        "alpha", "max_bins", "_gamma", "_log_gamma",
        "count", "sum", "min", "max",
        "zero_count", "_pos", "_neg",
    )

    def __init__(
        self,
        alpha: float = DEFAULT_ALPHA,
        max_bins: int = DEFAULT_MAX_BINS,
    ):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self.max_bins = max(8, int(max_bins))
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self._gamma)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.zero_count = 0
        self._pos: Dict[int, int] = {}
        self._neg: Dict[int, int] = {}

    # -- ingest ---------------------------------------------------------
    def _key(self, magnitude: float) -> int:
        return int(math.ceil(math.log(magnitude) / self._log_gamma))

    def add(self, value: float, count: int = 1) -> None:
        value = float(value)
        self.count += count
        self.sum += value * count
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        if abs(value) < _MIN_TRACKABLE:
            self.zero_count += count
            return
        store = self._pos if value > 0 else self._neg
        key = self._key(abs(value))
        store[key] = store.get(key, 0) + count
        if len(store) > self.max_bins:
            self._collapse(store)

    def add_many(self, values) -> None:
        """Vectorized :meth:`add` for a numpy array (or any sequence):
        one log/ceil pass and a unique-count fold instead of per-value
        Python arithmetic — the admission drain's batch path."""
        try:
            import numpy as np
        except ImportError:
            for v in values:
                self.add(float(v))
            return
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        lo, hi = float(arr.min()), float(arr.max())
        if self.min is None or lo < self.min:
            self.min = lo
        if self.max is None or hi > self.max:
            self.max = hi
        mags = np.abs(arr)
        zero = mags < _MIN_TRACKABLE
        self.zero_count += int(zero.sum())
        for store, mask in (
            (self._pos, (arr > 0) & ~zero),
            (self._neg, (arr < 0) & ~zero),
        ):
            if not mask.any():
                continue
            keys = np.ceil(
                np.log(mags[mask]) / self._log_gamma
            ).astype(np.int64)
            uniq, counts = np.unique(keys, return_counts=True)
            for k, c in zip(uniq.tolist(), counts.tolist()):
                store[k] = store.get(k, 0) + int(c)
            if len(store) > self.max_bins:
                self._collapse(store)

    def _collapse(self, store: Dict[int, int]) -> None:
        """Fold the lowest-key bins together until the store fits: the
        cheap end of the distribution loses resolution, the tail the
        SLO rules read keeps its alpha guarantee."""
        while len(store) > self.max_bins:
            keys = sorted(store)
            lowest, second = keys[0], keys[1]
            store[second] = store.get(second, 0) + store.pop(lowest)

    # -- merge ----------------------------------------------------------
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (exact; same-alpha sketches only)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {other.alpha} "
                f"into alpha {self.alpha}"
            )
        self.count += other.count
        self.sum += other.sum
        for bound, pick in (("min", min), ("max", max)):
            theirs = getattr(other, bound)
            ours = getattr(self, bound)
            if theirs is not None:
                setattr(
                    self, bound,
                    theirs if ours is None else pick(ours, theirs),
                )
        self.zero_count += other.zero_count
        for store, theirs in (
            (self._pos, other._pos), (self._neg, other._neg)
        ):
            for key, cnt in theirs.items():
                store[key] = store.get(key, 0) + cnt
            if len(store) > self.max_bins:
                self._collapse(store)
        return self

    def copy(self) -> "QuantileSketch":
        dup = QuantileSketch(self.alpha, self.max_bins)
        dup.count = self.count
        dup.sum = self.sum
        dup.min = self.min
        dup.max = self.max
        dup.zero_count = self.zero_count
        dup._pos = dict(self._pos)
        dup._neg = dict(self._neg)
        return dup

    # -- quantiles ------------------------------------------------------
    def _bin_value(self, key: int) -> float:
        # The representative value of bin ``key`` — the geometric
        # midpoint 2*gamma^key/(gamma+1), which is within alpha of
        # every value the bin can hold.
        return 2.0 * self._gamma ** key / (self._gamma + 1.0)

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1], within relative error
        ``alpha`` (clamped into [min, max]); ``None`` while empty."""
        if self.count <= 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        # rank in [1, count]; walk negatives (most negative first),
        # then zeros, then positives ascending.
        rank = max(1, int(math.ceil(q * self.count)))
        running = 0
        for key in sorted(self._neg, reverse=True):
            running += self._neg[key]
            if running >= rank:
                value = -self._bin_value(key)
                return self._clamp(value)
        running += self.zero_count
        if running >= rank:
            return self._clamp(0.0)
        for key in sorted(self._pos):
            running += self._pos[key]
            if running >= rank:
                return self._clamp(self._bin_value(key))
        return self.max

    def _clamp(self, value: float) -> float:
        if self.min is not None and value < self.min:
            return self.min
        if self.max is not None and value > self.max:
            return self.max
        return value

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe snapshot (bin keys/counts as parallel lists: JSON
        objects cannot carry integer keys)."""
        out = {
            "alpha": self.alpha,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "zero": self.zero_count,
        }
        if self._pos:
            keys = sorted(self._pos)
            out["pos"] = [keys, [self._pos[k] for k in keys]]
        if self._neg:
            keys = sorted(self._neg)
            out["neg"] = [keys, [self._neg[k] for k in keys]]
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "QuantileSketch":
        sk = cls(alpha=float(data.get("alpha", DEFAULT_ALPHA)))
        sk.count = int(data.get("count", 0))
        sk.sum = float(data.get("sum", 0.0))
        sk.min = data.get("min")
        sk.max = data.get("max")
        if sk.min is not None:
            sk.min = float(sk.min)
        if sk.max is not None:
            sk.max = float(sk.max)
        sk.zero_count = int(data.get("zero", 0))
        for field, store in (("pos", sk._pos), ("neg", sk._neg)):
            pair = data.get(field)
            if pair:
                for key, cnt in zip(pair[0], pair[1]):
                    store[int(key)] = int(cnt)
        return sk


def merge_sketch_dicts(dicts) -> Optional[QuantileSketch]:
    """Merge serialized sketches (snapshot ``"sketch"`` entries) into
    one live sketch; ``None`` when nothing mergeable was passed."""
    merged: Optional[QuantileSketch] = None
    for data in dicts:
        if not data:
            continue
        sk = QuantileSketch.from_dict(data)
        if merged is None:
            merged = sk
        else:
            merged.merge(sk)
    return merged


# -- registry snapshot frames (the heartbeat wire payload) ---------------
def encode_snapshot_frame(snapshot: dict) -> bytes:
    """Registry snapshot -> compact binary frame: ``SKF1`` magic +
    zlib-compressed JSON. Workers push this over the coalesced
    heartbeat instead of rendered Prometheus text; the scheduler
    decodes and MERGES (sketches add, counters sum) instead of
    concatenating, so fleet scrape cost stops scaling with job count."""
    payload = json.dumps(snapshot, separators=(",", ":")).encode("utf-8")
    return FRAME_MAGIC + zlib.compress(payload, 6)


def decode_snapshot_frame(frame: bytes) -> Optional[dict]:
    """Inverse of :func:`encode_snapshot_frame`; ``None`` on anything
    that is not a well-formed frame (a truncated push must degrade to
    "no data", never crash the heartbeat handler)."""
    if not frame or not frame.startswith(FRAME_MAGIC):
        return None
    try:
        payload = zlib.decompress(bytes(frame[len(FRAME_MAGIC):]))
        snapshot = json.loads(payload.decode("utf-8"))
    except (zlib.error, ValueError, UnicodeDecodeError):
        return None
    return snapshot if isinstance(snapshot, dict) else None
