"""Process-local metrics registry: counters, gauges, histograms.

Zero-dependency and lock-guarded so every layer — scheduler core,
policies, solver backends, dispatcher, workers, RPC servers — can
publish into one registry from any thread. Instruments are cheap
namespaced handles; when the registry is disabled every mutating call
is a single attribute check and an early return, so instrumented code
paths cost nothing measurable (benchmark results untouched).

Snapshot schema (``MetricsRegistry.snapshot``), also what
``dump``/``scripts/analysis/report_run.py`` consume::

    {"schema": "shockwave-metrics-v1",
     "metrics": {name: {"type": "counter"|"gauge"|"histogram",
                        "help": str,
                        "series": [{"labels": {...}, ...values...}]}},
     "history": {name: {"samples", "raw", "coarse"}},    # when tracked
     "exemplars": {name: {"k", "offered", "entries"}}}   # when present

Counters/gauges carry ``{"value": float}`` per series; histograms carry
``{"count", "sum", "min", "max", "buckets", "sketch"}`` where
``buckets`` maps a Prometheus ``le`` boundary (string, including
``"+Inf"``) to the CUMULATIVE observation count at that boundary and
``sketch`` is the serialized DDSketch-style quantile sketch
(:mod:`shockwave_tpu_torch.obs.sketch`) every histogram series ALSO feeds —
the mergeable, guaranteed-relative-error backend the watchdog's p99
rules and the fleet merge read; the fixed ``le`` table stays for
Prometheus scrape compatibility. ``render_text`` emits the data in the
Prometheus exposition format (the ``/metrics`` dump RPC's wire
payload), with proper ``_bucket{le=...}`` series so dumps load into
real Prometheus tooling unchanged.

Scale safety: every family lives under a CARDINALITY GOVERNOR
— at the per-family series budget (``SHOCKWAVE_METRICS_MAX_SERIES``,
default 256) new label sets collapse into one ``overflow="true"``
aggregate series, every such collapse counts into the loud
``metrics_series_dropped_total{metric}`` family, and the per-round
governor tick (:meth:`MetricsRegistry.scale_tick`) decays per-series
activity and folds idle series at budget so the retained set tracks
the top-k most ACTIVE label sets. A producer that labels by ``job_id``
can therefore never OOM the registry, no matter the campaign size.
"""

from __future__ import annotations

import bisect
import os
from typing import Dict, Optional, Sequence, Tuple

from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.obs.history import ExemplarReservoir, RingHistory
from shockwave_tpu_torch.obs.sketch import (
    DEFAULT_ALPHA,
    QuantileSketch,
    merge_sketch_dicts,
)

SCHEMA = "shockwave-metrics-v1"

# Latency-oriented log-ish boundaries wide enough to also bin epoch/JCT
# durations (seconds) and small ratios (FTF); +Inf is implicit.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
    1800.0, 3600.0, 14400.0, 86400.0,
)

# Per-family live-series ceiling (the cardinality governor). Inclusive
# of the overflow aggregate: a family NEVER holds more than this many
# series, whatever a producer labels.
DEFAULT_MAX_SERIES = 256

# The reserved label-set new series collapse into at budget.
OVERFLOW_LABELS = {"overflow": "true"}
_OVERFLOW_KEY = (("overflow", "true"),)

DROPPED_FAMILY = "metrics_series_dropped_total"
_DROPPED_HELP = (
    "label sets collapsed into the overflow series by the cardinality "
    "governor (per metric family)"
)

# Families the ring-buffer history samples by default each scale_tick;
# mode "value" sums gauge/counter series, mode "p99" reads the merged
# sketch p99. Drivers can extend via MetricsRegistry.track_history.
DEFAULT_HISTORY: Tuple[Tuple[str, str], ...] = (
    ("scheduler_queue_depth", "value"),
    ("scheduler_health", "value"),
    ("market_price", "value"),
    ("market_fairness_drift", "value"),
    ("predictor_calibration_mape", "value"),
    ("scheduler_round_duration_seconds", "p99"),
    ("shockwave_solve_seconds", "p99"),
    ("admission_queue_latency_seconds", "p99"),
    ("cells_cell_solve_seconds", "p99"),
)


def _fmt_le(bound: float) -> str:
    """Prometheus ``le`` label text: integral bounds render Go-style
    ("1.0", not "1") so round-trips through real Prometheus scrapers
    keep the same series identity."""
    return str(float(bound))


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def quantile_from_buckets(buckets, q, observed_max=None):
    """Upper-bound quantile estimate from a histogram's CUMULATIVE
    ``{le_str: count}`` buckets (snapshot schema, ``"+Inf"`` included):
    the smallest finite bucket bound whose cumulative count covers the
    quantile; observations past the last finite bound resolve to
    ``observed_max`` (the snapshot's ``max``), or to ``None`` when no
    max is known. Returns ``(value, count)`` — ``(None, 0)`` for an
    empty histogram. Kept as the FALLBACK quantile for snapshots that
    predate the sketch backend; live consumers prefer
    :func:`merged_histogram_quantile`."""
    if not buckets:
        return None, 0
    count = max(buckets.values())
    if count <= 0:
        return None, 0
    need = q * count
    finite = sorted(
        (float(le), cum)
        for le, cum in buckets.items()
        if le not in ("+Inf", "inf")
    )
    for bound, cum in finite:
        if cum >= need:
            return bound, count
    return observed_max, count


def series_quantile(series: dict, q: float):
    """Quantile of ONE snapshot histogram series: the sketch when the
    snapshot carries one (guaranteed relative error), else the bucket
    interpolation (pre-sketch dumps). Returns (value, count)."""
    sketch = series.get("sketch")
    if sketch:
        sk = QuantileSketch.from_dict(sketch)
        if sk.count > 0:
            return sk.quantile(q), sk.count
    return quantile_from_buckets(
        series.get("buckets") or {}, q, series.get("max")
    )


def merged_histogram_quantile(metric: Optional[dict], q: float):
    """Quantile over EVERY label series of one snapshot histogram
    family. When every series carries a sketch the merge is exact
    (sketches add) and the estimate has the sketch's relative-error
    guarantee; otherwise falls back to summed cumulative buckets
    (:func:`quantile_from_buckets`). Returns (value, count)."""
    if not metric or not metric.get("series"):
        return None, 0
    series = metric["series"]
    sketches = [s.get("sketch") for s in series]
    if all(sketches):
        merged = merge_sketch_dicts(sketches)
        if merged is not None and merged.count > 0:
            return merged.quantile(q), merged.count
        return None, 0
    count = 0
    merged_buckets: Dict[str, int] = {}
    maxes = []
    for s in series:
        count += s.get("count", 0)
        if s.get("max") is not None:
            maxes.append(s["max"])
        for le, cum in (s.get("buckets") or {}).items():
            merged_buckets[le] = merged_buckets.get(le, 0) + cum
    if count <= 0 or not merged_buckets:
        return None, count
    return quantile_from_buckets(
        merged_buckets, q, max(maxes) if maxes else None
    )


class _Instrument:
    """Shared handle plumbing: one named metric, many label series.

    Series admission runs through the cardinality governor: the
    ``touch`` counter on each series is its activity score, new label
    sets past the family budget collapse into the ``overflow="true"``
    aggregate, and :meth:`_governor_tick` (driven by the registry's
    per-round ``scale_tick``) decays scores and folds idle series at
    budget so retention is top-k-by-activity. All mutators run under
    the registry lock."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._registry = registry
        self.name = name
        self.help = help
        # label-key tuple -> mutable series state
        self._series: Dict[tuple, dict] = {}

    def _make_series(self, labels: dict) -> dict:
        series = self._new_series()
        series["labels"] = dict(labels)
        series["touch"] = 0
        return series

    def _get_series(self, labels: dict) -> dict:
        key = _label_key(labels)
        series = self._series.get(key)
        if series is None:
            budget = self._registry.series_budget()
            if key != _OVERFLOW_KEY and len(self._series) >= budget:
                self._registry._note_dropped(self.name)
                series = self._overflow_series()
            else:
                series = self._make_series(labels)
                self._series[key] = series
        series["touch"] += 1
        return series

    def _overflow_series(self) -> dict:
        series = self._series.get(_OVERFLOW_KEY)
        if series is None:
            series = self._make_series(OVERFLOW_LABELS)
            self._series[_OVERFLOW_KEY] = series
            # The overflow slot itself must not push the family past
            # budget: fold the coldest real series into it.
            if len(self._series) > self._registry.series_budget():
                self._fold_coldest()
        return series

    def _fold_coldest(self) -> None:
        candidates = [k for k in self._series if k != _OVERFLOW_KEY]
        if not candidates:
            return
        coldest = min(
            candidates, key=lambda k: (self._series[k]["touch"], k)
        )
        self._fold_into_overflow(coldest)

    def _fold_into_overflow(self, key: tuple) -> None:
        src = self._series.pop(key, None)
        if src is None:
            return
        self._registry._note_dropped(self.name)
        dst = self._overflow_series()
        self._merge_series(dst, src)

    def _governor_tick(self) -> None:
        """Decay activity scores; at budget, fold series idle for two
        consecutive ticks so new hot label sets can claim slots."""
        at_budget = len(self._series) >= self._registry.series_budget()
        if at_budget:
            idle = [
                k
                for k, s in self._series.items()
                if k != _OVERFLOW_KEY and s["touch"] == 0
            ]
            for key in idle:
                self._fold_into_overflow(key)
        for key, series in self._series.items():
            if key != _OVERFLOW_KEY:
                series["touch"] //= 2

    def _merge_series(self, dst: dict, src: dict) -> None:
        raise NotImplementedError

    def remove(self, **labels) -> None:
        """Drop one label series (a retired worker or completed cell
        must not serve a frozen value forever). Uniform across
        counters, gauges, histograms, and their sketches."""
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            self._series.pop(_label_key(labels), None)

    def _remove_matching(self, labels: dict) -> int:
        """Drop every series whose label dict contains ``labels`` as a
        subset. Caller holds the registry lock."""
        doomed = [
            key
            for key, series in self._series.items()
            if all(
                series["labels"].get(k) == v for k, v in labels.items()
            )
        ]
        for key in doomed:
            del self._series[key]
        return len(doomed)

    def _new_series(self) -> dict:
        raise NotImplementedError

    def _raw_series(self) -> list:
        """Cheap structural copies of every series, taken UNDER the
        registry lock; :meth:`_finalize_series` formats them outside
        it (the two-phase snapshot that keeps large scrapes from
        stalling the round loop's counters)."""
        raise NotImplementedError

    def _finalize_series(self, raw: list) -> list:
        return raw

    def snapshot_series(self) -> list:
        return self._finalize_series(self._raw_series())


class _ValueInstrument(_Instrument):
    def _new_series(self) -> dict:
        return {"value": 0.0}

    def _merge_series(self, dst: dict, src: dict) -> None:
        dst["value"] += src["value"]
        dst["touch"] += src["touch"]

    def _raw_series(self) -> list:
        return [
            {"labels": dict(s["labels"]), "value": s["value"]}
            for s in self._series.values()
        ]


class Counter(_ValueInstrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            self._get_series(labels)["value"] += amount


class Gauge(_ValueInstrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            self._get_series(labels)["value"] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            self._get_series(labels)["value"] += amount


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(registry, name, help)
        self._bounds = tuple(
            sorted(float(b) for b in (buckets or DEFAULT_BUCKETS))
        )
        self._alpha = registry.sketch_alpha

    def _new_series(self) -> dict:
        # "buckets" holds NON-cumulative per-bound counts (one slot per
        # finite bound; observations above the last bound only land in
        # "count", which is the +Inf bucket). Snapshots cumulate. The
        # sketch sees every observation too: the le table is the
        # Prometheus-compatible render, the sketch is the quantile
        # truth (mergeable, alpha relative error).
        return {
            "count": 0,
            "sum": 0.0,
            "min": None,
            "max": None,
            "buckets": [0] * len(self._bounds),
            "sketch": QuantileSketch(self._alpha),
        }

    def _merge_series(self, dst: dict, src: dict) -> None:
        dst["count"] += src["count"]
        dst["sum"] += src["sum"]
        for stat, pick in (("min", min), ("max", max)):
            if src[stat] is not None:
                dst[stat] = (
                    src[stat]
                    if dst[stat] is None
                    else pick(dst[stat], src[stat])
                )
        for i, c in enumerate(src["buckets"]):
            dst["buckets"][i] += c
        dst["sketch"].merge(src["sketch"])
        dst["touch"] += src["touch"]

    def observe(self, value: float, **labels) -> None:
        registry = self._registry
        if not registry.enabled:
            return
        value = float(value)
        with registry._lock:
            series = self._get_series(labels)
            series["count"] += 1
            series["sum"] += value
            if series["min"] is None or value < series["min"]:
                series["min"] = value
            if series["max"] is None or value > series["max"]:
                series["max"] = value
            # Prometheus le is inclusive: bucket i counts value <= bound.
            idx = bisect.bisect_left(self._bounds, value)
            if idx < len(self._bounds):
                series["buckets"][idx] += 1
            series["sketch"].add(value)

    def observe_many(self, values, **labels) -> None:
        """Vectorized :meth:`observe`: one lock acquisition and one
        ``searchsorted``/``bincount`` pass for a whole batch of
        observations (the admission drain's per-job latency path, where
        a 4k-job tick must not pay 4k ``bisect`` calls under the
        registry lock). numpy is imported lazily so the registry stays
        importable without it; with numpy absent the loop fallback
        keeps the identical bucket math."""
        registry = self._registry
        if not registry.enabled:
            return
        try:
            import numpy as np
        except ImportError:
            for value in values:
                self.observe(value, **labels)
            return
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        # side="left" reproduces bisect_left: bucket i counts
        # value <= bound (Prometheus-inclusive le).
        idx = np.searchsorted(self._bounds, arr, side="left")
        per_bucket = np.bincount(
            idx[idx < len(self._bounds)], minlength=len(self._bounds)
        )
        lo, hi = float(arr.min()), float(arr.max())
        total = float(arr.sum())
        with registry._lock:
            series = self._get_series(labels)
            series["count"] += int(arr.size)
            series["sum"] += total
            if series["min"] is None or lo < series["min"]:
                series["min"] = lo
            if series["max"] is None or hi > series["max"]:
                series["max"] = hi
            buckets = series["buckets"]
            for i, count in enumerate(per_bucket):
                if count:
                    buckets[i] += int(count)
            series["sketch"].add_many(arr)

    def _cumulative_buckets(self, per_bound, count) -> "Dict[str, int]":
        out = {}
        running = 0
        for bound, c in zip(self._bounds, per_bound):
            running += c
            out[_fmt_le(bound)] = running
        out["+Inf"] = count
        return out

    def _raw_series(self) -> list:
        return [
            {
                "labels": dict(s["labels"]),
                "count": s["count"],
                "sum": s["sum"],
                "min": s["min"],
                "max": s["max"],
                "_per_bound": list(s["buckets"]),
                "_sketch": s["sketch"].copy(),
            }
            for s in self._series.values()
        ]

    def _finalize_series(self, raw: list) -> list:
        out = []
        for s in raw:
            out.append(
                {
                    "labels": s["labels"],
                    "count": s["count"],
                    "sum": s["sum"],
                    "min": s["min"],
                    "max": s["max"],
                    "buckets": self._cumulative_buckets(
                        s["_per_bound"], s["count"]
                    ),
                    "sketch": s["_sketch"].to_dict(),
                }
            )
        return out


class MetricsRegistry:
    """Named instruments + their label series, behind one lock.

    ``counter``/``gauge``/``histogram`` are idempotent per name (the
    Prometheus client idiom), so call sites can fetch by name every
    time instead of threading handles through constructors.

    Scale machinery (all opt-out-free — active whenever the registry
    is enabled, costless when it is not):

      * per-family series budget (:meth:`series_budget`, from
        ``SHOCKWAVE_METRICS_MAX_SERIES``), enforced in every
        instrument's series admission;
      * :meth:`scale_tick` — the per-round maintenance tick schedulers
        call: samples the tracked ring-buffer histories and runs the
        governor's activity decay;
      * :meth:`exemplar` — named top-k worst-offender reservoirs
        (forensic ids surviving rollups), exported in the snapshot's
        ``exemplars`` block;
      * :meth:`remove_series` — label-subset bulk removal (retired
        workers, completed cells).
    """

    def __init__(
        self,
        enabled: bool = False,
        max_series: Optional[int] = None,
        sketch_alpha: Optional[float] = None,
    ):
        self.enabled = enabled
        self._lock = sanitize.make_lock("obs.metrics.MetricsRegistry._lock")
        self._instruments: "Dict[str, _Instrument]" = {}
        self._max_series = max_series
        self.sketch_alpha = (
            float(os.environ.get("SHOCKWAVE_SKETCH_ALPHA", DEFAULT_ALPHA))
            if sketch_alpha is None
            else float(sketch_alpha)
        )
        # family -> label sets collapsed into overflow (the loud part
        # of the governor; surfaces as metrics_series_dropped_total).
        self._dropped: Dict[str, int] = {}
        # tracked ring-buffer histories: name -> (mode, RingHistory)
        self._history: Dict[str, tuple] = {}
        self._tracked: Dict[str, str] = dict(DEFAULT_HISTORY)
        # named exemplar reservoirs
        self._exemplars: Dict[str, ExemplarReservoir] = {}
        self._exemplar_help: Dict[str, str] = {}

    def series_budget(self) -> int:
        """Per-family live-series ceiling. The explicit constructor
        override wins; else ``SHOCKWAVE_METRICS_MAX_SERIES`` is read
        per call (only on series admission, never on the hot mutate
        path) so drivers and gates can set it before producers run."""
        if self._max_series is not None:
            return max(2, int(self._max_series))
        try:
            return max(
                2,
                int(
                    os.environ.get(
                        "SHOCKWAVE_METRICS_MAX_SERIES", DEFAULT_MAX_SERIES
                    )
                ),
            )
        except ValueError:
            return DEFAULT_MAX_SERIES

    def set_series_budget(self, max_series: Optional[int]) -> None:
        with self._lock:
            self._max_series = max_series

    def _note_dropped(self, name: str) -> None:
        """Caller holds the lock (series admission / fold path)."""
        self._dropped[name] = self._dropped.get(name, 0) + 1

    def _get(self, cls, name: str, help: str, **kwargs) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(self, name, help, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        """``buckets`` applies only at first registration; later fetches
        by name reuse the existing boundary set."""
        return self._get(Histogram, name, help, buckets=buckets)

    def exemplar(
        self, name: str, help: str = "", k: Optional[int] = None
    ) -> ExemplarReservoir:
        """Named top-k worst-offender reservoir (idempotent per name;
        ``k`` applies at first registration, default from
        ``SHOCKWAVE_OBS_EXEMPLARS``). NOT thread-safe to mutate
        directly — use :meth:`offer_exemplar`."""
        with self._lock:
            res = self._exemplars.get(name)
            if res is None:
                if k is None:
                    try:
                        k = int(os.environ.get("SHOCKWAVE_OBS_EXEMPLARS", 10))
                    except ValueError:
                        k = 10
                res = ExemplarReservoir(k=k)
                self._exemplars[name] = res
                self._exemplar_help[name] = help
            return res

    def offer_exemplar(
        self, name: str, entry_id, score: float, help: str = "", **detail
    ) -> None:
        """Offer one (id, score) to the named reservoir, under the
        registry lock."""
        if not self.enabled:
            return
        res = self.exemplar(name, help)
        with self._lock:
            res.offer(entry_id, score, **detail)

    def remove_series(self, **labels) -> int:
        """Drop EVERY series (all families) whose labels contain the
        given subset — the one call that retires a dead worker's or a
        completed cell's entire footprint, sketches included. Exemplar
        entries whose detail carries a matching field go with them.
        Returns how many series were removed."""
        if not self.enabled or not labels:
            return 0
        with self._lock:
            removed = 0
            for inst in self._instruments.values():
                removed += inst._remove_matching(labels)
            for res in self._exemplars.values():
                doomed = [
                    entry_id
                    for entry_id, (_, detail) in res._entries.items()
                    if any(
                        str(detail.get(k)) == str(v)
                        for k, v in labels.items()
                    )
                ]
                for entry_id in doomed:
                    res.remove(entry_id)
            return removed

    # -- per-round maintenance -----------------------------------------
    def track_history(self, name: str, mode: str = "value") -> None:
        """Add a family to the ring-buffer history sampled by
        :meth:`scale_tick`: mode ``"value"`` sums the family's series
        values (gauges/counters), ``"p99"`` reads the merged-sketch
        p99 of a histogram family."""
        with self._lock:
            self._tracked[name] = mode

    def _ring(self) -> RingHistory:
        env = os.environ

        def _int(name, default):
            try:
                return int(env.get(name, default))
            except ValueError:
                return default

        return RingHistory(
            raw_len=_int("SHOCKWAVE_METRICS_HISTORY_RAW", 256),
            coarse_len=_int("SHOCKWAVE_METRICS_HISTORY_COARSE", 256),
            per_coarse=_int("SHOCKWAVE_METRICS_HISTORY_PER_COARSE", 8),
        )

    def scale_tick(self, now_s: float) -> None:
        """The per-round maintenance tick (schedulers call it from
        their round-observability hook): sample every tracked family
        into its fixed-memory ring, then run the cardinality
        governor's activity decay on every instrument. O(tracked +
        series) — independent of job count."""
        if not self.enabled:
            return
        with self._lock:
            for name, mode in self._tracked.items():
                inst = self._instruments.get(name)
                if inst is None or not inst._series:
                    continue
                if mode == "p99":
                    if inst.kind != "histogram":
                        continue
                    merged = None
                    for s in inst._series.values():
                        sk = s.get("sketch")
                        if sk is None or sk.count == 0:
                            continue
                        merged = (
                            sk.copy() if merged is None
                            else merged.merge(sk)
                        )
                    if merged is None or merged.count == 0:
                        continue
                    value = merged.quantile(0.99)
                else:
                    if inst.kind == "histogram":
                        continue
                    value = sum(
                        s["value"] for s in inst._series.values()
                    )
                entry = self._history.get(name)
                if entry is None:
                    entry = (mode, self._ring())
                    self._history[name] = entry
                entry[1].append(float(now_s), float(value))
            for inst in self._instruments.values():
                inst._governor_tick()

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Two-phase: structural copies under the lock, formatting
        (bucket cumulation, sketch serialization) outside it — a large
        scrape must not stall the round loop's counters."""
        with self._lock:
            raw = [
                (name, inst, inst._raw_series())
                for name, inst in sorted(self._instruments.items())
            ]
            dropped = dict(self._dropped)
            history = {
                name: {"mode": mode, **ring.snapshot()}
                for name, (mode, ring) in self._history.items()
            }
            exemplars = {
                name: {
                    "help": self._exemplar_help.get(name, ""),
                    **res.snapshot(),
                }
                for name, res in self._exemplars.items()
                if len(res)
            }
        metrics = {
            name: {
                "type": inst.kind,
                "help": inst.help,
                "series": inst._finalize_series(raw_series),
            }
            for name, inst, raw_series in raw
        }
        if dropped and DROPPED_FAMILY not in metrics:
            metrics[DROPPED_FAMILY] = {
                "type": "counter",
                "help": _DROPPED_HELP,
                "series": [
                    {"labels": {"metric": name}, "value": float(count)}
                    for name, count in sorted(dropped.items())
                ],
            }
        snap = {"schema": SCHEMA, "metrics": metrics}
        if history:
            snap["history"] = history
        if exemplars:
            snap["exemplars"] = exemplars
        return snap

    def render_text(self) -> str:
        """Prometheus exposition format; see
        :func:`render_snapshot_text`. The snapshot's lock phase copies
        series state only — all string formatting happens outside the
        registry lock."""
        return render_snapshot_text(self.snapshot())

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._dropped.clear()
            self._history.clear()
            self._tracked = dict(DEFAULT_HISTORY)
            self._exemplars.clear()
            self._exemplar_help.clear()


def render_snapshot_text(snap: dict, extra_labels: Optional[dict] = None) -> str:
    """Render a metrics snapshot dict to the Prometheus exposition
    format. Histograms render as proper ``histogram`` families —
    cumulative ``_bucket{le=...}`` series (including ``+Inf``) plus
    ``_sum``/``_count`` — loadable by real Prometheus tooling
    unchanged. The min/max extrema (which the exposition format's
    histogram type has no slot for) are emitted as sibling
    ``<name>_min``/``<name>_max`` gauge families. Sketches and the
    history/exemplars blocks are JSON-snapshot-only (the exposition
    format has no slot for them). ``extra_labels`` go onto every
    sample (the fleet merge stamps ``worker="<id>"`` this way when
    rendering a pushed worker snapshot)."""
    extra = extra_labels or {}

    def fmt_labels(labels: dict, **inline) -> str:
        merged = {**labels, **extra, **inline}
        if not merged:
            return ""
        inner = ",".join(
            f'{k}="{v}"' for k, v in sorted(merged.items())
        )
        return "{" + inner + "}"

    lines = []
    for name, metric in snap.get("metrics", {}).items():
        if metric["help"]:
            lines.append(f"# HELP {name} {metric['help']}")
        lines.append(f"# TYPE {name} {metric['type']}")
        if metric["type"] != "histogram":
            for series in metric["series"]:
                labels = fmt_labels(series["labels"])
                lines.append(f"{name}{labels} {series['value']}")
            continue
        for series in metric["series"]:
            for le, cum in series["buckets"].items():
                bucket_labels = fmt_labels(series["labels"], le=le)
                lines.append(f"{name}_bucket{bucket_labels} {cum}")
            labels = fmt_labels(series["labels"])
            lines.append(f"{name}_sum{labels} {series['sum']}")
            lines.append(f"{name}_count{labels} {series['count']}")
        for stat in ("min", "max"):
            stat_series = [
                s for s in metric["series"] if s[stat] is not None
            ]
            if not stat_series:
                continue
            lines.append(f"# TYPE {name}_{stat} gauge")
            for series in stat_series:
                labels = fmt_labels(series["labels"])
                lines.append(f"{name}_{stat}{labels} {series[stat]}")
    return "\n".join(lines) + "\n"


def merge_snapshots(snapshots) -> dict:
    """Merge several metrics snapshots into ONE fleet-level snapshot:
    per family, series with the same label set combine — counters and
    gauges sum, histograms add counts/sums/buckets and MERGE sketches
    (exact — the result equals one process having observed every
    stream). This is the scheduler-side half of the sketch-frame push
    path: scrape cost becomes O(families x label sets), independent of
    how many workers pushed. History and exemplar blocks are
    per-process forensics and do not merge (first snapshot wins)."""
    merged: dict = {"schema": SCHEMA, "metrics": {}}
    for snap in snapshots:
        if not snap:
            continue
        for block in ("history", "exemplars"):
            if block in snap and block not in merged:
                merged[block] = snap[block]
        for name, metric in snap.get("metrics", {}).items():
            dst = merged["metrics"].get(name)
            if dst is None:
                dst = {
                    "type": metric["type"],
                    "help": metric["help"],
                    "series": [],
                    "_index": {},
                }
                merged["metrics"][name] = dst
            for series in metric.get("series", []):
                key = _label_key(series.get("labels", {}))
                existing = dst["_index"].get(key)
                if existing is None:
                    clone = dict(series)
                    clone["labels"] = dict(series.get("labels", {}))
                    if metric["type"] == "histogram":
                        clone["buckets"] = dict(
                            series.get("buckets") or {}
                        )
                        if series.get("sketch"):
                            clone["sketch"] = dict(series["sketch"])
                    dst["_index"][key] = clone
                    dst["series"].append(clone)
                    continue
                if metric["type"] == "histogram":
                    existing["count"] = existing.get("count", 0) + series.get(
                        "count", 0
                    )
                    existing["sum"] = existing.get("sum", 0.0) + series.get(
                        "sum", 0.0
                    )
                    for stat, pick in (("min", min), ("max", max)):
                        theirs = series.get(stat)
                        if theirs is not None:
                            ours = existing.get(stat)
                            existing[stat] = (
                                theirs if ours is None else pick(ours, theirs)
                            )
                    buckets = existing.setdefault("buckets", {})
                    for le, cum in (series.get("buckets") or {}).items():
                        buckets[le] = buckets.get(le, 0) + cum
                    ours_sk, theirs_sk = (
                        existing.get("sketch"), series.get("sketch")
                    )
                    if ours_sk and theirs_sk:
                        combined = merge_sketch_dicts([ours_sk, theirs_sk])
                        existing["sketch"] = (
                            combined.to_dict() if combined else None
                        )
                    elif theirs_sk and not ours_sk:
                        existing["sketch"] = dict(theirs_sk)
                else:
                    existing["value"] = existing.get(
                        "value", 0.0
                    ) + series.get("value", 0.0)
    for metric in merged["metrics"].values():
        metric.pop("_index", None)
    return merged
