"""Fleet telemetry plane: clock-offset estimation, worker-registry
merging, and the live scrape endpoint.

Three pieces the scheduler composes into a fleet-wide view of a
multi-process cluster:

  * :class:`ClockEstimator` — rolling best (min-RTT) NTP-style clock
    offset from the samples the register/heartbeat exchange produces
    (:mod:`shockwave_tpu_torch.runtime.rpc.worker_client`). The worker agent
    keeps one per scheduler and reports its estimate back on every
    heartbeat; the scheduler exports it as the per-worker
    ``worker_clock_offset_seconds`` gauge the ``clock_skew`` watchdog
    rule and ``merge_traces.py`` consume.
  * :class:`FleetTelemetry` — a periodic DumpMetrics pull over every
    registered worker agent, each dump's Prometheus exposition text
    re-labeled under ``worker="<id>"`` and merged with the scheduler's
    own registry into ONE fleet rendering.
  * The scrape plane — a stdlib ``http.server`` endpoint serving
    ``/metrics`` (the fleet rendering, Prometheus-scrapable) and
    ``/healthz`` (JSON backed by the watchdog's ``scheduler_health``
    gauge; 503 while degraded).

Everything is disabled-by-default: nothing starts unless the scheduler
is constructed with a metrics port (``SHOCKWAVE_METRICS_PORT`` /
``--metrics-port``), and a disabled plane costs one flag check.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from shockwave_tpu_torch.analysis import sanitize

LOG = logging.getLogger("obs.fleet")

DEFAULT_SCRAPE_INTERVAL_S = 5.0


class ClockEstimator:
    """Best-of-window NTP offset estimate.

    Each exchange yields (offset_s, rtt_s); the estimate is the sample
    with the smallest RTT in the rolling window — the classic filter:
    queueing delay only ever inflates RTT and pushes the apparent
    offset around, so the tightest round trip is the most trustworthy.
    """

    def __init__(self, window: int = 16):
        self._lock = sanitize.make_lock("obs.fleet.ClockEstimator._lock")
        self._samples: deque = deque(maxlen=max(1, int(window)))

    def add(self, sample: Optional[Tuple[float, float]]) -> None:
        """Record one (offset_s, rtt_s) sample; ``None`` (legacy peer)
        is ignored."""
        if sample is None:
            return
        offset, rtt = float(sample[0]), float(sample[1])
        if rtt <= 0:
            return
        with self._lock:
            self._samples.append((offset, rtt))

    def best(self) -> Optional[Tuple[float, float]]:
        """(offset_s, rtt_s) of the min-RTT sample in the window, or
        ``None`` before the first valid sample."""
        with self._lock:
            if not self._samples:
                return None
            return min(self._samples, key=lambda s: s[1])

    def offset(self) -> Optional[float]:
        sample = self.best()
        return sample[0] if sample is not None else None


# -- Prometheus exposition-text merging ---------------------------------
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$"
)


def relabel_prometheus_text(text: str, **extra_labels) -> str:
    """Inject ``extra_labels`` into every sample line of a Prometheus
    exposition dump (comments pass through untouched). The fleet merge
    uses it to mark each worker's series with ``worker="<id>"``."""
    if not extra_labels:
        return text
    injected = ",".join(
        f'{k}="{v}"' for k, v in sorted(extra_labels.items())
    )
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            out.append(line)
            continue
        name, labels, value = m.groups()
        merged = f"{labels},{injected}" if labels else injected
        out.append(f"{name}{{{merged}}} {value}")
    return "\n".join(out) + ("\n" if out else "")


def merge_prometheus_texts(texts) -> str:
    """Merge several exposition dumps into one: per metric family the
    ``# HELP``/``# TYPE`` header is emitted once (first writer wins —
    the scheduler's dump comes first) and every sample line is kept.
    Inputs must already be disjoint per label set (the worker label
    guarantees it)."""
    headers: Dict[str, dict] = {}  # family -> {"HELP": line, "TYPE": line}
    families: Dict[str, list] = {}
    order: list = []
    for text in texts:
        current = None
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    current = parts[2]
                    if current not in families:
                        families[current] = []
                        headers[current] = {}
                        order.append(current)
                    # First writer wins per header kind (the scheduler's
                    # dump comes first).
                    headers[current].setdefault(parts[1], line)
                continue
            m = _SAMPLE_RE.match(line)
            name = m.group(1) if m else current
            if name is None:
                continue
            # _bucket/_sum/_count samples belong to their base
            # histogram family when one is declared (_min/_max are
            # their own sibling gauge families with their own TYPE).
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                if family.endswith(suffix) and family[: -len(suffix)] in families:
                    family = family[: -len(suffix)]
                    break
            if family not in families:
                families[family] = []
                headers[family] = {}
                order.append(family)
            families[family].append(line)
    lines = []
    for family in order:
        for kind in ("HELP", "TYPE"):
            if kind in headers[family]:
                lines.append(headers[family][kind])
        lines.extend(families[family])
    return "\n".join(lines) + ("\n" if lines else "")


# -- the fleet plane ----------------------------------------------------
class FleetTelemetry:
    """Periodic DumpMetrics pull + merged rendering + scrape endpoint.

    Targets are ``label -> scrape_fn`` (the scheduler registers one per
    worker agent, the fn being ``SchedulerRpcClient.dump_worker_metrics``);
    a poll thread refreshes every target's dump on an interval, and
    :meth:`render` serves the scheduler's own registry first with every
    worker dump re-labeled and merged after it.
    """

    def __init__(
        self, scrape_interval_s: float = DEFAULT_SCRAPE_INTERVAL_S
    ):
        self._lock = sanitize.make_lock("obs.fleet.FleetTelemetry._lock")
        self._interval_s = max(0.25, float(scrape_interval_s))
        self._targets: Dict[str, Callable[[], str]] = {}
        self._dumps: Dict[str, Tuple[str, float]] = {}
        # label -> (decoded snapshot dict, ts) for binary sketch-frame
        # pushes (merged, not concatenated).
        self._snaps: Dict[str, Tuple[dict, float]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http = None
        self._http_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # -- targets --------------------------------------------------------
    def add_target(self, label: str, scrape_fn: Callable[[], str]) -> None:
        with self._lock:
            self._targets[str(label)] = scrape_fn

    def remove_target(self, label: str) -> None:
        with self._lock:
            self._targets.pop(str(label), None)
            self._dumps.pop(str(label), None)
            self._snaps.pop(str(label), None)

    def num_targets(self) -> int:
        with self._lock:
            return len(self._targets)

    def accept_push(self, label: str, text: str) -> bool:
        """Coalesced push: a worker's heartbeat carried its rendered
        registry, so store it exactly where the pull path would have
        (same dict, same freshness stamp) and let :meth:`poll_once`
        skip that target while the push is younger than the poll
        interval. Unknown labels are dropped — a push can race the
        agent's retirement, and resurrecting a removed target would
        leak a dead worker's series into the merge forever."""
        from shockwave_tpu_torch import obs

        label = str(label)
        with self._lock:
            if label not in self._targets:
                return False
            self._dumps[label] = (str(text), time.time())
        obs.counter(
            "fleet_pushes_total",
            "worker metrics dumps coalesced onto heartbeats",
        ).inc(worker=label)
        return True

    def accept_frame(self, label: str, frame: bytes) -> bool:
        """Binary sketch-frame push: a worker's heartbeat carried its
        registry snapshot as a compressed frame
        (:func:`shockwave_tpu_torch.obs.sketch.encode_snapshot_frame`). The
        scheduler MERGES these snapshots (sketches add exactly) instead
        of concatenating text, so the fleet scrape's cost is per label
        set, not per worker. Same retirement guard as
        :meth:`accept_push`: unknown labels are dropped — a push racing
        the agent's retirement must not resurrect a dead worker's
        series. Malformed frames are dropped and counted."""
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.obs.sketch import decode_snapshot_frame

        label = str(label)
        snap = decode_snapshot_frame(frame)
        if snap is None:
            obs.counter(
                "fleet_frame_decode_failures_total",
                "sketch-frame pushes that failed to decode",
            ).inc(worker=label)
            return False
        with self._lock:
            if label not in self._targets:
                return False
            self._snaps[label] = (snap, time.time())
        obs.counter(
            "fleet_frame_pushes_total",
            "binary sketch-frame snapshots coalesced onto heartbeats",
        ).inc(worker=label)
        return True

    # -- polling --------------------------------------------------------
    def poll_once(self) -> int:
        """Scrape every target now; returns how many answered (pushed
        counts as answered). Targets whose dump is younger than the
        poll interval — a heartbeat-coalesced push landed since the
        last tick — are skipped: the wire already carried their data.
        Failures are counted and logged at debug (a dead worker's
        reaper, not the telemetry plane, is the authority on its
        death)."""
        from shockwave_tpu_torch import obs

        now = time.time()
        with self._lock:
            targets = dict(self._targets)
            fresh = {
                label
                for label, (_, ts) in self._dumps.items()
                if now - ts < self._interval_s
            }
            fresh |= {
                label
                for label, (_, ts) in self._snaps.items()
                if now - ts < self._interval_s
            }
        answered = len(targets.keys() & fresh)
        for label, scrape_fn in targets.items():
            if label in fresh:
                continue
            try:
                text = scrape_fn()
            except Exception:
                LOG.debug("fleet scrape of %s failed", label, exc_info=True)
                obs.counter(
                    "fleet_scrape_failures_total",
                    "worker DumpMetrics pulls that failed",
                ).inc(worker=label)
                continue
            answered += 1
            with self._lock:
                if label in self._targets:  # racing remove_target
                    self._dumps[label] = (text, time.time())
            obs.counter(
                "fleet_scrapes_total", "worker DumpMetrics pulls"
            ).inc(worker=label)
        return answered

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.poll_once()

    # -- rendering ------------------------------------------------------
    def render(self) -> str:
        """The fleet ``/metrics`` payload: the scheduler's registry,
        every legacy text dump under its ``worker`` label, and — for
        workers that push binary sketch frames — per-worker
        counter/gauge series plus fleet-MERGED histogram families
        (``scope="fleet"``: counts/sums/buckets summed, sketches merged
        exactly), so histogram scrape cost stays per label set however
        many workers push."""
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.obs.metrics import (
            merge_snapshots,
            render_snapshot_text,
        )

        with self._lock:
            dumps = dict(self._dumps)
            snaps = dict(self._snaps)
        texts = [obs.render_prometheus()]
        hist_snaps = []
        for label in sorted(snaps):
            snap, _ = snaps[label]
            metrics = snap.get("metrics", {})
            values = {
                name: m
                for name, m in metrics.items()
                if m.get("type") != "histogram"
            }
            if values:
                texts.append(
                    render_snapshot_text(
                        {"metrics": values}, extra_labels={"worker": label}
                    )
                )
            hists = {
                name: m
                for name, m in metrics.items()
                if m.get("type") == "histogram"
            }
            if hists:
                hist_snaps.append({"metrics": hists})
        if hist_snaps:
            texts.append(
                render_snapshot_text(
                    merge_snapshots(hist_snaps),
                    extra_labels={"scope": "fleet"},
                )
            )
        for label in sorted(dumps):
            text, _ = dumps[label]
            texts.append(relabel_prometheus_text(text, worker=label))
        return merge_prometheus_texts(texts)

    def merged_snapshot(self) -> dict:
        """ONE fleet-level metrics snapshot: the scheduler's registry
        merged with every pushed worker snapshot (counters/gauges sum,
        histogram sketches merge exactly). The first exact fleet-wide
        quantiles — what :meth:`healthz` and the obs-scale gate read."""
        from shockwave_tpu_torch import obs
        from shockwave_tpu_torch.obs.metrics import merge_snapshots

        with self._lock:
            snaps = [snap for snap, _ in self._snaps.values()]
        return merge_snapshots(
            [obs.get_registry().snapshot()] + snaps
        )

    def healthz(self) -> Tuple[int, dict]:
        """(HTTP status, JSON body) for ``/healthz``, backed by the
        watchdog's ``scheduler_health`` gauge: 200 while every rule is
        quiet (or the watchdog is off), 503 on a degraded scheduler."""
        from shockwave_tpu_torch import obs

        watchdog = obs.get_watchdog()
        body = {"status": "ok", "watchdog_enabled": watchdog.enabled}
        with self._lock:
            body["workers_scraped"] = len(self._dumps)
            ages = [time.time() - ts for _, ts in self._dumps.values()]
        if ages:
            body["oldest_scrape_age_s"] = round(max(ages), 3)
        with self._lock:
            body["workers_pushing_frames"] = len(self._snaps)
        code = 200
        # Ingest latency percentiles (when the admission front door has
        # observed any queue latency): the live numbers an operator
        # checks against SHOCKWAVE_INGEST_P99_BUDGET_S. Fleet-MERGED
        # sketch frames pushed by workers combine exactly
        # with the scheduler's own registry.
        metrics_snapshot = self.merged_snapshot()["metrics"]
        ingest = metrics_snapshot.get("admission_queue_latency_seconds")
        if ingest and ingest.get("series"):
            from shockwave_tpu_torch.obs.watchdog import Watchdog

            p50, count = Watchdog._histogram_quantile(
                metrics_snapshot, "admission_queue_latency_seconds", 0.5
            )
            p99, _ = Watchdog._histogram_quantile(
                metrics_snapshot, "admission_queue_latency_seconds", 0.99
            )
            if count:
                body["ingest"] = {
                    "admitted_jobs": int(count),
                    "queue_latency_p50_s": p50,
                    "queue_latency_p99_s": p99,
                }
        if watchdog.enabled:
            summary = watchdog.summary()
            body["watchdog"] = summary
            metrics = metrics_snapshot
            gauge = metrics.get("scheduler_health")
            health = None
            if gauge and gauge["series"]:
                health = gauge["series"][0]["value"]
            body["scheduler_health"] = health
            if health == 0.0:
                body["status"] = "degraded"
                code = 503
        return code, body

    # -- lifecycle ------------------------------------------------------
    def start(self, http_port: Optional[int] = None) -> None:
        """Start the poll thread and (when ``http_port`` is not None)
        the scrape endpoint; ``http_port=0`` binds an ephemeral port —
        read it back from :attr:`port`."""
        with self._lock:
            already = self._thread is not None
        if not already:
            thread = threading.Thread(
                target=self._poll_loop, name="fleet-telemetry", daemon=True
            )
            with self._lock:
                self._thread = thread
            thread.start()
        if http_port is not None:
            self._start_http(int(http_port))

    def _start_http(self, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        fleet = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                try:
                    if self.path.split("?")[0] == "/metrics":
                        payload = fleet.render().encode("utf-8")
                        code = 200
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif self.path.split("?")[0] == "/healthz":
                        code, body = fleet.healthz()
                        payload = (json.dumps(body) + "\n").encode("utf-8")
                        ctype = "application/json"
                    else:
                        code, payload = 404, b"not found\n"
                        ctype = "text/plain"
                except Exception:
                    LOG.exception("scrape endpoint handler failed")
                    code, payload = 500, b"internal error\n"
                    ctype = "text/plain"
                # gzip when the scraper advertises it: a large fleet's
                # exposition text compresses ~10x, and the encode
                # happens on the HTTP thread — never under the
                # registry lock.
                encoding = None
                accept = self.headers.get("Accept-Encoding", "")
                if code == 200 and "gzip" in accept.lower():
                    import gzip as _gzip

                    payload = _gzip.compress(payload, 6)
                    encoding = "gzip"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                if encoding:
                    self.send_header("Content-Encoding", encoding)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, format, *args):  # noqa: A002
                LOG.debug("scrape endpoint: " + format, *args)

        with self._lock:
            if self._http is not None:
                return
        http = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        http.daemon_threads = True
        http_thread = threading.Thread(
            target=http.serve_forever, name="fleet-scrape-http", daemon=True
        )
        with self._lock:
            self._http = http
            self._http_thread = http_thread
            self.port = http.server_address[1]
        http_thread.start()
        LOG.info("fleet scrape endpoint on :%d (/metrics, /healthz)",
                 self.port)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            http = self._http
            self._http = None
            thread = self._thread
            self._thread = None
        if http is not None:
            http.shutdown()
            http.server_close()
        if thread is not None:
            thread.join(timeout=2.0)
