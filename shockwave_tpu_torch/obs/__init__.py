"""Unified telemetry layer: the port's copy of the JAX package's
``shockwave_tpu/obs``.

One process-local :class:`~shockwave_tpu_torch.obs.metrics.MetricsRegistry`
and one :class:`~shockwave_tpu_torch.obs.trace.EventTracer` serve the
whole process: the scheduler, the planners, the solver backends and the
cells market publish into them through the module-level helpers here.

Telemetry is disabled by default and stays near-free that way:
``counter()``/``gauge()``/``histogram()`` return a shared null
instrument and ``span()`` a shared null context manager after one flag
check, so instrumented paths change no result; no path adds a card
synchronisation or a host read for telemetry, on or off (a backend's
``backend_phases`` splits at the host copy its solve already makes).
Enable with :func:`configure` (what the ``--metrics-out`` /
``--trace-out`` flags do), or with ``SHOCKWAVE_METRICS_OUT`` /
``SHOCKWAVE_TRACE_OUT`` for subprocesses (:func:`configure_from_env`).

The core series every run publishes (what
``scripts/analysis/report_run.py`` reads) are the JAX package's, with its
names and labels: ``scheduler_rounds_total``,
``scheduler_round_duration_seconds``, ``scheduler_jobs_admitted_total``,
``scheduler_jobs_completed_total``, ``scheduler_preemptions_total``,
``scheduler_lease_extensions_total``, ``scheduler_queue_depth``,
``scheduler_job_jct_seconds``, ``scheduler_job_ftf``,
``shockwave_solve_seconds{backend, ok}``,
``shockwave_plan_phase_seconds{phase}`` and
``solver_backend_seconds{backend}``.

Three sibling planes share the disabled-by-default null-object contract:

  * :class:`~shockwave_tpu_torch.obs.recorder.FlightRecorder`: the JSONL
    decision log of every planning round, replayable offline
    (``--decision-log``);
  * :class:`~shockwave_tpu_torch.obs.calibration.CalibrationTracker`:
    online scoring of the predictor's remaining-runtime forecasts (rides
    the metrics plane);
  * :class:`~shockwave_tpu_torch.obs.watchdog.Watchdog`: per-round SLO
    rules over the registry, emitting ``health`` events and the
    ``scheduler_health`` gauge (``--watchdog``).

The live scrape endpoint (``--metrics-port``, :mod:`.fleet`) serves the
physical control plane (``core/physical.py``).
"""

from __future__ import annotations

import os
from typing import Optional

from shockwave_tpu_torch.obs.calibration import CalibrationTracker
from shockwave_tpu_torch.obs.metrics import (  # noqa: F401 (re-exported API)
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SCHEMA,
    merged_histogram_quantile,
    render_snapshot_text,
    series_quantile,
)
from shockwave_tpu_torch.obs.sketch import QuantileSketch  # noqa: F401
from shockwave_tpu_torch.obs.recorder import FlightRecorder
from shockwave_tpu_torch.obs.trace import EventTracer
from shockwave_tpu_torch.obs.watchdog import Watchdog

_registry = MetricsRegistry(enabled=False)
_tracer = EventTracer(enabled=False)
_recorder = FlightRecorder(enabled=False)
_calibration = CalibrationTracker(enabled=False)
_watchdog = Watchdog(enabled=False)


class _NullInstrument:
    """No-op counter/gauge/histogram handed out while disabled."""

    __slots__ = ()

    def inc(self, amount=1.0, **labels):
        pass

    def set(self, value, **labels):
        pass

    def observe(self, value, **labels):
        pass

    def observe_many(self, values, **labels):
        pass

    def remove(self, **labels):
        pass

    def offer(self, entry_id, score, **detail):
        pass


_NULL = _NullInstrument()


# -- configuration ------------------------------------------------------
def configure(
    metrics: Optional[bool] = None, trace: Optional[bool] = None
) -> None:
    """Enable/disable the process's telemetry planes; ``None`` leaves a
    plane unchanged."""
    if metrics is not None:
        _registry.enabled = bool(metrics)
    if trace is not None:
        _tracer.enabled = bool(trace)


def configure_from_env(env=None) -> dict:
    """Subprocess contract: SHOCKWAVE_METRICS_OUT / SHOCKWAVE_TRACE_OUT
    name export paths and switch the matching plane on. Returns the
    {"metrics": path|None, "trace": path|None} it found (the caller
    exports there on shutdown)."""
    env = os.environ if env is None else env
    metrics_out = env.get("SHOCKWAVE_METRICS_OUT") or None
    trace_out = env.get("SHOCKWAVE_TRACE_OUT") or None
    configure(
        metrics=True if metrics_out else None,
        trace=True if trace_out else None,
    )
    return {"metrics": metrics_out, "trace": trace_out}


def configure_recorder(path: str) -> None:
    """Point the flight recorder at a JSONL decision-log path and
    enable it (what the ``--decision-log`` driver flag does)."""
    _recorder.configure(path)


def configure_watchdog(rules=None) -> None:
    """Enable the health watchdog. Its rules read the metrics registry,
    so the metrics plane is switched on too (export remains opt-in via
    ``--metrics-out``)."""
    _registry.enabled = True
    _watchdog.configure(rules=rules, enabled=True)


def configure_calibration(enabled: bool = True) -> None:
    _calibration.enabled = enabled
    if enabled:
        _registry.enabled = True


def metrics_enabled() -> bool:
    return _registry.enabled


def trace_enabled() -> bool:
    return _tracer.enabled


def enabled() -> bool:
    return _registry.enabled or _tracer.enabled


def get_registry() -> MetricsRegistry:
    return _registry


def get_tracer() -> EventTracer:
    return _tracer


def get_recorder() -> FlightRecorder:
    return _recorder


def get_calibration() -> CalibrationTracker:
    return _calibration


def get_watchdog() -> Watchdog:
    return _watchdog


def reset() -> None:
    """Tests only: drop all recorded state and disable every plane."""
    _registry.reset()
    _registry.enabled = False
    _tracer.reset()
    _tracer.enabled = False
    _tracer.set_clock(None)
    _recorder.reset()
    _calibration.reset()
    _watchdog.reset()


# -- instrument accessors (fetch-by-name; null when disabled) -----------
def counter(name: str, help: str = ""):
    if not _registry.enabled:
        return _NULL
    return _registry.counter(name, help)


def gauge(name: str, help: str = ""):
    if not _registry.enabled:
        return _NULL
    return _registry.gauge(name, help)


def histogram(name: str, help: str = ""):
    if not _registry.enabled:
        return _NULL
    return _registry.histogram(name, help)


def offer_exemplar(name: str, entry_id, score, help: str = "", **detail):
    """Offer one (id, score) to a named worst-offender reservoir; the
    usual single-flag-check no-op while disabled."""
    if not _registry.enabled:
        return
    _registry.offer_exemplar(name, entry_id, score, help=help, **detail)


def scale_tick(now_s: float) -> None:
    """Per-round telemetry maintenance (ring-buffer history sampling +
    cardinality-governor decay); schedulers call it from their round
    observability hook. No-op while metrics are disabled."""
    if not _registry.enabled:
        return
    _registry.scale_tick(now_s)


def remove_series(**labels) -> int:
    """Drop every series matching the label subset across all families
    (retired worker / completed cell cleanup)."""
    if not _registry.enabled:
        return 0
    return _registry.remove_series(**labels)


# -- tracing shortcuts --------------------------------------------------
def span(name, cat="", pid="scheduler", tid="main", args=None):
    return _tracer.span(name, cat=cat, pid=pid, tid=tid, args=args)


def complete(name, ts_s, dur_s, cat="", pid="scheduler", tid="main", args=None):
    _tracer.complete(
        name, ts_s, dur_s, cat=cat, pid=pid, tid=tid, args=args
    )


def instant(name, cat="", pid="scheduler", tid="main", args=None, ts_s=None):
    _tracer.instant(name, cat=cat, pid=pid, tid=tid, args=args, ts_s=ts_s)


def set_trace_clock(clock) -> None:
    _tracer.set_clock(clock)


# -- solver backend timing ----------------------------------------------
_BACKEND_PHASE_HELP = (
    "per-backend phase wall time (device solve vs host polish/placement "
    "tail)"
)
_BACKEND_TOTAL_HELP = "end-to-end backend solve wall time"


class _NullBackendPhases:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def phase(self, name):
        pass


_NULL_BACKEND_PHASES = _NullBackendPhases()


class _BackendPhases:
    """One timed backend solve: a trace span on the backend's track, a
    ``solver_backend_phase_seconds{backend, phase}`` observation per
    ``phase()`` checkpoint (the delta since the previous checkpoint),
    and — unless ``total=False`` — the end-to-end
    ``solver_backend_seconds{backend}`` observation on exit."""

    __slots__ = ("_backend", "_num_jobs", "_total", "_span", "_t0", "_last")

    def __init__(self, backend, num_jobs, total):
        self._backend = backend
        self._num_jobs = num_jobs
        self._total = total

    def __enter__(self):
        import time

        self._span = _tracer.span(
            f"solve:{self._backend}", cat="solver", pid="solver",
            tid=self._backend, args={"num_jobs": self._num_jobs},
        )
        self._span.__enter__()
        self._t0 = self._last = time.perf_counter()
        return self

    def phase(self, name):
        import time

        now = time.perf_counter()
        histogram("solver_backend_phase_seconds", _BACKEND_PHASE_HELP).observe(
            now - self._last, backend=self._backend, phase=name
        )
        self._last = now

    def __exit__(self, *exc):
        import time

        self._span.__exit__(*exc)
        if self._total:
            histogram("solver_backend_seconds", _BACKEND_TOTAL_HELP).observe(
                time.perf_counter() - self._t0, backend=self._backend
            )
        return False


def backend_phases(backend: str, num_jobs: int, total: bool = True):
    """Context manager the solver backends wrap their entry points in;
    the shared no-op instance when telemetry is off."""
    if not enabled():
        return _NULL_BACKEND_PHASES
    return _BackendPhases(backend, num_jobs, total)


# -- CLI contract -------------------------------------------------------
def add_telemetry_args(parser) -> None:
    """The shared observability argparse flags every driver exposes
    (underscore spellings accepted as aliases): telemetry exports plus
    the flight recorder and health watchdog."""
    parser.add_argument(
        "--trace-out",
        "--trace_out",
        dest="trace_out",
        type=str,
        default=None,
        help="write a Chrome trace-event JSON timeline of the run here "
        "(loadable in Perfetto / chrome://tracing)",
    )
    parser.add_argument(
        "--metrics-out",
        "--metrics_out",
        dest="metrics_out",
        type=str,
        default=None,
        help="write the metrics-registry snapshot (JSON) here; feed it "
        "to scripts/analysis/report_run.py (also turns on predictor "
        "calibration scoring for Shockwave runs)",
    )
    parser.add_argument(
        "--decision-log",
        "--decision_log",
        dest="decision_log",
        type=str,
        default=None,
        help="append every planning decision (full planner input + "
        "plan) to this JSONL flight-recorder log; replay with "
        "`python -m shockwave_tpu_torch.obs.recorder replay <log>`",
    )
    parser.add_argument(
        "--watchdog",
        action="store_true",
        help="evaluate scheduler-health SLO rules each round and emit "
        "structured health events + the scheduler_health gauge",
    )
    parser.add_argument(
        "--watchdog-config",
        "--watchdog_config",
        dest="watchdog_config",
        type=str,
        default=None,
        help="watchdog rule overrides: a JSON literal or a path to a "
        "JSON file, e.g. '{\"worst_ftf\": {\"threshold\": 1.5}}' "
        "(implies --watchdog)",
    )
    parser.add_argument(
        "--metrics-port",
        "--metrics_port",
        dest="metrics_port",
        type=int,
        default=None,
        help="serve a live Prometheus scrape endpoint on this port "
        "(/metrics = scheduler + fleet-merged worker series, /healthz "
        "= watchdog-backed health JSON); 0 binds an ephemeral port. "
        "Physical mode only; also settable via SHOCKWAVE_METRICS_PORT",
    )


def watchdog_rules_from_args(args):
    """``None`` when the args don't request the watchdog; ``{}`` for the
    default rule set; a dict of per-rule overrides when
    ``--watchdog-config`` names a JSON literal or file."""
    from shockwave_tpu_torch.utils.fileio import read_json_arg

    watchdog_config = getattr(args, "watchdog_config", None)
    if not (getattr(args, "watchdog", False) or watchdog_config):
        return None
    if not watchdog_config:
        return {}
    return read_json_arg(watchdog_config, "--watchdog-config")


def apply_telemetry_args(args) -> None:
    """Enable every observability plane the parsed driver args request.
    Call BEFORE constructing the scheduler so the tracer can adopt its
    clock and the first round is recorded."""
    if getattr(args, "metrics_out", None):
        configure(metrics=True)
        # Calibration scoring rides the metrics plane: it only observes,
        # and its series are what report_run.py's calibration table and
        # the watchdog MAPE rule consume.
        _calibration.enabled = True
    if getattr(args, "trace_out", None):
        configure(trace=True)
    if getattr(args, "decision_log", None):
        configure_recorder(args.decision_log)
    rules = watchdog_rules_from_args(args)
    if rules is not None:
        configure_watchdog(rules or None)
        _calibration.enabled = True


def export_run_summary(
    metrics_out=None,
    trace_out=None,
    makespan=None,
    avg_jct=None,
    utilization=None,
    ftf_list=None,
    unfair_fraction=None,
) -> None:
    """Publish run-level outcome gauges (so the metrics dump alone
    carries the summary table scripts/analysis/report_run.py prints) and
    export to the requested paths. One implementation for every driver —
    the gauges cannot drift per entry point."""
    if not (metrics_out or trace_out or _recorder.enabled or _watchdog.enabled):
        return
    if makespan is not None:
        gauge("run_makespan_seconds", "trace makespan").set(makespan)
    if avg_jct is not None:
        gauge("run_avg_jct_seconds", "average JCT").set(avg_jct)
    if utilization is not None:
        gauge("run_utilization", "mean worker utilization").set(utilization)
    if ftf_list:
        gauge("run_worst_ftf", "worst finish-time fairness").set(
            max(ftf_list)
        )
        if unfair_fraction is not None:
            gauge(
                "run_unfair_fraction_pct", "% jobs with FTF > 1.1"
            ).set(unfair_fraction)
    if metrics_out:
        export_metrics(metrics_out)
        print(f"Wrote {metrics_out}")
    if trace_out:
        export_trace(trace_out)
        print(f"Wrote {trace_out} (load in https://ui.perfetto.dev)")
    if _recorder.enabled and _recorder.path:
        _recorder.close()  # flush first: profile records count too
        print(
            f"Wrote {_recorder.path} ({_recorder.num_records} decision "
            "records; replay with `python -m shockwave_tpu_torch.obs.recorder "
            f"replay {_recorder.path}`)"
        )
    if _watchdog.enabled:
        print(_watchdog.format_summary())


# -- export -------------------------------------------------------------
def render_prometheus() -> str:
    if not _registry.enabled:
        return "# telemetry disabled (enable with --metrics-out)\n"
    return _registry.render_text()


def export_metrics(path: str) -> None:
    """Atomic JSON dump of the metrics snapshot."""
    import json

    from shockwave_tpu_torch.utils.fileio import atomic_write_text

    atomic_write_text(path, json.dumps(_registry.snapshot(), indent=1))


def export_trace(path: str) -> None:
    """Atomic Chrome trace-event JSON dump (Perfetto-loadable)."""
    _tracer.export(path)
