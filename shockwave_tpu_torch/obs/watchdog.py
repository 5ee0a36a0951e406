"""Scheduler health watchdog: SLO rules over the live metrics registry.

Each round the scheduler (sim and physical) calls
:meth:`Watchdog.check_round`; the watchdog reads the metrics registry —
the same series every other consumer sees — plus a small per-round
context the scheduler supplies (per-job step progress), evaluates its
rule set, and emits structured ``health`` events:

  * an ``i`` (instant) trace event named ``health`` on the
    ``scheduler/health`` track, args carrying rule/value/threshold;
  * a ``scheduler_health_alerts_total{rule}`` counter increment;
  * the ``scheduler_health`` gauge — 1.0 while every rule is quiet,
    0.0 on any round that fired.

Rules (all thresholds overridable via a config dict, e.g. the
``--watchdog-config`` driver flag):

``worst_ftf``        worst finish-time-fairness rho so far above
                     ``threshold`` (a drifting rho means some job is
                     being systematically starved).
``solver_time``      this round's mean plan-solve seconds above
                     ``blowup_factor`` x the rolling baseline of the
                     previous ``baseline_window`` solving rounds.
``straggler``        a job granted workers for ``rounds_without_progress``
                     consecutive rounds with zero step progress.
``calibration_mape`` fleet forecast MAPE above ``threshold`` once at
                     least ``min_forecasts`` forecasts were scored.
``lease_churn``      preemptions this round >= ``min_preemptions`` AND
                     above ``spike_factor`` x the rolling per-round mean.
``solver_degraded``  the plan solve fell down the degradation ladder
                     (``shockwave_solver_degraded_total`` advanced by
                     >= ``min_events`` since the last check).
``worker_death``     workers lost to crash/reclamation/heartbeat expiry
                     (``scheduler_worker_deaths_total`` advanced by
                     >= ``min_workers``).
``admission_backlog`` the streaming-admission queue is filling faster
                     than the round loop drains it: depth at or above
                     ``fraction`` of ``admission_queue_capacity`` (and
                     at least ``min_depth``) — the signal that
                     backpressure is about to reject submitters.
``replan_p99``       the p99 of ``shockwave_solve_seconds`` (from the
                     histogram's cumulative buckets, all backends)
                     exceeds ``budget_s`` once ``min_solves`` solves
                     were observed. ``budget_s`` has no universal
                     default — drivers configure it from the round
                     duration (the replan budget); the rule is inert
                     until they do.
``ingest_p99``       the p99 of ``admission_queue_latency_seconds``
                     (time a job waited in the admission queue before
                     a drain admitted it) exceeds ``budget_s`` once
                     ``min_jobs`` jobs were admitted. Like
                     ``replan_p99`` the budget has no universal
                     default — drivers configure it from
                     ``SHOCKWAVE_INGEST_P99_BUDGET_S``; inert until
                     they do.
``cell_failure``     a cell-decomposed planner isolated a cell whose
                     solve exhausted every recovery rung
                     (``cells_cell_failures_total`` advanced by >=
                     ``min_events`` — the cell keeps its cached plan
                     while the rest of the fleet proceeds, but an
                     operator must know).
``clock_skew``       a worker's NTP-estimated clock offset
                     (``worker_clock_offset_seconds{worker}``, the
                     heartbeat-reported min-RTT estimate) drifted past
                     ``max_offset_s``, or JUMPED by more than
                     ``max_jump_s`` between checks — either way the
                     merged fleet trace's alignment (and any
                     cross-host latency attribution) is suspect.
``price_spike``      the fleet congestion price (``market_price``, the
                     budget dual the planner publishes per replan)
                     exceeds ``factor`` x its rolling median over the
                     last ``window`` priced rounds (and ``min_price``)
                     — demand just outran capacity; admission pricing
                     and queue waits are about to move.
``fairness_drift``   the fleet fairness drift (``market_fairness_drift``,
                     the spend-weighted fraction of fair share the
                     market is withholding from under-served jobs)
                     stayed above ``threshold`` for ``rounds``
                     consecutive checks — the welfare objective is
                     systematically starving someone, not just
                     transiently rebalancing.

A rule re-fires only when its value worsens past the last fired value
(no per-round alert spam while a breach persists). Disabled by default
behind the standard one-attribute-check fast path.
"""

from __future__ import annotations

from shockwave_tpu_torch.analysis import sanitize
from collections import deque
from typing import Dict, List, Optional

DEFAULT_RULES: Dict[str, dict] = {
    "worst_ftf": {"threshold": 2.0},
    "solver_time": {
        "baseline_window": 20,
        "blowup_factor": 3.0,
        "min_baseline_rounds": 5,
        "min_seconds": 0.05,
    },
    "straggler": {"rounds_without_progress": 3},
    "calibration_mape": {"threshold": 0.5, "min_forecasts": 5},
    "lease_churn": {
        "window": 10,
        "spike_factor": 3.0,
        "min_preemptions": 4,
        "min_history_rounds": 3,
    },
    "solver_degraded": {"min_events": 1},
    "worker_death": {"min_workers": 1},
    "admission_backlog": {"fraction": 0.9, "min_depth": 8},
    "replan_p99": {"budget_s": None, "min_solves": 5, "quantile": 0.99},
    "ingest_p99": {"budget_s": None, "min_jobs": 20, "quantile": 0.99},
    "cell_failure": {"min_events": 1},
    "clock_skew": {"max_offset_s": 1.0, "max_jump_s": 0.5},
    "price_spike": {
        "factor": 3.0,
        "window": 20,
        "min_history_rounds": 5,
        "min_price": 1e-9,
    },
    "fairness_drift": {"threshold": 0.25, "rounds": 3},
}


def merge_rules(overrides: Optional[dict]) -> Dict[str, dict]:
    """Defaults overlaid with per-rule overrides; an override of
    ``false``/``null`` disables that rule entirely."""
    rules = {name: dict(cfg) for name, cfg in DEFAULT_RULES.items()}
    for name, cfg in (overrides or {}).items():
        if name not in rules:
            raise ValueError(
                f"unknown watchdog rule {name!r}; known: "
                f"{sorted(DEFAULT_RULES)}"
            )
        if cfg in (False, None):
            rules.pop(name)
        else:
            rules[name].update(cfg)
    return rules


class Watchdog:
    def __init__(self, enabled: bool = False, rules: Optional[dict] = None):
        self.enabled = enabled
        self.rules = merge_rules(rules)
        self._lock = sanitize.make_lock("obs.watchdog.Watchdog._lock")
        self.alerts: List[dict] = []
        self._rounds_checked = 0
        # Rolling state.
        self._last_counters: Dict[str, float] = {}
        self._solve_means: deque = deque()
        self._preemption_deltas: deque = deque()
        # job -> [last_steps, consecutive scheduled rounds w/o progress]
        self._progress: Dict[object, list] = {}
        # worker -> [last offset seen, currently-breached flag] for the
        # clock_skew rule's per-worker hysteresis.
        self._clock_offsets: Dict[str, list] = {}
        # Rolling market_price samples (price_spike) and the count of
        # consecutive over-threshold checks (fairness_drift).
        self._price_history: deque = deque()
        self._drift_rounds = 0
        # Jobs granted workers at the PREVIOUS check: the steps delta a
        # check observes covers the previous round's execution.
        self._prev_scheduled: set = set()
        # rule -> value at last fire (re-fire only on worsening).
        self._last_fired: Dict[str, float] = {}

    def configure(
        self, rules: Optional[dict] = None, enabled: bool = True
    ) -> None:
        with self._lock:
            self.rules = merge_rules(rules)
            self.enabled = enabled

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self.rules = merge_rules(None)
            self.alerts.clear()
            self._rounds_checked = 0
            self._last_counters.clear()
            self._solve_means.clear()
            self._preemption_deltas.clear()
            self._progress.clear()
            self._clock_offsets.clear()
            self._price_history.clear()
            self._drift_rounds = 0
            self._prev_scheduled.clear()
            self._last_fired.clear()

    # -- registry access -----------------------------------------------
    @staticmethod
    def _snapshot() -> dict:
        from shockwave_tpu_torch import obs

        return obs.get_registry().snapshot()["metrics"]

    @staticmethod
    def _gauge_value(metrics: dict, name: str):
        metric = metrics.get(name)
        if not metric or not metric["series"]:
            return None
        for series in metric["series"]:
            if not series["labels"]:
                return series["value"]
        return None

    @staticmethod
    def _histogram_totals(metrics: dict, name: str):
        """(count, sum, max) summed/maxed over every label series."""
        metric = metrics.get(name)
        if not metric or not metric["series"]:
            return 0, 0.0, None
        count = sum(s["count"] for s in metric["series"])
        total = sum(s["sum"] for s in metric["series"])
        maxes = [s["max"] for s in metric["series"] if s["max"] is not None]
        return count, total, max(maxes) if maxes else None

    @staticmethod
    def _counter_total(metrics: dict, name: str) -> float:
        metric = metrics.get(name)
        if not metric:
            return 0.0
        return sum(s["value"] for s in metric["series"])

    # -- evaluation -----------------------------------------------------
    def check_round(
        self,
        round_index: int,
        now_s: float,
        job_steps: Optional[Dict[object, int]] = None,
        scheduled: Optional[list] = None,
    ) -> List[dict]:
        """Evaluate every configured rule; returns this round's alerts."""
        if not self.enabled:
            return []
        from shockwave_tpu_torch import obs

        with self._lock:
            self._rounds_checked += 1
            metrics = self._snapshot()
            fired: List[dict] = []

            if "worst_ftf" in self.rules:
                self._check_worst_ftf(metrics, round_index, fired)
            if "solver_time" in self.rules:
                self._check_solver_time(metrics, round_index, fired)
            if "calibration_mape" in self.rules:
                self._check_calibration(metrics, round_index, fired)
            if "lease_churn" in self.rules:
                self._check_lease_churn(metrics, round_index, fired)
            if "straggler" in self.rules and job_steps is not None:
                self._check_stragglers(
                    job_steps, scheduled or [], round_index, fired
                )
            if "solver_degraded" in self.rules:
                self._check_counter_delta(
                    metrics, "solver_degraded",
                    "shockwave_solver_degraded_total",
                    self.rules["solver_degraded"]["min_events"],
                    round_index, fired,
                )
            if "worker_death" in self.rules:
                self._check_counter_delta(
                    metrics, "worker_death",
                    "scheduler_worker_deaths_total",
                    self.rules["worker_death"]["min_workers"],
                    round_index, fired,
                )
            if "admission_backlog" in self.rules:
                self._check_admission_backlog(metrics, round_index, fired)
            if "replan_p99" in self.rules:
                self._check_replan_p99(metrics, round_index, fired)
            if "ingest_p99" in self.rules:
                self._check_ingest_p99(metrics, round_index, fired)
            if "cell_failure" in self.rules:
                self._check_counter_delta(
                    metrics, "cell_failure",
                    "cells_cell_failures_total",
                    self.rules["cell_failure"]["min_events"],
                    round_index, fired,
                )
            if "clock_skew" in self.rules:
                self._check_clock_skew(metrics, round_index, fired)
            if "price_spike" in self.rules:
                self._check_price_spike(metrics, round_index, fired)
            if "fairness_drift" in self.rules:
                self._check_fairness_drift(metrics, round_index, fired)

            for alert in fired:
                alert["time_s"] = float(now_s)
                self.alerts.append(alert)
                obs.counter(
                    "scheduler_health_alerts_total",
                    "watchdog SLO rule violations",
                ).inc(rule=alert["rule"])
                obs.instant(
                    "health", cat="health", tid="health",
                    ts_s=now_s, args=dict(alert),
                )
            obs.gauge(
                "scheduler_health",
                "1 while every watchdog rule is quiet, 0 on rounds "
                "with an alert",
            ).set(0.0 if fired else 1.0)
            return fired

    def _fire(
        self, fired: list, rule: str, round_index: int, value: float,
        threshold: float, **detail,
    ) -> None:
        """Append an alert unless this breach already fired at an equal
        or worse value (hysteresis against per-round spam). Callers
        must :meth:`_rearm` the rule on rounds where it is back under
        threshold, so a LATER distinct breach fires again. Caller
        holds the lock."""
        last = self._last_fired.get(rule)
        if last is not None and value <= last:
            return
        self._last_fired[rule] = value
        fired.append(
            {
                "rule": rule,
                "round": int(round_index),
                "value": round(float(value), 6),
                "threshold": round(float(threshold), 6),
                **detail,
            }
        )

    def _rearm(self, rule: str) -> None:
        """Caller holds the lock."""
        self._last_fired.pop(rule, None)

    def _check_counter_delta(
        self, metrics, rule, counter, min_delta, round_index, fired
    ) -> None:
        """Event-counter rule shape (degraded solves, worker deaths):
        fire when the counter advanced by at least ``min_delta`` since
        the previous check; a quiet round re-arms. Caller holds the
        lock (check_round)."""
        total = self._counter_total(metrics, counter)
        delta = total - self._last_counters.get(counter, 0.0)
        self._last_counters[counter] = total
        if delta >= min_delta:
            self._fire(fired, rule, round_index, delta, min_delta)
        else:
            self._rearm(rule)

    @classmethod
    def _histogram_quantile(cls, metrics, name, q):
        """Quantile over every label series of a histogram family via
        the shared
        :func:`shockwave_tpu_torch.obs.metrics.merged_histogram_quantile`:
        when the series carry quantile sketches (every live registry's
        do) the merge is exact and the estimate sits within
        the sketch's pinned relative error (``SHOCKWAVE_SKETCH_ALPHA``,
        default 1%) — the replan_p99/ingest_p99 SLO rules gate on that
        bound instead of bucket-table interpolation; pre-sketch dumps
        fall back to the cumulative-bucket math. Returns (value, count)
        or (None, count)."""
        from shockwave_tpu_torch.obs.metrics import merged_histogram_quantile

        return merged_histogram_quantile(metrics.get(name), q)

    def _check_admission_backlog(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["admission_backlog"]
        depth = self._gauge_value(metrics, "admission_queue_depth")
        capacity = self._gauge_value(metrics, "admission_queue_capacity")
        if depth is None or not capacity:
            return
        threshold = max(cfg["fraction"] * capacity, cfg["min_depth"])
        if depth >= threshold:
            self._fire(
                fired, "admission_backlog", round_index, depth, threshold,
                capacity=int(capacity),
            )
        else:
            self._rearm("admission_backlog")

    def _check_replan_p99(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["replan_p99"]
        budget = cfg.get("budget_s")
        if budget is None:
            return  # inert until a driver supplies the replan budget
        p99, count = self._histogram_quantile(
            metrics, "shockwave_solve_seconds", cfg.get("quantile", 0.99)
        )
        if p99 is None or count < cfg["min_solves"]:
            return
        if p99 > budget:
            self._fire(
                fired, "replan_p99", round_index, p99, budget,
                solves=int(count),
            )
        else:
            self._rearm("replan_p99")

    def _check_ingest_p99(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round). p99 of the time a job
        waited in the admission queue before a drain admitted it
        (``admission_queue_latency_seconds``) vs the ingest-latency
        budget — the SLO the event-driven ingest plane exists to hold.
        Inert until a driver supplies ``budget_s`` (from
        ``SHOCKWAVE_INGEST_P99_BUDGET_S``)."""
        cfg = self.rules["ingest_p99"]
        budget = cfg.get("budget_s")
        if budget is None:
            return  # inert until a driver supplies the ingest budget
        p99, count = self._histogram_quantile(
            metrics,
            "admission_queue_latency_seconds",
            cfg.get("quantile", 0.99),
        )
        if p99 is None or count < cfg["min_jobs"]:
            return
        if p99 > budget:
            self._fire(
                fired, "ingest_p99", round_index, p99, budget,
                jobs=int(count),
            )
        else:
            self._rearm("ingest_p99")

    def _check_clock_skew(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round). Per-worker (like
        straggler: the shared hysteresis slot would let one skewed
        worker mask another): fire when |offset| crosses
        ``max_offset_s``, or when the offset jumps by more than
        ``max_jump_s`` between consecutive checks (a step change means
        one of the clocks was yanked — NTP sync, VM migration — and
        historical alignment is suspect); one alert per breach episode,
        re-armed when the offset is back under threshold."""
        cfg = self.rules["clock_skew"]
        metric = metrics.get("worker_clock_offset_seconds")
        seen = set()
        for series in (metric or {}).get("series", ()):
            worker = series["labels"].get("worker")
            if worker is None:
                continue
            seen.add(worker)
            offset = float(series["value"])
            state = self._clock_offsets.get(worker)
            jump = abs(offset - state[0]) if state is not None else 0.0
            breach = abs(offset) > cfg["max_offset_s"]
            jumped = jump > cfg["max_jump_s"]
            was_breached = state is not None and state[1]
            if (breach or jumped) and not was_breached:
                fired.append(
                    {
                        "rule": "clock_skew",
                        "round": int(round_index),
                        "value": round(offset, 6),
                        "threshold": float(cfg["max_offset_s"]),
                        "worker": str(worker),
                        "jump_s": round(jump, 6),
                    }
                )
            # Only a SUSTAINED offset breach latches the episode: a
            # jump is a one-shot event (and the jump back to a sane
            # offset at recovery must clear the latch, not re-arm it).
            self._clock_offsets[worker] = [offset, breach]
        for gone in [w for w in self._clock_offsets if w not in seen]:
            del self._clock_offsets[gone]

    def _check_price_spike(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round). The fleet congestion
        price (the budget dual from the planner's last committed
        replan) spiking past ``factor`` x its rolling median means
        demand just outran capacity — the market is about to start
        charging for admission and shaving shares. The median (not
        mean) baseline keeps one previous spike from inflating the
        bar; ``min_price`` keeps an uncongested fleet (price pinned
        at 0) from firing on float dust."""
        cfg = self.rules["price_spike"]
        price = self._gauge_value(metrics, "market_price")
        if price is None:
            return  # no market planner publishing prices
        history = sorted(self._price_history)
        self._price_history.append(float(price))
        while len(self._price_history) > cfg["window"]:
            self._price_history.popleft()
        if len(history) < cfg["min_history_rounds"]:
            return
        median = history[len(history) // 2]
        threshold = max(cfg["factor"] * median, cfg["min_price"])
        if price > threshold:
            self._fire(
                fired, "price_spike", round_index, price, threshold,
                median=round(median, 9),
            )
        else:
            self._rearm("price_spike")

    def _check_fairness_drift(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round). Sustained (``rounds``
        consecutive checks) fairness drift above ``threshold``: the
        welfare maximizer is persistently holding some jobs under
        their proportional fair share — systematic starvation, not the
        transient rebalancing a single hot round produces."""
        cfg = self.rules["fairness_drift"]
        drift = self._gauge_value(metrics, "market_fairness_drift")
        if drift is None:
            return  # no market planner publishing drift
        if drift > cfg["threshold"]:
            self._drift_rounds += 1
            if self._drift_rounds >= cfg["rounds"]:
                self._fire(
                    fired, "fairness_drift", round_index, drift,
                    cfg["threshold"], consecutive=self._drift_rounds,
                )
        else:
            self._drift_rounds = 0
            self._rearm("fairness_drift")

    def _check_worst_ftf(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["worst_ftf"]
        _, _, worst = self._histogram_totals(metrics, "scheduler_job_ftf")
        if worst is not None and worst > cfg["threshold"]:
            self._fire(
                fired, "worst_ftf", round_index, worst, cfg["threshold"]
            )
        # NOTE: worst-so-far is monotone, so it never re-arms — by
        # design, one alert per new worst value.

    def _check_solver_time(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["solver_time"]
        count, total, _ = self._histogram_totals(
            metrics, "shockwave_solve_seconds"
        )
        d_count = count - self._last_counters.get("solve_count", 0)
        d_total = total - self._last_counters.get("solve_sum", 0.0)
        self._last_counters["solve_count"] = count
        self._last_counters["solve_sum"] = total
        if d_count <= 0:
            return  # no solve this round: baseline unchanged
        mean = d_total / d_count
        baseline = list(self._solve_means)
        self._solve_means.append(mean)
        while len(self._solve_means) > cfg["baseline_window"]:
            self._solve_means.popleft()
        if len(baseline) < cfg["min_baseline_rounds"]:
            return
        baseline_mean = sum(baseline) / len(baseline)
        threshold = max(
            cfg["blowup_factor"] * baseline_mean, cfg["min_seconds"]
        )
        if mean > threshold:
            self._fire(
                fired, "solver_time", round_index, mean, threshold,
                baseline_s=round(baseline_mean, 6),
            )
        else:
            self._rearm("solver_time")

    def _check_calibration(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["calibration_mape"]
        mape = self._gauge_value(metrics, "predictor_calibration_mape")
        scored = self._gauge_value(metrics, "predictor_calibration_scored")
        if mape is None or (scored or 0) < cfg["min_forecasts"]:
            return
        if mape > cfg["threshold"]:
            self._fire(
                fired, "calibration_mape", round_index, mape,
                cfg["threshold"], forecasts=int(scored),
            )
        else:
            self._rearm("calibration_mape")

    def _check_lease_churn(self, metrics, round_index, fired) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["lease_churn"]
        total = self._counter_total(metrics, "scheduler_preemptions_total")
        delta = total - self._last_counters.get("preemptions", 0.0)
        self._last_counters["preemptions"] = total
        history = list(self._preemption_deltas)
        self._preemption_deltas.append(delta)
        while len(self._preemption_deltas) > cfg["window"]:
            self._preemption_deltas.popleft()
        if len(history) < cfg["min_history_rounds"]:
            return
        baseline = sum(history) / len(history)
        threshold = max(
            cfg["spike_factor"] * baseline, cfg["min_preemptions"]
        )
        if delta >= cfg["min_preemptions"] and delta > threshold:
            self._fire(
                fired, "lease_churn", round_index, delta, threshold,
                baseline_per_round=round(baseline, 3),
            )
        else:
            self._rearm("lease_churn")

    def _check_stragglers(
        self, job_steps, scheduled, round_index, fired
    ) -> None:
        """Caller holds the lock (check_round)."""
        cfg = self.rules["straggler"]
        limit = cfg["rounds_without_progress"]
        for job_id, steps in job_steps.items():
            state = self._progress.get(job_id)
            if state is None:
                self._progress[job_id] = [steps, 0]
                continue
            # ANY change counts as progress, not just growth: a
            # batch-size rescale rewrites the step basis (total steps
            # SHRINK when bs doubles) and must not read as a stall.
            if steps != state[0]:
                state[0] = steps
                state[1] = 0
            elif job_id in self._prev_scheduled:
                # The steps delta observed NOW covers the previous
                # round's execution, so a stall is attributed to jobs
                # granted workers in the PREVIOUS check — a job idle
                # last round trivially made no progress. One alert per
                # stall episode (the count resets on any progress),
                # emitted directly: the shared per-rule hysteresis slot
                # would let one stalled job mask another.
                state[1] += 1
                if state[1] == limit:
                    fired.append(
                        {
                            "rule": "straggler",
                            "round": int(round_index),
                            "value": float(state[1]),
                            "threshold": float(limit),
                            "job_id": str(job_id),
                        }
                    )
        for gone in [j for j in self._progress if j not in job_steps]:
            del self._progress[gone]
        self._prev_scheduled = set(scheduled)

    # -- summary --------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            by_rule: Dict[str, int] = {}
            for alert in self.alerts:
                by_rule[alert["rule"]] = by_rule.get(alert["rule"], 0) + 1
            return {
                "healthy": not self.alerts,
                "alerts": len(self.alerts),
                "rounds_checked": self._rounds_checked,
                "by_rule": by_rule,
            }

    def format_summary(self) -> str:
        s = self.summary()
        if s["healthy"]:
            return (
                f"Scheduler health: OK "
                f"({s['rounds_checked']} rounds watched, 0 alerts)"
            )
        detail = ", ".join(
            f"{rule} x{n}" for rule, n in sorted(s["by_rule"].items())
        )
        return (
            f"Scheduler health: DEGRADED — {s['alerts']} alert(s) over "
            f"{s['rounds_checked']} rounds ({detail})"
        )
