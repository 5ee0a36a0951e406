"""Online predictor-calibration scoring.

Shockwave's planner stakes every priority and finish-time-fairness
estimate on :meth:`JobMetadata.remaining_runtime` — the Bayesian
remaining-processing-time forecast. This tracker closes the loop: each
round the scheduler records the live forecast (and its credible
interval) for every active job alongside the processing time the job
has received so far; when the job retires, every forecast it ever made
is scored against what actually happened:

  realized remaining = total processing seconds at completion
                       - processing seconds at forecast time

(processing time, not wall time: the forecast predicts the job's own
compute, and judging it against queueing delay would blame the
predictor for the scheduler's contention).

Scores, per forecast: signed error (predicted - realized, positive =
over-forecast), absolute percentage error, and whether the realized
value fell inside the Dirichlet credible interval.

MEMORY CONTRACT: the tracker's footprint is independent of how
many jobs a campaign retires. Fleet-wide truth is a set of RUNNING
aggregates (exact — every scored forecast contributes); per-job
identity survives only in a top-k worst-offender reservoir
(``SHOCKWAVE_OBS_EXEMPLARS``, default 10, ranked by per-job MAPE) that
keeps real ``job_id``s for forensics. Per-job gauges are published for
CURRENT reservoir members only, and a job evicted by a worse offender
has its gauges removed on the spot — a million-job campaign holds
4 fleet gauges + 4k per-job series, not 4M. Unscored forecasts for
ACTIVE jobs keep the most recent ``_MAX_PENDING`` per job (a deque —
a 100k-round straggler cannot grow its forecast list unboundedly).

Fleet-wide series::

    predictor_forecast_error_seconds   histogram  signed error
    predictor_forecast_ape             histogram  |error| / realized
    predictor_interval_total           counter    {covered}
    predictor_calibration_mape         gauge      fleet MAPE
    predictor_calibration_bias_seconds gauge      fleet mean signed error
    predictor_calibration_coverage     gauge      interval hit fraction
    predictor_calibration_scored       gauge      forecasts scored

Per-job series (label ``job_id``; reservoir members only):
``predictor_job_mape``, ``predictor_job_bias_seconds``,
``predictor_job_coverage``, ``predictor_job_forecasts``. The same
worst offenders surface in the metrics snapshot's ``exemplars`` block
under ``predictor_worst_mape`` (what report_run.py's "worst
offenders" table reads).

Disabled by default with the usual one-attribute-check fast path.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Optional

from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.obs.history import ExemplarReservoir

_EPS = 1e-9

# Per-job cap on unscored forecasts (newest kept): bounds the pending
# table for arbitrarily long-lived jobs.
_MAX_PENDING = 256

_JOB_GAUGES = (
    "predictor_job_mape",
    "predictor_job_bias_seconds",
    "predictor_job_forecasts",
    "predictor_job_coverage",
)

EXEMPLAR_FAMILY = "predictor_worst_mape"


def _exemplar_k() -> int:
    try:
        return max(1, int(os.environ.get("SHOCKWAVE_OBS_EXEMPLARS", 10)))
    except ValueError:
        return 10


class CalibrationTracker:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = sanitize.make_lock("obs.calibration.CalibrationTracker._lock")
        # job -> deque of (run_time_at_forecast, predicted, lo, hi, ts,
        # ape_floor), newest _MAX_PENDING kept
        self._pending: Dict[object, deque] = {}
        # Fleet running aggregates (exact, O(1) memory).
        self._fleet = self._zero_stats()
        # Worst offenders by per-job MAPE; detail holds the job's stats.
        self._worst = ExemplarReservoir(k=_exemplar_k())

    @staticmethod
    def _zero_stats() -> dict:
        return {
            "n": 0,
            "abs_pct_sum": 0.0,
            "signed_sum": 0.0,
            "covered": 0,
            "with_interval": 0,
        }

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self._pending.clear()
            self._fleet = self._zero_stats()
            self._worst = ExemplarReservoir(k=_exemplar_k())

    # -- recording ------------------------------------------------------
    def record_forecast(
        self,
        job_id,
        run_time_so_far_s: float,
        predicted_remaining_s: float,
        lo_s: Optional[float] = None,
        hi_s: Optional[float] = None,
        ts_s: Optional[float] = None,
        ape_floor_s: float = 0.0,
    ) -> None:
        """``ape_floor_s`` floors the APE denominator (typically one
        mean epoch duration): a forecast made seconds before completion
        divides by a near-zero realized remainder and would otherwise
        dominate the MAPE with a scoring artifact, not a predictor
        error."""
        if not self.enabled:
            return
        with self._lock:
            pending = self._pending.get(job_id)
            if pending is None:
                pending = deque(maxlen=_MAX_PENDING)
                self._pending[job_id] = pending
            pending.append(
                (
                    float(run_time_so_far_s),
                    float(predicted_remaining_s),
                    None if lo_s is None else float(lo_s),
                    None if hi_s is None else float(hi_s),
                    ts_s,
                    float(ape_floor_s),
                )
            )

    def discard(self, job_id) -> None:
        """Drop a job's unscored forecasts (failed jobs never realize a
        remaining runtime to judge them against)."""
        if not self.enabled:
            return
        with self._lock:
            self._pending.pop(job_id, None)

    def record_outcome(self, job_id, total_run_time_s: float) -> None:
        """Score every pending forecast for a retiring job against its
        realized processing time, fold the scores into the fleet
        aggregates, and keep the job's identity only if it ranks among
        the k worst offenders."""
        if not self.enabled:
            return
        from shockwave_tpu_torch import obs

        with self._lock:
            forecasts = self._pending.pop(job_id, None)
            if not forecasts:
                return
            # Repeated outcomes for one job (re-submission) accumulate
            # into its reservoir stats when it is still a member.
            label = str(job_id)
            prior = (
                self._worst._entries.get(label, (0.0, {}))[1].get("stats")
                if label in self._worst
                else None
            )
            stats = dict(prior) if prior else self._zero_stats()
            err_h = obs.histogram(
                "predictor_forecast_error_seconds",
                "signed remaining-runtime forecast error "
                "(predicted - realized)",
            )
            ape_h = obs.histogram(
                "predictor_forecast_ape",
                "absolute percentage error of remaining-runtime forecasts",
            )
            cov_c = obs.counter(
                "predictor_interval_total",
                "forecasts whose realized value fell inside/outside the "
                "credible interval",
            )
            fleet = self._fleet
            for run_at, predicted, lo, hi, _ts, ape_floor in forecasts:
                realized = max(
                    float(total_run_time_s) - run_at, _EPS
                )
                signed = predicted - realized
                ape = abs(signed) / max(realized, ape_floor, _EPS)
                for bucket in (stats, fleet):
                    bucket["n"] += 1
                    bucket["abs_pct_sum"] += ape
                    bucket["signed_sum"] += signed
                err_h.observe(signed)
                ape_h.observe(ape)
                if lo is not None and hi is not None:
                    covered = lo - _EPS <= realized <= hi + _EPS
                    for bucket in (stats, fleet):
                        bucket["with_interval"] += 1
                        bucket["covered"] += int(covered)
                    cov_c.inc(covered=str(covered))
            self._offer_worst(job_id, stats)
            self._publish_fleet()

    # -- publication ----------------------------------------------------
    def _offer_worst(self, job_id, stats: dict) -> None:
        """Rank the retiring job by MAPE against the reservoir: members
        get per-job gauges, the displaced loser loses its gauges —
        /metrics never serves more than k per-job calibration series."""
        from shockwave_tpu_torch import obs

        n = stats["n"]
        if n == 0:
            return
        label = str(job_id)
        mape = stats["abs_pct_sum"] / n
        evicted = self._worst.evicted_by(label, mape)
        kept = self._worst.offer(label, mape, stats=stats)
        if evicted is not None:
            self._unpublish_job(evicted)
        if not kept:
            return
        obs.gauge(
            "predictor_job_mape",
            "per-job forecast MAPE (k worst offenders)",
        ).set(mape, job_id=label)
        obs.gauge(
            "predictor_job_bias_seconds", "per-job mean signed error"
        ).set(stats["signed_sum"] / n, job_id=label)
        obs.gauge(
            "predictor_job_forecasts", "forecasts scored for this job"
        ).set(n, job_id=label)
        if stats["with_interval"]:
            obs.gauge(
                "predictor_job_coverage",
                "fraction of this job's forecasts inside the interval",
            ).set(stats["covered"] / stats["with_interval"], job_id=label)
        obs.offer_exemplar(
            EXEMPLAR_FAMILY,
            label,
            mape,
            help="jobs with the worst remaining-runtime forecast MAPE",
            forecasts=n,
            bias_s=round(stats["signed_sum"] / n, 6),
        )

    @staticmethod
    def _unpublish_job(label: str) -> None:
        from shockwave_tpu_torch import obs

        for family in _JOB_GAUGES:
            obs.gauge(family).remove(job_id=label)

    def _publish_fleet(self) -> None:
        from shockwave_tpu_torch import obs

        fleet = self._fleet
        n = fleet["n"]
        if n == 0:
            return
        obs.gauge(
            "predictor_calibration_mape",
            "fleet-wide remaining-runtime forecast MAPE",
        ).set(fleet["abs_pct_sum"] / n)
        obs.gauge(
            "predictor_calibration_bias_seconds",
            "fleet-wide mean signed forecast error",
        ).set(fleet["signed_sum"] / n)
        obs.gauge(
            "predictor_calibration_scored", "forecasts scored fleet-wide"
        ).set(n)
        if fleet["with_interval"]:
            obs.gauge(
                "predictor_calibration_coverage",
                "fleet-wide credible-interval hit fraction",
            ).set(fleet["covered"] / fleet["with_interval"])

    # -- inspection ------------------------------------------------------
    def snapshot(self) -> dict:
        """Calibration table (tests / health report): the k worst
        offenders (per-job stats survive only for them) plus the exact
        fleet aggregates."""
        with self._lock:
            table = {}
            for label, score, detail in self._worst.entries():
                s = detail.get("stats") or {}
                n = s.get("n", 0)
                table[label] = {
                    "forecasts": n,
                    "mape": s["abs_pct_sum"] / n if n else None,
                    "bias_s": s["signed_sum"] / n if n else None,
                    "coverage": (
                        s["covered"] / s["with_interval"]
                        if s.get("with_interval")
                        else None
                    ),
                }
            pending = {
                str(job_id): len(v) for job_id, v in self._pending.items()
            }
            fleet = dict(self._fleet)
        out = {"jobs": table, "pending": pending}
        n = fleet["n"]
        if n:
            out["fleet"] = {
                "forecasts": n,
                "mape": fleet["abs_pct_sum"] / n,
                "bias_s": fleet["signed_sum"] / n,
                "coverage": (
                    fleet["covered"] / fleet["with_interval"]
                    if fleet["with_interval"]
                    else None
                ),
            }
        return out
