"""Per-job dynamic-adaptation predictor state.

One :class:`JobMetadata` per job tracks its epoch profile (batch size and
wall-clock duration of every epoch), the measured per-round throughput
schedule, and a Dirichlet prior over batch-size "regimes". From these it
predicts the job's remaining runtime — the quantity the Shockwave planner's
finish-time-fairness and makespan terms are built on.

Capability parity with reference: scheduler/job_metadata.py:1-202. The
implementation here is vectorized numpy (cumsum/bincount over epoch arrays
instead of Python loops; :func:`batch_remaining_runtimes` evaluates many
jobs at once). A copy of the JAX package's module, which imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

INFINITY = 1e9

# Change-point reweight (see JobMetadata._regime_posterior): after a
# batch-size switch is OBSERVED in the measured throughput schedule,
# this fraction of the Dirichlet prior mass stays spread over the
# profiled regimes; the rest concentrates on the regime the job was
# last measured in. The profile's bs-per-epoch pattern predicts WHEN a
# gns/accordion job switches, but the realized switch point (driven by
# measured gradient noise / critical regimes) routinely lands epochs
# away — pricing the remaining epochs mostly at the observed regime is
# what closes the MAPE outliers the calibration tracker exposed.
CHANGEPOINT_RETAIN = 0.1


class JobMetadata:
    """Epoch profile + throughput history + Dirichlet regime posterior.

    Profile schema (reference: job_metadata.py:14-23):
      num_epochs, num_samples_per_epoch, scale_factor, duration,
      bs_every_epoch, mem_every_epoch, util_every_epoch, duration_every_epoch.
    """

    def __init__(
        self,
        profile: dict,
        round_duration: float,
        scale_factor: Optional[int] = None,
    ):
        self.total_epochs = int(profile["num_epochs"])
        self.completed_epochs = 0
        self.nsamples_per_epoch = profile["num_samples_per_epoch"]
        self.nworkers = (
            int(scale_factor)
            if scale_factor is not None
            else int(profile["scale_factor"])
        )
        self.epoch_batch_sizes = np.asarray(profile["bs_every_epoch"], dtype=np.int64)
        self.epoch_mem_reqs = list(profile.get("mem_every_epoch", []))
        self.epoch_gpu_reqs = list(profile.get("util_every_epoch", []))

        # Durations are clamped to whole >=1s values up front
        # (reference: job_metadata.py:39).
        durations = np.asarray(profile["duration_every_epoch"], dtype=np.float64)
        self.epoch_durations = np.maximum(1.0, np.round(durations))
        # The as-profiled durations stay fixed; ``epoch_durations`` is
        # re-scaled in place from measured throughput.
        self.estimated_epoch_durations = self.epoch_durations.copy()

        # Dirichlet prior: uniform over the distinct batch sizes in the
        # profile, with total concentration = total_epochs
        # (reference: job_metadata.py:42-45).
        self.regimes = np.unique(self.epoch_batch_sizes)
        self.dirichlet: Dict[int, float] = {
            int(bs): self.total_epochs / len(self.regimes) for bs in self.regimes
        }

        self.submit_time: Optional[float] = None
        # round_id -> (throughput, batch size), insertion-ordered.
        self.throughput_schedule: Dict[int, tuple] = {}
        self.round_duration = round_duration
        # The duration rescale is a pure (and idempotent) function of the
        # throughput schedule; the planner calls it for every job on
        # every replan, so memoize on the schedule's version.
        self._schedule_version = 0
        self._rescale_key: Optional[int] = None
        self._bs_durations_cache: Optional[Dict[int, float]] = None

    # -- serialization --------------------------------------------------
    def state_dict(self) -> dict:
        """Every field as it is (host numpy and Python state): the JAX
        package's snapshot, field for field, so a state dict either
        package writes restores in the other."""
        return dict(self.__dict__)

    @classmethod
    def from_state(cls, state: dict) -> "JobMetadata":
        obj = cls.__new__(cls)
        obj.__dict__.update(state)
        return obj

    # -- lifecycle ------------------------------------------------------
    def submit(self, time: float) -> None:
        if self.submit_time is None:
            self.submit_time = time

    def complete(self, num_epochs: Optional[int] = None) -> None:
        """Record epoch progress; with no argument, mark fully finished
        (reference: job_metadata.py:64-78)."""
        if num_epochs is None:
            self.completed_epochs = self.total_epochs
        else:
            if num_epochs > self.total_epochs:
                raise ValueError(f"epoch progress {num_epochs} > {self.total_epochs}")
            self.completed_epochs = int(num_epochs)

    def record_round_throughput(self, round_id: int, throughput: float, bs: int) -> None:
        """(reference: job_metadata.py:80-92)"""
        self.throughput_schedule[int(round_id)] = (float(throughput), int(bs))
        self._schedule_version += 1

    # -- duration model -------------------------------------------------
    def recompute_epoch_durations(self) -> None:
        """Rescale the per-epoch duration estimates so that the samples/sec
        they imply matches what the measured throughput schedule observed
        (reference: job_metadata.py:94-148).

        measured samples: integrate throughput*bs over the measured rounds
        (each measurement is extended back to the previous one). estimated
        samples: walk the original per-epoch durations across the same time
        window, counting whole epochs plus the in-progress fraction.
        """
        if not self.throughput_schedule:
            return
        if self._schedule_version == self._rescale_key:
            return
        self._rescale_key = self._schedule_version
        self._bs_durations_cache = None
        rounds = np.array(sorted(self.throughput_schedule), dtype=np.int64)
        tputs = np.array(
            [self.throughput_schedule[r][0] for r in rounds], dtype=np.float64
        )
        bss = np.array([self.throughput_schedule[r][1] for r in rounds], dtype=np.float64)
        spans = np.diff(np.concatenate([[0], rounds])).astype(np.float64)
        measured_nsamples = float(np.sum(bss * tputs * self.round_duration * spans))
        measured_time_range = self.round_duration * float(rounds[-1])

        cum = np.cumsum(self.estimated_epoch_durations)
        # Number of whole estimated epochs that fit in the measured window.
        whole = int(np.searchsorted(cum, measured_time_range, side="right"))
        whole = min(whole, len(cum))
        estimated_nsamples = self.nsamples_per_epoch * whole
        elapsed = float(cum[whole - 1]) if whole > 0 else 0.0
        partial = measured_time_range - elapsed
        if partial > 0:
            # The fractional epoch is valued against the same as-profiled
            # durations the whole-epoch count uses, making this recompute
            # idempotent. (The reference prices the fraction at the
            # already-rescaled duration, job_metadata.py:131-134, so its
            # repeated recomputes oscillate with no new measurements — a
            # consciously fixed quirk, SURVEY §7.)
            idx = min(whole, len(self.estimated_epoch_durations) - 1)
            estimated_nsamples += self.nsamples_per_epoch * (
                partial / self.estimated_epoch_durations[idx]
            )

        if measured_nsamples <= 0 or estimated_nsamples <= 0:
            return
        scale = estimated_nsamples / measured_nsamples
        self.epoch_durations = self.estimated_epoch_durations * scale

    def bs_epoch_durations(self) -> Dict[int, float]:
        """Mean epoch duration per batch-size regime, after rescaling
        (reference: job_metadata.py:150-165)."""
        self.recompute_epoch_durations()
        if self._bs_durations_cache is None:
            out: Dict[int, float] = {}
            for bs in self.regimes:
                mask = self.epoch_batch_sizes == bs
                out[int(bs)] = float(np.mean(self.epoch_durations[mask]))
            self._bs_durations_cache = out
        # Copy: callers may adjust the mapping for what-if math without
        # corrupting the cache.
        return dict(self._bs_durations_cache)

    def mean_epoch_duration(self) -> float:
        """Interpolated epoch duration: mean over the completed epochs plus
        the one in progress (reference: shockwave.py:116-120 footnote of
        EQ 7)."""
        return float(np.mean(self.epoch_durations[: self.completed_epochs + 1]))

    # -- remaining-runtime prediction -----------------------------------
    def _measured_changepoint(self):
        """``(last_bs, switched)`` derived from the measured throughput
        schedule: the regime the job was last observed running in, and
        whether a batch-size switch was ever MEASURED (recorded bs
        differing across rounds). A pure function of the schedule —
        no hidden detector state — so checkpoint restore and
        flight-recorder replay (which reconstruct the schedule exactly)
        re-derive the identical change-point, and a planner decision
        downstream of the reweight replays bit-for-bit. Memoized on the
        schedule version like the duration rescale."""
        if getattr(self, "_changepoint_key", None) == self._schedule_version:
            return self._changepoint
        last_bs = None
        switched = False
        for r in sorted(self.throughput_schedule):
            bs = self.throughput_schedule[r][1]
            if last_bs is not None and bs != last_bs:
                switched = True
            last_bs = bs
        self._changepoint_key = self._schedule_version
        self._changepoint = (last_bs, switched)
        return self._changepoint

    def _regime_posterior(self) -> Tuple[Dict[int, int], Dict[int, float]]:
        """Dirichlet posterior over batch-size regimes for the epochs
        ahead: prior + one count per observed (profile-pattern) epoch.

        Change-point fix: once the MEASURED schedule shows the job
        switched regimes, the profile's switch point is known wrong, so
        the prior is reweighted to concentrate ``1 - CHANGEPOINT_RETAIN``
        of its mass on the regime the job was last observed in (the
        observed-epoch counts still ride on top and the rebase/subtract
        in the callers is unchanged). Without a measured switch — every
        static job — the posterior is bit-identical to the unweighted
        math."""
        observed = self.epoch_batch_sizes[: self.completed_epochs + 1]
        counts = {
            int(bs): int(np.sum(observed == bs)) for bs in np.unique(observed)
        }
        prior = self.dirichlet
        last_bs, switched = self._measured_changepoint()
        if switched and last_bs in self.dirichlet and len(self.dirichlet) > 1:
            total = float(sum(self.dirichlet.values()))
            spread = CHANGEPOINT_RETAIN * total / len(self.dirichlet)
            prior = {bs: spread for bs in self.dirichlet}
            prior[last_bs] += (1.0 - CHANGEPOINT_RETAIN) * total
        return counts, {
            bs: conc + counts.get(bs, 0) for bs, conc in prior.items()
        }

    def remaining_runtime(self) -> float:
        """Expected remaining runtime under the Dirichlet regime posterior
        (reference: job_metadata.py:167-202).

        Posterior = prior + one count per observed epoch (including the
        in-progress one); rebased so the concentrations sum to total_epochs;
        observed epochs are then subtracted back out (floored at zero); what
        remains is the expected number of future epochs in each regime,
        priced at that regime's mean epoch duration.
        """
        if len(self.dirichlet) == 0 or self.completed_epochs >= self.total_epochs:
            return 1.0
        counts, posterior = self._regime_posterior()
        total_conc = sum(posterior.values())
        rebased = {
            bs: self.total_epochs * conc / total_conc for bs, conc in posterior.items()
        }
        for bs, n in counts.items():
            rebased[bs] = max(0.0, rebased[bs] - n)
        durations = self.bs_epoch_durations()
        expected = float(sum(rebased[bs] * durations[bs] for bs in rebased))
        # Floor at 1 s: an incomplete job always has work left. A
        # single-epoch job would otherwise predict exactly 0 (its
        # in-progress epoch is counted as observed and subtracted back
        # out), which zeroes the planner's finish-time estimate — latent
        # in the reference, whose traces have no 1-epoch jobs.
        return max(1.0, expected)

    def remaining_runtime_to_completion(
        self, run_time_so_far_s: float, base: Optional[float] = None
    ) -> float:
        """Remaining processing seconds from NOW to job completion.

        :meth:`remaining_runtime` prices only the epochs AFTER the
        in-progress one (the reference counts the in-progress epoch as
        observed and subtracts it from the posterior, job_metadata.py:
        167-202) — correct for the planner's horizon math but short by
        up to one epoch as a now-to-finish forecast. For calibration
        scoring against realized processing time, add back the
        unfinished remainder of the in-progress epoch, estimated from
        the processing seconds the job has already received.

        ``base`` lets a caller that already evaluated
        :meth:`remaining_runtime` (the posterior math is not memoized)
        avoid recomputing it.
        """
        if self.completed_epochs >= self.total_epochs:
            return 0.0
        done = float(np.sum(self.epoch_durations[: self.completed_epochs]))
        idx = min(self.completed_epochs, len(self.epoch_durations) - 1)
        current = float(self.epoch_durations[idx])
        into_epoch = min(max(float(run_time_so_far_s) - done, 0.0), current)
        if base is None:
            base = self.remaining_runtime()
        return base + (current - into_epoch)

    def remaining_runtime_interval(
        self, z: float = 1.645, mean: Optional[float] = None
    ):
        """(lo, hi) credible interval around :meth:`remaining_runtime`
        from the Dirichlet regime posterior — the uncertainty the
        calibration tracker scores coverage against.

        The regime mixture p ~ Dirichlet(alpha) prices one future epoch
        at sum_b p_b * d_b, whose closed-form variance is
        (sum_b a_b d_b^2 / a0 - mu^2) / (a0 + 1); over n remaining
        epochs (shared p) the runtime std is n * sqrt(var). The half
        width is floored at one mean epoch duration and 5% of the mean:
        a single-regime posterior has zero Dirichlet variance but its
        durations still carry >=1s rounding and rescale error, and a
        degenerate interval would score 0% coverage on forecasts that
        are in fact near-exact. ``mean`` takes a pre-computed
        :meth:`remaining_runtime` value (same contract as
        :meth:`remaining_runtime_to_completion`'s ``base``).
        """
        if mean is None:
            mean = self.remaining_runtime()
        if len(self.dirichlet) == 0 or self.completed_epochs >= self.total_epochs:
            return mean, mean
        _, posterior = self._regime_posterior()
        alpha0 = sum(posterior.values())
        durations = self.bs_epoch_durations()
        mu = sum(posterior[bs] * durations[bs] for bs in posterior) / alpha0
        second_moment = (
            sum(posterior[bs] * durations[bs] ** 2 for bs in posterior)
            / alpha0
        )
        var_per_epoch = max(second_moment - mu * mu, 0.0) / (alpha0 + 1.0)
        n_remaining = max(self.total_epochs - (self.completed_epochs + 1), 0)
        std = n_remaining * float(np.sqrt(var_per_epoch))
        half = max(z * std, self.mean_epoch_duration(), 0.05 * mean)
        return max(mean - half, 0.0), mean + half


def batch_remaining_runtimes(metadatas: Sequence[JobMetadata]) -> np.ndarray:
    """Remaining runtimes for a set of jobs as one array (round-prep path)."""
    return np.array([m.remaining_runtime() for m in metadatas], dtype=np.float64)
