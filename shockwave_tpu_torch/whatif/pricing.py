"""Marginal-price admission: a 2-scenario what-if solve per burst.

The port of the JAX package's ``shockwave_tpu/whatif/pricing.py``; the
solves are lanes of one launch of kernel A (``ops/csrc/eg_pdhg.cu``) on
the pricer's ``device``.

Tenant quotas answer "how many pending jobs may you hold"; they cannot
answer "what does admitting this burst *cost the fleet*". The market
formulation can: solve the live planning problem twice — with and
without the burst — and the difference in the incumbents' Nash welfare
IS the burst's externality, the DuaLip-style per-entity price
(PAPERS.md) of letting it in. Both solves are lanes of one
:class:`~shockwave_tpu_torch.whatif.scenario.ScenarioBatch` warm-started
from the live plan, so a pricing decision costs one small batched
dispatch, not two planner rounds.

The pricer is strictly OPTIONAL and strictly BOUNDED: any failure —
no planner state yet, a solve error, or the wall-clock budget blown —
returns a ``fallback`` decision and admission proceeds through the
existing quota-only path unchanged. Pricing can only ever *add* a
rejection reason; it can never block, slow past its budget, or change
the exactly-once token contract (the queue prices a token at most
once, before it enters the ledger).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.solver.eg_problem import EGProblem

logger = logging.getLogger(__name__)

# The welfare's log floor (the JAX package's solver/eg_jax.py::_EPS).
_EPS = 1e-6

# Bounded pricing solve: the decision needs the minimax geometry (who
# must run) and the welfare fill, not a polished residual — 24 cycles
# matches the polish budget polish_relaxed uses.
DEFAULT_PRICING_MAX_CYCLES = 24
DEFAULT_PRICING_BUDGET_S = 0.25
# Noise floor on the rejection test: the with/without lanes are two
# genuinely different truncated f32 solves, so a zero-externality
# burst can price at a small negative delta (observed ~3e-4 on the
# committed fixture vs ~-12 for a real crowding burst). A strict
# `delta < 0` would shed harmless bursts on solver noise.
DEFAULT_PRICING_THRESHOLD = 1e-3
# Circuit breaker: a budget overrun still PAID its wall clock (the
# budget is consulted after the solve — a kernel compile or an
# oversized market cannot be interrupted mid-dispatch), so after this
# many consecutive overruns the pricer stops solving outright and
# abstains for free, re-probing with one real solve every
# _CIRCUIT_PROBE_EVERY batches in case the kernel warmed up or the
# market shrank.
_CIRCUIT_OPEN_AFTER = 3
_CIRCUIT_PROBE_EVERY = 8


@dataclasses.dataclass
class PricingDecision:
    """Outcome of pricing one submission batch. ``action`` is
    ``accept`` / ``reject`` / ``fallback`` (fallback = the quota-only
    path decides, pricing abstains). ``welfare_delta`` is the
    incumbents' Nash-welfare change caused by admitting the burst
    (negative = the burst crowds incumbents out); ``burst_welfare`` the
    burst's own welfare under admission."""

    action: str
    reason: str
    welfare_delta: Optional[float] = None
    burst_welfare: Optional[float] = None
    solve_s: float = 0.0

    def as_record(self) -> dict:
        return {
            "action": self.action,
            "reason": self.reason,
            "welfare_delta": (
                round(self.welfare_delta, 9)
                if self.welfare_delta is not None
                else None
            ),
            "burst_welfare": (
                round(self.burst_welfare, 9)
                if self.burst_welfare is not None
                else None
            ),
            "solve_s": round(self.solve_s, 4),
        }


def burst_problem(problem: EGProblem, jobs: Sequence) -> EGProblem:
    """Append hypothetical (not-yet-admitted) burst rows to the live
    problem. A burst job's demand is its declared ``duration`` (epochs
    synthesized at one-per-round granularity); a job with no declared
    duration conservatively asks for the full planning window — the
    worst case the price must cover. Burst rows are never incumbents
    and carry no relaunch overhead."""
    B = len(jobs)
    dur = max(float(problem.round_duration), 1e-9)
    window = dur * float(problem.future_rounds)
    demand = np.array(
        [
            float(getattr(job, "duration", None) or window)
            for job in jobs
        ]
    )
    epochs = np.maximum(np.round(demand / dur), 1.0)
    zeros = np.zeros(B)
    return dataclasses.replace(
        problem,
        priorities=np.concatenate(
            [
                problem.priorities,
                [
                    float(getattr(job, "priority_weight", 1.0) or 1.0)
                    for job in jobs
                ],
            ]
        ),
        completed_epochs=np.concatenate(
            [problem.completed_epochs, zeros]
        ),
        total_epochs=np.concatenate([problem.total_epochs, epochs]),
        epoch_duration=np.concatenate(
            [problem.epoch_duration, demand / epochs]
        ),
        remaining_runtime=np.concatenate(
            [problem.remaining_runtime, demand]
        ),
        nworkers=np.concatenate(
            [
                problem.nworkers,
                [
                    float(getattr(job, "scale_factor", 1) or 1)
                    for job in jobs
                ],
            ]
        ),
        switch_cost=np.concatenate(
            [
                np.zeros(problem.num_jobs)
                if problem.switch_cost is None
                else np.asarray(problem.switch_cost, np.float64),
                zeros,
            ]
        ),
        incumbent=np.concatenate(
            [
                np.zeros(problem.num_jobs)
                if problem.incumbent is None
                else np.asarray(problem.incumbent, np.float64),
                zeros,
            ]
        ),
    )


def _welfare(
    problem: EGProblem, s: np.ndarray, rows: np.ndarray, norm: float
) -> float:
    """Priority-weighted true-log Nash welfare of ``rows`` under grant
    ``s``, with a FIXED normalization so the with/without comparison
    isolates grant changes (the kernel's own normalization divides by
    each scenario's active-job count, which differs by construction
    here)."""
    s = np.asarray(s, np.float64)
    total = np.maximum(np.asarray(problem.total_epochs, np.float64), _EPS)
    epoch_dur = np.maximum(
        np.asarray(problem.epoch_duration, np.float64), _EPS
    )
    completed = np.asarray(problem.completed_epochs, np.float64)
    dur = max(float(problem.round_duration), 1e-9)
    need_sec = (
        np.maximum(np.asarray(problem.total_epochs) - completed, 0.0)
        * epoch_dur
    )
    xcap = need_sec / dur
    progress = completed / total + (dur / (epoch_dur * total)) * np.minimum(
        s, xcap
    )
    q = np.asarray(problem.priorities, np.float64) / max(norm, 1.0)
    return float(np.sum(rows * q * np.log(progress + _EPS)))


class AdmissionPricer:
    """Prices a submission batch by its marginal Nash-welfare impact.

    ``state_provider`` returns a planner state dict
    (:meth:`ShockwavePlanner.state_dict` — the caller owns snapshot
    safety) or None when no planner exists yet. A burst is ACCEPTED
    when the incumbents' welfare delta is no worse than
    ``-threshold``; REJECTED when the burst's externality exceeds it;
    and every failure mode — including a pricing solve that overran
    ``budget_s`` — abstains with ``fallback`` so the quota-only path
    keeps sole authority."""

    def __init__(
        self,
        state_provider: Callable[[], Optional[dict]],
        threshold: float = DEFAULT_PRICING_THRESHOLD,
        budget_s: float = DEFAULT_PRICING_BUDGET_S,
        max_cycles: int = DEFAULT_PRICING_MAX_CYCLES,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        self._provider = state_provider
        # Where the pricing solves launch (cuda raises without a card).
        self.device = device
        self.threshold = float(threshold)
        self.budget_s = float(budget_s)
        self.max_cycles = int(max_cycles)
        self._clock = clock
        # Circuit-breaker state (GIL-atomic counters; approximate
        # under concurrent handlers, which only shifts WHEN a probe
        # happens, never correctness — every path still abstains).
        self._consecutive_overruns = 0
        self._open_skips = 0

    def price(self, jobs: Sequence) -> PricingDecision:
        t0 = self._clock()
        if self._consecutive_overruns >= _CIRCUIT_OPEN_AFTER:
            self._open_skips += 1
            if self._open_skips % _CIRCUIT_PROBE_EVERY != 0:
                # Open circuit: abstain for free instead of paying
                # another over-budget solve on the admission path.
                decision = PricingDecision(
                    action="fallback", reason="circuit_open"
                )
                obs.counter(
                    "admission_priced_total",
                    "submission batches priced by the marginal-welfare "
                    "admission pricer",
                ).inc(decision=decision.action)
                return decision
        try:
            decision = self._price_inner(list(jobs), t0)
        except Exception as e:
            # Pricing is advisory: any failure must degrade to the
            # quota-only path, loudly (logged + counted), never block
            # admission.
            logger.warning(
                "admission pricing failed (%s: %s); falling back to "
                "quota-only admission",
                type(e).__name__,
                e,
            )
            decision = PricingDecision(
                action="fallback",
                reason=f"error:{type(e).__name__}",
                solve_s=self._clock() - t0,
            )
        if decision.reason == "budget_exceeded":
            self._consecutive_overruns += 1
        elif decision.action in ("accept", "reject"):
            self._consecutive_overruns = 0
            self._open_skips = 0
        obs.counter(
            "admission_priced_total",
            "submission batches priced by the marginal-welfare "
            "admission pricer",
        ).inc(decision=decision.action)
        obs.histogram(
            "admission_pricing_solve_seconds",
            "wall-clock of one 2-scenario marginal-price solve",
        ).observe(decision.solve_s)
        return decision

    def _price_inner(self, jobs: List, t0: float) -> PricingDecision:
        from shockwave_tpu_torch.whatif.scenario import (
            Scenario,
            ScenarioBatch,
            solve_scenarios,
        )
        from shockwave_tpu_torch.whatif.seed import base_problem_from_state

        if not jobs:
            return PricingDecision(
                action="fallback", reason="empty_batch",
                solve_s=self._clock() - t0,
            )
        state = self._provider()
        if state is None:
            return PricingDecision(
                action="fallback", reason="no_planner_state",
                solve_s=self._clock() - t0,
            )
        if isinstance(state, dict) and isinstance(
            state.get("problem"), EGProblem
        ):
            # Pre-built market (the offline whatif CLI prices recorded
            # rounds without a planner restore per query).
            problem = state["problem"]
            s0 = state.get("s0")
        else:
            try:
                problem, _keys, s0 = base_problem_from_state(state)
            except ValueError:
                # No incomplete jobs in the live market: the burst has
                # no incumbents to crowd out — nothing to price.
                return PricingDecision(
                    action="fallback", reason="empty_market",
                    solve_s=self._clock() - t0,
                )
        J, B = problem.num_jobs, len(jobs)
        augmented = burst_problem(problem, jobs)
        if s0 is not None and len(s0) == J:
            from shockwave_tpu_torch.solver.eg_pdhg import _default_s0

            s0_aug = np.concatenate(
                [np.asarray(s0, np.float64), _default_s0(augmented)[J:]]
            )
        else:
            s0_aug = None
        incumbent_rows = np.concatenate([np.ones(J), np.zeros(B)])
        burst_rows = 1.0 - incumbent_rows
        batch = ScenarioBatch(
            augmented,
            [
                Scenario(name="with_burst"),
                Scenario(name="without_burst", job_mask=incumbent_rows),
            ],
            s0=s0_aug,
        )
        s_list, _, _ = solve_scenarios(batch, max_cycles=self.max_cycles,
                                       device=self.device)
        # Fixed normalization (the with-burst market's size x window):
        # the delta then measures grant movement, not the denominator.
        norm = float(J + B) * float(problem.future_rounds)
        w_with = _welfare(augmented, s_list[0], incumbent_rows, norm)
        w_without = _welfare(augmented, s_list[1], incumbent_rows, norm)
        burst_welfare = _welfare(augmented, s_list[0], burst_rows, norm)
        solve_s = self._clock() - t0
        delta = w_with - w_without
        if solve_s > self.budget_s:
            # The answer arrived too late to be load-bearing: a pricer
            # this slow on this fleet must not sit on the admission
            # path — abstain (and keep abstaining until the operator
            # raises the budget or shrinks the market).
            return PricingDecision(
                action="fallback", reason="budget_exceeded",
                welfare_delta=delta, burst_welfare=burst_welfare,
                solve_s=solve_s,
            )
        if delta < -self.threshold:
            return PricingDecision(
                action="reject", reason="negative_externality",
                welfare_delta=delta, burst_welfare=burst_welfare,
                solve_s=solve_s,
            )
        return PricingDecision(
            action="accept", reason="priced",
            welfare_delta=delta, burst_welfare=burst_welfare,
            solve_s=solve_s,
        )

    # -- lane-amortized batch pricing -----------------------------------
    def price_batch(
        self, bursts: Sequence[Sequence], audit: bool = False
    ) -> List[PricingDecision]:
        """Price N queued bursts as lanes of ONE ScenarioBatch launch:
        lane 0 is the live market alone, lane k a masked overlay that
        admits burst k on top of it — one launch of kernel A instead of N
        sequential 2-scenario solves, with identical per-burst
        accept/reject semantics (each burst is judged against the SAME
        no-burst base it would see priced alone, under its own
        sequential normalization). The wall-clock budget covers the
        whole dispatch; an overrun abstains every lane and feeds the
        same circuit breaker :meth:`price` uses. ``audit=True`` stores
        an ``audit_lanes`` report (every lane re-solved unbatched,
        compared bitwise) on ``self.last_batch_audit``."""
        t0 = self._clock()
        bursts = [list(jobs) for jobs in bursts]
        if not bursts:
            return []
        if self._consecutive_overruns >= _CIRCUIT_OPEN_AFTER:
            self._open_skips += 1
            if self._open_skips % _CIRCUIT_PROBE_EVERY != 0:
                decisions = [
                    PricingDecision(
                        action="fallback", reason="circuit_open"
                    )
                    for _ in bursts
                ]
                self._count_batch(decisions, 0.0)
                return decisions
        try:
            decisions = self._price_batch_inner(bursts, t0, audit)
        except Exception as e:
            logger.warning(
                "lane-amortized admission pricing failed (%s: %s); "
                "falling back to quota-only admission",
                type(e).__name__,
                e,
            )
            solve_s = self._clock() - t0
            decisions = [
                PricingDecision(
                    action="fallback",
                    reason=f"error:{type(e).__name__}",
                    solve_s=solve_s,
                )
                for _ in bursts
            ]
        if any(d.reason == "budget_exceeded" for d in decisions):
            # One dispatch, one overrun — however many lanes rode it.
            self._consecutive_overruns += 1
        elif any(d.action in ("accept", "reject") for d in decisions):
            self._consecutive_overruns = 0
            self._open_skips = 0
        self._count_batch(decisions, decisions[0].solve_s)
        return decisions

    def _count_batch(
        self, decisions: List[PricingDecision], solve_s: float
    ) -> None:
        counter = obs.counter(
            "admission_priced_total",
            "submission batches priced by the marginal-welfare "
            "admission pricer",
        )
        for decision in decisions:
            counter.inc(decision=decision.action)
        obs.counter(
            "admission_pricing_lanes_total",
            "burst lanes priced through lane-amortized batch dispatches",
        ).inc(len(decisions))
        obs.histogram(
            "admission_pricing_solve_seconds",
            "wall-clock of one 2-scenario marginal-price solve",
        ).observe(solve_s)

    def _price_batch_inner(
        self, bursts: List[List], t0: float, audit: bool
    ) -> List[PricingDecision]:
        from shockwave_tpu_torch.whatif.scenario import (
            Scenario,
            ScenarioBatch,
            audit_lanes,
            solve_scenarios,
        )
        from shockwave_tpu_torch.whatif.seed import base_problem_from_state

        def all_fallback(reason: str) -> List[PricingDecision]:
            solve_s = self._clock() - t0
            return [
                PricingDecision(
                    action="fallback", reason=reason, solve_s=solve_s
                )
                if jobs
                else PricingDecision(
                    action="fallback", reason="empty_batch",
                    solve_s=solve_s,
                )
                for jobs in bursts
            ]

        live = [k for k, jobs in enumerate(bursts) if jobs]
        if not live:
            return all_fallback("empty_batch")
        state = self._provider()
        if state is None:
            return all_fallback("no_planner_state")
        if isinstance(state, dict) and isinstance(
            state.get("problem"), EGProblem
        ):
            problem = state["problem"]
            s0 = state.get("s0")
        else:
            try:
                problem, _keys, s0 = base_problem_from_state(state)
            except ValueError:
                return all_fallback("empty_market")
        J = problem.num_jobs
        flat: List = []
        spans = []  # k -> (row_lo, row_hi) of burst k's rows
        for k in live:
            spans.append((J + len(flat), J + len(flat) + len(bursts[k])))
            flat.extend(bursts[k])
        B = len(flat)
        augmented = burst_problem(problem, flat)
        if s0 is not None and len(s0) == J:
            from shockwave_tpu_torch.solver.eg_pdhg import _default_s0

            s0_aug = np.concatenate(
                [np.asarray(s0, np.float64), _default_s0(augmented)[J:]]
            )
        else:
            s0_aug = None
        incumbent_rows = np.concatenate([np.ones(J), np.zeros(B)])
        scenarios = [
            Scenario(name="without_burst", job_mask=incumbent_rows)
        ]
        for idx, (lo, hi) in enumerate(spans):
            mask = incumbent_rows.copy()
            mask[lo:hi] = 1.0
            scenarios.append(
                Scenario(name=f"burst_{live[idx]:03d}", job_mask=mask)
            )
        batch = ScenarioBatch(augmented, scenarios, s0=s0_aug)
        s_list, _, _ = solve_scenarios(batch, max_cycles=self.max_cycles,
                                       device=self.device)
        if audit:
            # Bit-exactness contract: every lane of the batched dispatch
            # re-solved standalone and compared bitwise (f32), the same
            # audit the what-if plane ships with.
            self.last_batch_audit = audit_lanes(
                batch,
                s_list,
                indices=tuple(range(len(scenarios))),
                max_cycles=self.max_cycles,
                device=self.device,
            )
        solve_s = self._clock() - t0
        decisions: List[PricingDecision] = [
            PricingDecision(
                action="fallback", reason="empty_batch", solve_s=solve_s
            )
            for _ in bursts
        ]
        over_budget = solve_s > self.budget_s
        for idx, k in enumerate(live):
            lo, hi = spans[idx]
            burst_rows = np.zeros(J + B)
            burst_rows[lo:hi] = 1.0
            # Each burst keeps the normalization it would get priced
            # ALONE ((J + B_k) x window): the lane answers the same
            # question the sequential 2-scenario solve answers, just
            # amortized.
            norm = float(J + (hi - lo)) * float(problem.future_rounds)
            w_with = _welfare(
                augmented, s_list[idx + 1], incumbent_rows, norm
            )
            w_without = _welfare(
                augmented, s_list[0], incumbent_rows, norm
            )
            burst_welfare = _welfare(
                augmented, s_list[idx + 1], burst_rows, norm
            )
            delta = w_with - w_without
            if over_budget:
                decisions[k] = PricingDecision(
                    action="fallback", reason="budget_exceeded",
                    welfare_delta=delta, burst_welfare=burst_welfare,
                    solve_s=solve_s,
                )
            elif delta < -self.threshold:
                decisions[k] = PricingDecision(
                    action="reject", reason="negative_externality",
                    welfare_delta=delta, burst_welfare=burst_welfare,
                    solve_s=solve_s,
                )
            else:
                decisions[k] = PricingDecision(
                    action="accept", reason="priced",
                    welfare_delta=delta, burst_welfare=burst_welfare,
                    solve_s=solve_s,
                )
        return decisions


class PricingCollector:
    """Convoying front for an :class:`AdmissionPricer`: concurrent
    ``price()`` calls (RPC handler threads racing the same drain tick)
    stage their bursts and one leader prices the whole convoy through
    ONE :meth:`AdmissionPricer.price_batch` dispatch; followers block
    and collect their lane's decision. A lone caller pays exactly one
    dispatch — no added latency when idle. Drop-in where a pricer is
    expected (the admission queue only calls ``price``/``price_batch``).
    """

    def __init__(self, pricer: AdmissionPricer, max_lanes: int = 32):
        import threading

        self._pricer = pricer
        self.max_lanes = max(1, int(max_lanes))
        self._lock = threading.Lock()
        self._staged: list = []
        self._leader = False
        self._threading = threading

    def price_batch(self, bursts, audit=False):
        return self._pricer.price_batch(bursts, audit=audit)

    def __getattr__(self, name):
        # Budget/threshold/circuit state reads pass through to the
        # wrapped pricer.
        return getattr(self._pricer, name)

    def price(self, jobs: Sequence) -> PricingDecision:
        entry = [list(jobs), self._threading.Event(), None, None]
        with self._lock:
            self._staged.append(entry)
            if self._leader:
                leader = False
            else:
                self._leader = True
                leader = True
        if not leader:
            entry[1].wait()
            if entry[3] is not None:
                raise entry[3]
            return entry[2]
        try:
            while True:
                with self._lock:
                    convoy = self._staged[: self.max_lanes]
                    self._staged = self._staged[self.max_lanes:]
                    if not convoy:
                        self._leader = False
                        break
                try:
                    decisions = self._pricer.price_batch(
                        [e[0] for e in convoy]
                    )
                    for e, decision in zip(convoy, decisions):
                        e[2] = decision
                        e[1].set()
                except BaseException as exc:
                    for e in convoy:
                        if e[2] is None:
                            e[3] = exc
                        e[1].set()
                    raise
        except BaseException:
            with self._lock:
                self._leader = False
                leftover = self._staged
                self._staged = []
            for e in leftover:
                e[3] = RuntimeError(
                    "pricing convoy leader died before this entry"
                )
                e[1].set()
            raise
        if entry[3] is not None:
            raise entry[3]
        return entry[2]
