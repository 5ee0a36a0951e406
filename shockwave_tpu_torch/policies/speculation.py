"""Plan-ahead pipelining scaffolding of the Shockwave planner.

The JAX package's ``shockwave_tpu/policies/speculation.py`` solves round
r+1 speculatively while round r runs and reconciles at the boundary.
That is not ported yet (ROADMAP.md, queue 1): here is only the mixin
scaffolding ``ShockwavePlanner`` inherits: ``speculate=True`` raises,
and the boundary's exposed planning time goes to the (telemetry-off)
histogram the reference records it in.
"""

from __future__ import annotations

from shockwave_tpu_torch import obs

_NOT_PORTED = ("plan-ahead pipelining (speculate) is not ported to "
               "shockwave_tpu_torch yet (ROADMAP.md, queue 1)")


class SpeculativePlannerMixin:
    """Speculation knobs and the exposed-boundary histogram."""

    def _init_speculation(self, config: dict) -> None:
        if config.get("speculate"):
            raise NotImplementedError(_NOT_PORTED)

    def _observe_boundary(self, seconds: float) -> None:
        obs.histogram(
            "shockwave_plan_exposed_seconds",
            "boundary planning wall time the round loop waited for",
        ).observe(seconds)
