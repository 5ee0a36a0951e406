"""Allocation-policy base class (the part of the JAX package's
``shockwave_tpu/policies/base.py`` the Shockwave policy inherits; the
LP-policy machinery is not ported: ROADMAP.md, queue 1)."""

from __future__ import annotations


class Policy:
    """A named policy; the scheduler dispatches on ``name``."""

    name: str = "Policy"
