"""A lease bounds how long a dispatched micro-task may run: whichever of
(max_steps, max_duration) is hit first ends it. Reference:
scheduler/lease.py:1-23."""

from __future__ import annotations

import dataclasses

INFINITY = 1_000_000_000


@dataclasses.dataclass
class Lease:
    max_steps: int
    max_duration: float

    def update(self, max_steps: int, max_duration: float) -> None:
        self.max_steps = int(max_steps)
        self.max_duration = float(max_duration)
