"""Time-varying accelerator price schedules (the port's copy of the JAX
package's ``shockwave_tpu/data/spot_prices.py``).

Capability parity with the reference's spot-price machinery
(reference: scheduler/utils.py:300-420 reads AWS/Azure price logs and
resolves the latest price at the current simulation time; the log data
itself is stripped from the reference snapshot). Here the same
capability takes a plain JSON schedule:

    {"v100": [[0, 0.74], [3600, 0.69], ...],   # [time_s, $/hr] pairs
     "p100": 0.43}                              # or a constant

``latest_price`` resolves the most recent price at or before ``t``
(the first listed price applies before the first timestamp).
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Union

PriceSchedule = Union[float, list]


def read_price_schedules(path: str) -> Dict[str, PriceSchedule]:
    with open(path) as f:
        schedules = json.load(f)
    for worker_type, schedule in schedules.items():
        if isinstance(schedule, list):
            if not schedule:
                raise ValueError(f"empty price schedule for {worker_type!r}")
            schedules[worker_type] = sorted(
                [[float(t), float(p)] for t, p in schedule]
            )
    return schedules


def latest_price(
    schedules: Dict[str, PriceSchedule], worker_type: str, t: float
) -> float:
    schedule = schedules.get(worker_type, 0.0)
    if not isinstance(schedule, list):
        return float(schedule)
    times = [entry[0] for entry in schedule]
    idx = bisect.bisect_right(times, t) - 1
    return float(schedule[max(idx, 0)][1])
