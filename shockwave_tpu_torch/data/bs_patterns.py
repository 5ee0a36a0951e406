"""Dynamic-adaptation batch-size schedules (Accordion and GNS).

The reference encodes these schedules as a large if/else tree per
(model, batch size, scale factor) (reference: scheduler/utils.py:635-1180).
Here the same schedules are data tables:

* Accordion: per-model "critical regime" epoch sets during which the job
  trains at its original batch size; outside the critical regime (and past
  the first 30% of training) the batch size jumps to the model's maximum.
* GNS (gradient-noise-scale): batch size doubles in steps at fixed epoch
  boundaries, clamped to the model's profiled maximum. Encoded as
  ``(first_epoch, multiplier)`` breakpoints; each multiplier applies from
  its epoch until the next breakpoint.

A quirk of the reference generator is preserved because committed traces
depend on it: within a GNS schedule, the *final* epoch keeps the base batch
size unless it falls in the first breakpoint's range (the reference's later
loops break before assigning the last epoch, utils.py:743-747 vs 749-752).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from shockwave_tpu_torch.data.workload_info import MAX_BATCH_SIZES, parse_job_type

# -- Accordion ---------------------------------------------------------------

# Head critical-regime length keyed by original batch size.
_ACCORDION_HEAD = {
    "ResNet-18": {16: 10, 32: 10, 64: 10, 128: 10, 256: 20},
    "LM": {None: 10},
    "Recommendation": {512: 30, 1024: 30, 2048: 40, 4096: 10, 8192: 10},
}

# Extra mid-training critical windows used by the trace *generator* only
# (the run-time adaptation check below intentionally differs; see
# reference utils.py:656-667 vs :691-712).
_ACCORDION_GENERATOR_WINDOWS = {
    "ResNet-18": [(150, 160), (250, 260)],
    "Recommendation": [(60, 70), (80, 90)],
}

_ACCORDION_EXEMPT = ("Transformer", "CycleGAN", "A3C")


def _head_length(model: str, original_bs: int) -> int:
    heads = _ACCORDION_HEAD[model]
    head = heads.get(original_bs, heads.get(None))
    if head is None:
        raise KeyError((model, original_bs))
    return head


def accordion_in_critical_regime(model: str, original_bs: int, epoch: int) -> bool:
    """Run-time critical-regime check used by the simulator's Accordion
    adaptation (reference: scheduler/utils.py:691-712). Note ResNet-18 keeps
    its mid-training windows here but Recommendation does not."""
    if model == "ResNet-50":
        return (epoch % 30) < 10
    if epoch < _head_length(model, original_bs):
        return True
    if model == "ResNet-18":
        return any(lo <= epoch < hi for lo, hi in ((150, 160), (250, 260)))
    return False


def _generator_in_critical_regime(model: str, original_bs: int, epoch: int) -> bool:
    if model == "ResNet-50":
        return epoch < 600 and (epoch % 30) < 10
    if epoch < _head_length(model, original_bs):
        return True
    windows = _ACCORDION_GENERATOR_WINDOWS.get(model, [])
    return any(lo <= epoch < hi for lo, hi in windows)


def accordion_pattern(
    job_type: str, initial_batch_size: int, num_epochs: int
) -> List[int]:
    """Per-epoch batch sizes under Accordion
    (reference: scheduler/utils.py:635-688)."""
    return list(_accordion_pattern(job_type, initial_batch_size, num_epochs))


@functools.lru_cache(maxsize=4096)
def _accordion_pattern(
    job_type: str, initial_batch_size: int, num_epochs: int
) -> Tuple[int, ...]:
    model, _ = parse_job_type(job_type)
    schedule = [initial_batch_size] * num_epochs
    if model in _ACCORDION_EXEMPT:
        return tuple(schedule)
    max_bs = MAX_BATCH_SIZES.get(model, initial_batch_size)
    for epoch in range(num_epochs):
        in_critical = _generator_in_critical_regime(model, initial_batch_size, epoch)
        # The first 30% of training always counts as critical to preserve
        # final accuracy (reference: utils.py:683-686).
        if not in_critical and epoch > num_epochs * 0.3:
            schedule[epoch] = max_bs
    return tuple(schedule)


# -- GNS ---------------------------------------------------------------------

# (model, batch_size, scale_factor) -> list of (first_epoch, multiplier)
# breakpoints. The schedule only activates when num_epochs exceeds the first
# breakpoint's epoch.
_GNS_BREAKPOINTS = {
    ("ResNet-18", 16, 1): [(31, 2), (41, 4), (51, 8), (71, 16)],
    ("ResNet-18", 32, 1): [(21, 2), (31, 4), (51, 8)],
    ("ResNet-18", 64, 1): [(11, 2), (31, 4)],
    ("ResNet-18", 128, 1): [(11, 2)],
    ("ResNet-18", 16, 2): [(21, 2), (31, 4), (91, 8), (111, 16)],
    ("ResNet-18", 32, 2): [(11, 2), (21, 4), (41, 8)],
    ("ResNet-18", 64, 2): [(21, 2), (41, 4)],
    ("ResNet-18", 128, 2): [(41, 2)],
    ("ResNet-18", 16, 4): [(11, 2), (21, 4), (81, 8), (91, 16)],
    ("ResNet-18", 32, 4): [(21, 2), (31, 4), (61, 8)],
    ("ResNet-18", 64, 4): [(11, 2), (61, 4)],
    ("ResNet-18", 128, 4): [(11, 2)],
    ("ResNet-50", 64, 1): [(101, 2)],
    ("ResNet-50", 32, 2): [(101, 2), (111, 4)],
    ("ResNet-50", 64, 2): [(81, 2)],
    ("ResNet-50", 32, 4): [(131, 2), (221, 4)],
    ("ResNet-50", 64, 4): [(191, 2)],
    ("LM", 5, 1): [(31, 2), (41, 4), (61, 8), (71, 16)],
    ("LM", 10, 1): [(11, 2), (21, 4), (41, 8)],
    ("LM", 20, 1): [(11, 2), (41, 4)],
    ("LM", 40, 1): [(11, 2)],
    ("LM", 5, 2): [(31, 2), (51, 4), (61, 8), (71, 16)],
    ("LM", 10, 2): [(11, 2), (31, 4), (41, 8)],
    ("LM", 20, 2): [(31, 2), (41, 4)],
    ("LM", 40, 2): [(11, 2)],
    ("LM", 5, 4): [(11, 2), (31, 4), (71, 8), (91, 16)],
    ("LM", 10, 4): [(11, 2), (31, 4), (61, 8)],
    ("LM", 20, 4): [(11, 2), (61, 4)],
    ("LM", 40, 4): [(61, 2)],
    ("Recommendation", 512, 1): [(21, 2), (41, 4), (71, 8), (91, 16)],
    ("Recommendation", 1024, 1): [(21, 2), (51, 4), (91, 8)],
    ("Recommendation", 2048, 1): [(21, 2), (41, 4)],
    ("Recommendation", 4096, 1): [(41, 2)],
}

_GNS_EXEMPT = ("Transformer", "CycleGAN", "A3C")


def gns_pattern(
    job_type: str, batch_size: int, num_epochs: int, scale_factor: int
) -> List[int]:
    """Per-epoch batch sizes under GNS doubling
    (reference: scheduler/utils.py:714-1180)."""
    return list(_gns_pattern(job_type, batch_size, num_epochs, scale_factor))


# The simulator re-derives the schedule for every adaptive job every
# round (scheduler._simulate_gns); the patterns are pure functions of
# their arguments, so memoize (15k+ recomputes per 900-job trace
# otherwise dominate the sim profile).
@functools.lru_cache(maxsize=4096)
def _gns_pattern(
    job_type: str, batch_size: int, num_epochs: int, scale_factor: int
) -> Tuple[int, ...]:
    model, _ = parse_job_type(job_type)
    schedule = [batch_size] * num_epochs
    if model in _GNS_EXEMPT:
        return tuple(schedule)
    breakpoints = _GNS_BREAKPOINTS.get((model, batch_size, scale_factor))
    if breakpoints is not None and num_epochs > breakpoints[0][0]:
        starts = [bp for bp, _ in breakpoints] + [num_epochs]
        for i, (start, mult) in enumerate(breakpoints):
            end = min(starts[i + 1], num_epochs)
            for epoch in range(start, end):
                # Reference quirk: only the first breakpoint's loop scales
                # the final epoch; later loops break before assigning it.
                if i > 0 and epoch + 1 >= num_epochs:
                    break
                schedule[epoch] = batch_size * mult
    limit = MAX_BATCH_SIZES[model]
    return tuple(min(bs, limit) for bs in schedule)


def pattern_for_mode(
    mode: str, job_type: str, batch_size: int, num_epochs: int, scale_factor: int
) -> List[int]:
    if mode == "accordion":
        return accordion_pattern(job_type, batch_size, num_epochs)
    if mode == "gns":
        return gns_pattern(job_type, batch_size, num_epochs, scale_factor)
    return [batch_size] * num_epochs
