"""Synthetic throughput oracle.

The simulator needs an oracle mapping (job type, scale factor) -> steps/s on
each worker type (isolated and co-located). The reference ships measured
JSONs (e.g. ``simulation_throughputs.json``); this module *generates* a
deterministic, realistic oracle from a small analytic performance model so
the framework is self-contained. An externally measured oracle JSON (the
reference's format, see :mod:`shockwave_tpu_torch.data.throughputs`) can always be
supplied instead.

Performance model per family: samples/s on a v100 saturates with batch size
(``samples/s = peak * bs / (bs + half_sat)``); slower worker types apply a
constant relative speed; gang scaling applies a per-doubling efficiency;
space-shared pairs divide throughput according to each family's
utilization pressure.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

from shockwave_tpu_torch.data.workload_info import parse_job_type

# family -> (peak samples/s on v100, half-saturation batch size, utilization)
_FAMILY_MODEL = {
    "ResNet-18": (6500.0, 48.0, 0.55),
    "ResNet-50": (950.0, 24.0, 0.85),
    "Transformer": (2600.0, 40.0, 0.65),
    "LM": (1700.0, 12.0, 0.60),
    "Recommendation": (250000.0, 1500.0, 0.40),
    "CycleGAN": (8.5, 1.0, 0.90),
    "A3C": (20.0, 2.0, 0.25),
}

_WORKER_SPEED = {"v100": 1.0, "p100": 0.58, "k80": 0.22}

# Profiled batch sizes per family (matches the scaling range the batch-size
# adaptation modes can reach).
_FAMILY_BATCH_SIZES = {
    "ResNet-18": [16, 32, 64, 128, 256],
    "ResNet-50": [16, 32, 64, 128],
    "Transformer": [16, 32, 64, 128],
    "LM": [5, 10, 20, 40, 80],
    "Recommendation": [512, 1024, 2048, 4096, 8192],
    "CycleGAN": [1],
    "A3C": [4],
}

_SCALE_FACTORS = [1, 2, 4, 8]
_GANG_EFFICIENCY = 0.92  # per doubling of the gang size


def isolated_steps_per_sec(
    family: str, bs: int, scale_factor: int, worker_type: str
) -> float:
    peak, half_sat, _ = _FAMILY_MODEL[family]
    samples_per_sec = peak * bs / (bs + half_sat)
    gang = scale_factor * (_GANG_EFFICIENCY ** max(0, (scale_factor - 1).bit_length()))
    return _WORKER_SPEED[worker_type] * samples_per_sec * gang / bs


def _pressure(family: str, bs: int) -> float:
    """How hard a (family, batch size) leans on the accelerator."""
    peak, half_sat, util = _FAMILY_MODEL[family]
    return util * (0.7 + 0.6 * bs / (bs + half_sat))


def _sensitivity(family: str, bs: int) -> float:
    """How much a (family, batch size) suffers from a co-located peer."""
    peak, half_sat, util = _FAMILY_MODEL[family]
    return 0.3 + util * (0.6 + 0.8 * bs / (bs + half_sat))


def _pair_factors(
    family_a: str, bs_a: int, family_b: str, bs_b: int
) -> Tuple[float, float]:
    """Fraction of isolated throughput each job keeps when space-shared.
    Depends on BOTH sides (my sensitivity x the peer's pressure) so every
    (family, batch size) has a distinguishable colocation signature — what
    the throughput estimator's cosine matching relies on."""
    fa = 1.0 / (1.0 + _sensitivity(family_a, bs_a) * _pressure(family_b, bs_b))
    fb = 1.0 / (1.0 + _sensitivity(family_b, bs_b) * _pressure(family_a, bs_a))
    return fa, fb


def generate_oracle(
    pair_scale_factors: Tuple[int, ...] = (1, 2),
) -> Dict[str, dict]:
    """Build the full oracle with tuple keys (see data.throughputs)."""
    job_type_keys: List[Tuple[str, int]] = []
    for family, batch_sizes in _FAMILY_BATCH_SIZES.items():
        for bs in batch_sizes:
            for sf in _SCALE_FACTORS:
                job_type_keys.append((f"{family} (batch size {bs})", sf))

    oracle: Dict[str, dict] = {}
    for worker_type in _WORKER_SPEED:
        per_type: dict = {}
        for job_type, sf in job_type_keys:
            family, bs = parse_job_type(job_type)
            per_type[(job_type, sf)] = {
                "null": isolated_steps_per_sec(family, bs, sf, worker_type)
            }
        # Space-sharing entries for same-scale-factor pairs.
        for (jt_a, sf_a), (jt_b, sf_b) in itertools.product(
            job_type_keys, job_type_keys
        ):
            if sf_a != sf_b or sf_a not in pair_scale_factors:
                continue
            fam_a, bs_a = parse_job_type(jt_a)
            fam_b, bs_b = parse_job_type(jt_b)
            fa, fb = _pair_factors(fam_a, bs_a, fam_b, bs_b)
            per_type[(jt_a, sf_a)][(jt_b, sf_b)] = [
                per_type[(jt_a, sf_a)]["null"] * fa,
                per_type[(jt_b, sf_b)]["null"] * fb,
            ]
        oracle[worker_type] = per_type
    return oracle

