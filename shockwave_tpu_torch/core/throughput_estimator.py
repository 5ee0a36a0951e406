"""Online colocation-throughput estimation for unseen job types.

The port of the JAX package's ``shockwave_tpu/core/throughput_estimator.py``,
its completion on an explicit device (``ops/matrix_completion.py``).

A new job is profiled against a random subset of (reference job type,
worker type) colocations; the missing entries of its normalized-throughput
row are filled by low-rank matrix completion against the offline-measured
reference rows, and the job is matched to the nearest reference type by
cosine distance. Reference: scheduler/throughput_estimator.py:1-192; the
PMF dependency is replaced by the masked ALS of
:mod:`shockwave_tpu_torch.ops.matrix_completion`.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from shockwave_tpu_torch.ops.matrix_completion import complete
from shockwave_tpu_torch.utils.device import resolve_device

DEFAULT_MATRIX_COMPLETION_K = 10
DEFAULT_MATRIX_COMPLETION_MU = 1e-2


def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    return 1.0 - float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


class ThroughputEstimator:
    def __init__(
        self,
        oracle_throughputs: dict,
        worker_types: List[str],
        job_types: List,
        num_reference_job_types: int,
        profiling_percentage: float,
        seed: int = 0,
        device="cuda",
    ):
        # Where the completion's solves run (cuda raises without a card).
        self._device = resolve_device(device)
        self._rng = random.Random(seed)
        self._oracle_throughputs = oracle_throughputs
        self._worker_types = worker_types
        self._job_types = job_types
        self._m = len(worker_types)
        self._n = len(job_types)
        self._profiling_percentage = profiling_percentage
        self._build_normalized_throughputs()
        self._pick_reference_job_types(num_reference_job_types)

    def _build_normalized_throughputs(self) -> None:
        """Row per job type: its colocated throughput fraction against
        every job type on every worker type
        (reference: throughput_estimator.py:40-57)."""
        m, n = self._m, self._n
        self._normalized_throughputs = np.zeros((n, m * n), dtype=np.float32)
        for i, job_type in enumerate(self._job_types):
            for j, worker_type in enumerate(self._worker_types):
                per_worker = self._oracle_throughputs[worker_type][job_type]
                for k, other in enumerate(self._job_types):
                    self._normalized_throughputs[i, j * n + k] = (
                        per_worker[other][0] / per_worker["null"]
                    )
        if not (
            self._normalized_throughputs.min() >= 0
            and self._normalized_throughputs.max() <= 1.0
        ):
            raise ValueError("normalized throughputs must lie in [0, 1]")

    def _pick_reference_job_types(self, num_reference_job_types: int) -> None:
        idx = sorted(
            self._rng.sample(range(self._n), num_reference_job_types)
        )
        self._reference_job_types = [self._job_types[i] for i in idx]
        column_idx = [
            i * self._n + j for i in range(self._m) for j in idx
        ]
        self._reference_throughputs = self._normalized_throughputs[
            np.ix_(idx, column_idx)
        ]

    def _profile_job(self, true_job_type) -> Dict[str, dict]:
        """Measure a random ``profiling_percentage`` subset of the job's
        colocations with the reference types
        (reference: throughput_estimator.py:86-99)."""
        i_true = self._job_types.index(true_job_type)
        profiled: Dict[str, dict] = {}
        for i, worker_type in enumerate(self._worker_types):
            profiled[worker_type] = {}
            for j, ref in enumerate(self._reference_job_types):
                if self._rng.uniform(0, 1) <= self._profiling_percentage:
                    ref_col = self._job_types.index(ref)
                    profiled[worker_type][ref] = self._normalized_throughputs[
                        i_true, i * self._n + ref_col
                    ]
        return profiled

    def match_job_to_reference_job(self, true_job_type):
        """Profile, complete, and cosine-match to the nearest reference
        type (reference: throughput_estimator.py:101-173)."""
        profiled = self._profile_job(true_job_type)
        R = self._reference_throughputs
        matrix = np.zeros((R.shape[0] + 1, R.shape[1]), dtype=np.float32)
        matrix[:-1] = R
        mask = np.zeros_like(matrix)
        mask[:-1] = 1.0
        n_ref = len(self._reference_job_types)
        # Iterate in self._worker_types order — the same order the
        # reference rows' column blocks use (the reference implementation
        # iterates sorted(profiled) here, which silently misaligns blocks
        # for non-alphabetical worker_types).
        for i, worker_type in enumerate(self._worker_types):
            for j, ref in enumerate(self._reference_job_types):
                if ref in profiled[worker_type]:
                    matrix[-1, i * n_ref + j] = profiled[worker_type][ref]
                    mask[-1, i * n_ref + j] = 1.0

        if mask.min() == 0:
            matrix = complete(
                matrix,
                mask,
                k=DEFAULT_MATRIX_COMPLETION_K,
                mu=DEFAULT_MATRIX_COMPLETION_MU,
                device=self._device,
            )
        if np.linalg.norm(matrix[-1]) == 0:
            return self._rng.choice(self._reference_job_types)
        distances = [
            (ref, cosine_distance(matrix[i], matrix[-1]))
            for i, ref in enumerate(self._reference_job_types)
        ]
        distances.sort(key=lambda x: x[1])
        return distances[0][0]

    def get_reference_throughputs(self) -> dict:
        """Reference-only colocated oracle in the throughputs-dict format
        (reference: throughput_estimator.py:175-192)."""
        n = len(self._reference_job_types)
        out: dict = {}
        for i, worker_type in enumerate(self._worker_types):
            out[worker_type] = {}
            for j, ref in enumerate(self._reference_job_types):
                out[worker_type][ref] = {}
                for k, other in enumerate(self._reference_job_types):
                    out[worker_type][ref][other] = [
                        self._reference_throughputs[j, i * n + k],
                        self._reference_throughputs[k, i * n + j],
                    ]
        return out
