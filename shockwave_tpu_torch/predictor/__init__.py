"""Dynamic-adaptation predictor (reference: scheduler/job_metadata.py)."""

from shockwave_tpu_torch.predictor.metadata import JobMetadata, batch_remaining_runtimes

__all__ = ["JobMetadata", "batch_remaining_runtimes"]
