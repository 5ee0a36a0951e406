from shockwave_tpu_torch.core.ids import JobId
from shockwave_tpu_torch.core.job import Job

__all__ = ["JobId", "Job"]
