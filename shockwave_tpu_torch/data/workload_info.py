"""Static facts about the workload model families.

The scheduler reasons about epochs (dataset passes) and batch-size scaling
limits per model family. These constants mirror the reference's tables
(reference: scheduler/scheduler.py:64-90) so that traces written for the
reference produce identical epoch math here.
"""

# Samples per epoch for each model family (dataset sizes).
DATASET_SIZES = {
    "ResNet-18": 50000,  # cifar10
    "ResNet-50": 100000,  # imagenet subset
    "Transformer": 10000,  # multi30k
    "LM": 59675,  # wikitext2
    "Recommendation": 117907,  # ml-20m
    "CycleGAN": 6287,  # monet2photo
    "A3C": 4,  # no dataset
}

# Largest batch size with profiled throughputs (scaling ceiling).
MAX_BATCH_SIZES = {
    "ResNet-18": 256,
    "ResNet-50": 128,
    "Transformer": 128,
    "LM": 80,
    "Recommendation": 8192,
}

# Smallest profiled batch size (scale-down floor for Accordion).
MIN_BATCH_SIZES = {
    "ResNet-18": 16,
    "ResNet-50": 16,
    "Transformer": 16,
    "LM": 5,
    "Recommendation": 512,
}


def parse_job_type(job_type: str):
    """Split ``"Model (batch size N)"`` into ``(model, batch_size)`` — the
    one place the job_type string encoding is interpreted."""
    return job_type[: job_type.find(" ")], int(
        job_type[job_type.rfind(" ") + 1 : -1]
    )


def steps_per_epoch(model: str, batch_size: int) -> int:
    """Number of optimizer steps in one epoch: ceil(dataset / batch)."""
    size = DATASET_SIZES[model]
    return -(-size // int(batch_size))


def num_epochs(model: str, batch_size: int, num_steps: int) -> int:
    """Epochs covered by ``num_steps`` steps at ``batch_size``
    (reference: scheduler/scheduler.py:3490-3496)."""
    spe = steps_per_epoch(model, batch_size)
    return -(-int(num_steps) // spe)


def total_steps_for_epochs(model: str, batch_size: int, epochs: int) -> int:
    """Steps needed for ``epochs`` full epochs
    (reference: scheduler/scheduler.py:3498-3503)."""
    return int(epochs) * steps_per_epoch(model, batch_size)
