"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU (the
counterpart of the ``JAX_PLATFORMS=cpu`` the JAX package's tests set). A
CUDA request on a host without a card raises: nothing carries on quietly
on the CPU.

float32 matrix products and convolutions run in full float32: TF32 is
switched off for both cuBLAS and cuDNN (PyTorch leaves cuDNN's on by
default). TF32 keeps about three decimal digits, and the port is held to
the JAX package's float32 results.
"""

from __future__ import annotations

import torch


def full_precision_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (card 0 unless an index is given) or ``"cpu"``."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", 0)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    full_precision_f32()
    return device
