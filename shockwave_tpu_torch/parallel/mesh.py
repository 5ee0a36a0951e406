"""Device meshes for the port's parallel paths.

The counterpart of ``shockwave_tpu/parallel/mesh.py``. A mesh is a grid
of ``torch.device``s over the framework's standard axes:
  "data"  - batch (data parallelism);
  "model" - tensor parallelism (attention heads);
  "seq"   - sequence parallelism (ring attention shards);
  "pipe"  - pipeline parallelism.

One process drives the whole grid, as ``shard_map`` drives its mesh: ring
attention (``parallel/ring_attention.py``) puts each shard on its mesh
device and steps the shards in lockstep. A device may stand in more than
one place, so one card can hold a P-shard ring, as the JAX package's
tests hold a ring on virtual CPU devices. A mesh over several processes
(``torch.distributed``) is a later slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("data", "model", "seq", "pipe")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` with one dimension
    per name of ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXES

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, **index) -> torch.device:
        """The device at the given axis indices (0 on the others)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over (data, model, seq[, pipe]). A 3-tuple shape gets a
    trailing pipe axis of 1. ``devices`` lists one device per place of the
    grid, repeats allowed; by default every visible card, each once. The
    default shape puts all of them on "data"."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh without devices takes the visible cards, and "
                "torch.cuda.is_available() is False; pass the devices"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n, 1, 1, 1)
    shape = tuple(shape) + (1,) * (len(AXES) - len(shape))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), AXES)


def factorize_gang(
    num_devices: int,
    seq_parallel: int = 1,
    model_parallel: int = 1,
    pipe_parallel: int = 1,
):
    """(data, model, seq, pipe) shape for a gang of ``num_devices``."""
    denom = seq_parallel * model_parallel * pipe_parallel
    if num_devices % denom != 0:
        raise ValueError(
            f"{num_devices} devices not divisible by model={model_parallel} "
            f"x seq={seq_parallel} x pipe={pipe_parallel}"
        )
    return (
        num_devices // denom,
        model_parallel,
        seq_parallel,
        pipe_parallel,
    )
