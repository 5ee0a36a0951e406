"""Device meshes for the port's parallel paths.

The counterpart of ``shockwave_tpu/parallel/mesh.py``. A mesh is a grid
of ``torch.device``s over the framework's standard axes:
  "data"  - batch (data parallelism);
  "model" - tensor parallelism (attention heads);
  "seq"   - sequence parallelism (ring attention shards);
  "pipe"  - pipeline parallelism.

Two kinds of mesh. A :class:`Mesh` is one process's grid: ring attention
(``parallel/ring_attention.py``) puts each shard on its mesh device and
steps the shards in lockstep, as ``shard_map`` drives its mesh. A device
may stand in more than one place, so one card can hold a P-shard ring, as
the JAX package's tests hold a ring on virtual CPU devices.

A :class:`ProcessMesh` spans a gang's processes (``torch.distributed``),
one place a process, as the JAX program's mesh spans its gang's devices
(``factorize_gang`` over the world, ranks in row-major order over
(data, model, seq, pipe)). Each axis that crosses processes has its own
process group, and the mesh carries the few collectives the parallel
bodies need (a ring shift, an all-to-all, sums and gathers, each over the
whole gang or over one axis's group). With a model or pipe axis, the
ranks that hold the same tokens' other shards (one model and pipe place,
every data and seq place) have a group too: the MoE's global routing and
a sharded parameter's gradient average run over it. The gang's
group is gloo's (``models/train.py::rendezvous``), which moves host
tensors, so a tensor on a card travels through pinned host memory
(:func:`to_host`); the gang's own collectives stage the same way
(:func:`collective_in_place`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("data", "model", "seq", "pipe")
# The ranks that hold one model and pipe place and every data and seq
# place: the gang's token shards (``ProcessMesh.group``).
TOKENS = "tokens"


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


def visible_devices(device) -> List[torch.device]:
    """The devices a one-process mesh can take beside ``device``: every
    visible card for a card, the CPU alone for the CPU (the JAX package's
    ``jax.devices()``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def make_solve_mesh(devices: Sequence, axis_name: str = "solve") -> Mesh:
    """A 1-D mesh of one place a device of ``devices`` (repeats allowed:
    one card in P places), the JAX package's ``Mesh(devices,
    (axis_name,))`` of its sharded solves and lane splits."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a solve mesh needs at least one device")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (axis_name,))


def axis_devices(mesh: Mesh, axis_name: str) -> List[torch.device]:
    """The devices along ``axis_name`` of a mesh whose other axes have
    one place each, in axis order."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no "
                         f"{axis_name!r}")
    grid = np.asarray(mesh.devices)
    places = grid.shape[mesh.axis_names.index(axis_name)]
    if grid.size != places:
        raise ValueError(f"mesh {mesh.shape}: only {axis_name!r} may have "
                         "more than one place")
    return [torch.device(d) for d in grid.reshape(-1)]


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


def to_host(tensor: torch.Tensor) -> torch.Tensor:
    """What gloo moves for ``tensor`` (contiguous): a pinned host copy
    when it lies on a card, else the tensor itself."""
    tensor = tensor.contiguous()
    if tensor.device.type != "cuda":
        return tensor
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    return host


def collective_in_place(op, tensor: torch.Tensor, *args) -> torch.Tensor:
    """``op(tensor, *args)``, a ``torch.distributed`` collective that
    writes its result into its tensor, on ``tensor`` through
    :func:`to_host`; returns ``tensor``."""
    staged = to_host(tensor)
    op(staged, *args)
    if staged.data_ptr() != tensor.data_ptr():
        tensor.copy_(staged)
    return tensor


def _place_of(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A rank's index on each axis: ranks fill the grid row-major, as
    ``make_mesh`` fills it with ``jax.devices()`` (process-major)."""
    return tuple(int(i) for i in np.unravel_index(rank, shape))


@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """One process's place on a mesh over the gang's processes.

    ``shape`` is the global (data, model, seq, pipe) grid, ``rank`` and
    ``world`` the default group's. ``groups[axis]`` is the process group
    of this rank's line along ``axis`` (the ranks that differ from it only
    there), ``members[axis]`` their global ranks in axis order; an axis of
    size 1 has neither. ``groups[TOKENS]`` and ``members[TOKENS]`` are
    those of the ranks that differ from it only in data and seq, where
    they are neither one rank nor the world."""

    shape: Tuple[int, ...]
    rank: int
    world: int
    groups: Dict[str, object]
    members: Dict[str, List[int]]
    axis_names: Tuple[str, ...] = AXES

    @property
    def sizes(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.shape))

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return _place_of(self.rank, self.shape)[self.axis_names.index(axis)]

    # -- collectives (through host memory, :func:`to_host`) ----------

    def _back(self, staged: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return staged.to(like.device, non_blocking=True)

    def shift_start(self, tensors: Sequence[torch.Tensor], axis: str,
                    step: int):
        """Posts one ring shift along ``axis``: each tensor goes to the
        rank ``step`` places on, and the same shapes come from the rank
        ``step`` places back. Returns the pending exchange, for
        :meth:`shift_wait`; the caller may launch work in between."""
        import torch.distributed as dist

        members = self.members[axis]
        n = len(members)
        me = self.index(axis)
        dst, src = members[(me + step) % n], members[(me - step) % n]
        group = self.groups[axis]
        sends = [to_host(t) for t in tensors]
        recvs = [torch.empty_like(s) for s in sends]
        works = []
        for s, r in zip(sends, recvs):
            works += [dist.isend(s, dst, group=group),
                      dist.irecv(r, src, group=group)]
        return works, sends, recvs, list(tensors)

    def shift_wait(self, pending) -> List[torch.Tensor]:
        """The tensors a :meth:`shift_start` received, on the device of
        what it sent."""
        works, _sends, recvs, like = pending
        for work in works:
            work.wait()
        return [self._back(r, t) for r, t in zip(recvs, like)]

    def shift(self, tensors: Sequence[torch.Tensor], axis: str,
              step: int) -> List[torch.Tensor]:
        return self.shift_wait(self.shift_start(tensors, axis, step))

    def all_to_all(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """``tensor``'s equal pieces along dim 0 go one to each rank of
        ``axis`` in axis order; returns the pieces received, stacked in
        source order."""
        import torch.distributed as dist

        staged = to_host(tensor)
        out = torch.empty_like(staged)
        dist.all_to_all_single(out, staged, group=self.groups[axis])
        return self._back(out, tensor)

    def group(self, over=None):
        """(process group, ranks in it) of ``over``: None for every rank
        (the default group), an axis name for this rank's line along it,
        or ``TOKENS`` for the ranks that share its model and pipe places.
        A group of one rank is (None, 1)."""
        if over is None:
            return None, self.world
        if over == TOKENS:
            size = self.sizes["data"] * self.sizes["seq"]
            if size == self.world:
                return None, self.world
        else:
            size = self.sizes[over]
        if size == 1:
            return None, 1
        return self.groups[over], size

    def all_reduce(self, tensor: torch.Tensor, over=None,
                   op: str = "sum") -> torch.Tensor:
        """``tensor`` reduced (``op`` "sum" or "max") over the ranks of
        ``over`` (:meth:`group`; every rank by default), as a new
        tensor."""
        import torch.distributed as dist

        group, size = self.group(over)
        staged = to_host(tensor.detach())
        if staged.data_ptr() == tensor.data_ptr():
            staged = staged.clone()  # the sum must not land in ``tensor``
        if size > 1:
            dist.all_reduce(staged, op=getattr(dist.ReduceOp, op.upper()),
                            group=group)
        return self._back(staged, tensor)

    def all_gather(self, tensor: torch.Tensor, over=None) -> torch.Tensor:
        """The ``tensor`` of every rank of ``over`` (:meth:`group`; every
        rank by default), stacked in their order along a new dim 0."""
        import torch.distributed as dist

        group, size = self.group(over)
        staged = to_host(tensor.detach())
        parts = [torch.empty_like(staged) for _ in range(size)]
        if size > 1:
            dist.all_gather(parts, staged, group=group)
        else:
            parts[0].copy_(staged)
        return self._back(torch.stack(parts), tensor)


def make_process_mesh(seq_parallel: int = 1, model_parallel: int = 1,
                      pipe_parallel: int = 1) -> ProcessMesh:
    """The gang's mesh over the default process group:
    ``factorize_gang(world, seq_parallel, model_parallel, pipe_parallel)``,
    one place a rank. Every rank must call it (it creates each axis's
    groups, and ``torch.distributed.new_group`` is collective)."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    shape = factorize_gang(world, seq_parallel, model_parallel,
                           pipe_parallel)
    groups, members = {}, {}
    ranks = np.arange(world).reshape(shape)
    for a, axis in enumerate(AXES):
        if shape[a] == 1:
            continue
        # Every line along the axis gets its group, on every rank, in the
        # same order; this rank keeps its own line's.
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis], members[axis] = group, [int(r) for r in line]
    data, model, seq, pipe = shape
    if 1 < data * seq < world:
        # One plane of (data, seq) a (model, pipe) place.
        planes = np.moveaxis(ranks, (1, 3), (0, 1)).reshape(model * pipe, -1)
        for plane in planes:
            group = dist.new_group([int(r) for r in plane])
            if rank in plane:
                groups[TOKENS] = group
                members[TOKENS] = [int(r) for r in plane]
    return ProcessMesh(shape, rank, world, groups, members)
