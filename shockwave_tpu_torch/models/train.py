"""Training program for every workload family, in PyTorch.

The port's counterpart of ``shockwave_tpu/models/train.py``, the process
the scheduler's dispatcher launches on a worker:

  python -m shockwave_tpu_torch.models.train --model ResNet-18 \
      --batch_size 32 -n <steps> --checkpoint_dir <dir> [--device cpu]

Families: ``Transformer`` (``models/transformer.py``: dense or MoE MLP,
``--remat``, ``--logit_chunk``), ``ResNet-18`` and ``ResNet-50``
(``models/resnet.py``), ``LM``, ``Recommendation``, ``A3C`` and
``CycleGAN`` (``models/small_models.py``). Same flags, the same synthetic
batches (``np.random.default_rng`` drawn exactly as the JAX program draws
them, images NHWC as there and permuted to NCHW after the draw), the same
``[<family>] steps=N loss=... throughput=... steps/s`` line (which then
names the device the run resolved, as ``device=cuda``) and the same
``SHOCKWAVE_PHASE_TIMINGS`` PHASES line. It runs on CUDA unless
``--device cpu`` is given, and raises when CUDA is asked for and absent.
On a card it also prints the flash kernels' launch counts (``LAUNCHES
{...}``).

One ``FusedAdamW`` steps every trained parameter (ResNet's running
statistics are buffers, updated by the forward). CycleGAN trains the
generator and the discriminator on one objective, ``gen_loss +
disc_loss``, in one step, as the JAX program does: the fake image is
detached only inside the discriminator's loss.

Checkpoint (``--checkpoint_dir``): ``--ckpt_backend msgpack`` (the
default) writes ``train_state.pt`` (model and optimizer state and the
steps taken so far) beside the final path and renames it into place;
``--ckpt_backend orbax`` writes a directory checkpoint with
``torch.distributed.checkpoint`` (one process) at ``orbax_state``, the
JAX program's path, as a link swapped onto a complete version directory.
Either way a kill mid-save keeps the previous good checkpoint, an
unreadable one fails the run, and a run that finds one restores it
before its first step and prints ``RESUMED from <path> at step N``.

Under the scheduler (``--enable_shockwave_iterator`` with
``SHOCKWAVE_JOB_ID`` set by the dispatcher) the batches come through the
leased iterator (``runtime/iterator.py``): the run ends when its lease
expires or its ``-n`` steps are done, saves its checkpoint either way, and
the iterator's progress line tells the dispatcher how far it got.

``--attention ring --seq_parallel P`` and ``--attention ulysses
--seq_parallel P`` run ring or Ulysses attention over a mesh built as the
JAX program builds it: ``factorize_gang`` over the devices the run holds
(one card, or the CPU, so P must divide their count), or in a gang over
its processes (``parallel/mesh.py::make_process_mesh``: data x seq, ranks
row-major). There each rank holds one sequence shard of its data group's
batch, and its tokens take their global positions.

A gang (``--distributed_addr host:port --num_workers W --worker_rank r``,
appended by the scheduler) trains data-parallel, as the JAX
program's gang trains over ``jax.distributed``: every rank builds the same
weights from ``--seed``, draws its own ``--batch_size`` batch from
``--seed + r`` (the global batch is W of them), and takes the step of the
mean loss over the global batch: the gradients are averaged across the
ranks, BatchNorm normalises with the global batch's statistics, and the
reported loss is the global mean, so every rank prints the same losses
and holds the same parameters (``GANG rank=r world=W params=<digest>
losses=[...]``). The
rendezvous fails after ``--distributed_timeout`` seconds (rounded up)
when a rank is missing. Rank 0 writes the checkpoint; every rank
restores it and then takes rank 0's state. ``--gang_device cpu`` runs the ranks on the host's CPU
whatever ``--device`` says, as the card driver runs gangs. With
``--seq_parallel P`` a gang's W ranks form W / P data groups of P
sequence shards: a group's ranks draw the same batch from ``--seed + d``
(d the group's index), so the global batch is the groups' draws in rank
order, and gradients and the loss are averaged over every rank. (The JAX
program draws from ``--seed + rank`` and declares the batch replicated
across a seq group, whose copies then differ: a defect of the reference,
ROADMAP.md, queue 3.) The MoE MLP routes the global batch as one problem
(``models/transformer.py::MoEMlp``). The backend is gloo, for ranks on
the CPU and on cards alike (tensors on a card travel through pinned host
memory); the ``MESH backend=`` line names it.

``--model_parallel M`` in a gang makes the Transformer tensor- and
expert-parallel over the mesh's model axis (``models/transformer.py``,
``parallel/tensor.py``): a data group's model and seq ranks share its
draw, each rank trains its share of the heads, the MLP, the vocabulary
and the experts, a sharded parameter's gradient is averaged over the
ranks that hold the same share (data x seq) and a whole one's over every
rank. The checkpoint holds whole parameters, gathered over "model" (the
file one process writes), and a resume takes each rank's share of them,
so an attempt may resume under another gang shape. The GANG line's digest
is the whole parameters'. Without a gang, ``--model_parallel M`` raises
the JAX program's error: one device does not divide over M.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
import warnings

import numpy as np
import torch

from shockwave_tpu_torch.models import small_models as sm
from shockwave_tpu_torch.models.layers import FlaxBatchNorm2d
from shockwave_tpu_torch.models.resnet import ResNet18, ResNet50
from shockwave_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    gather_state,
    lm_loss,
    model_shard_dim,
    shard_state,
)
from shockwave_tpu_torch.ops.fused_adamw import FusedAdamW
from shockwave_tpu_torch.parallel.mesh import (
    TOKENS,
    ProcessMesh,
    factorize_gang,
    collective_in_place,
    make_mesh,
    make_process_mesh,
)
from shockwave_tpu_torch.parallel.tensor import AXIS, model_parallel
from shockwave_tpu_torch.utils.device import resolve_device

CHECKPOINT_NAME = "train_state.pt"
DIRECTORY_CHECKPOINT_NAME = "orbax_state"
# What torch.distributed.checkpoint warns on every call without a process
# group; one process is what the directory checkpoint means.
_ONE_PROCESS = ".*single process"
FAMILIES = ("Transformer", "ResNet-18", "ResNet-50", "LM", "Recommendation",
            "A3C", "CycleGAN")


# jax.distributed's rendezvous timeout when the scheduler sets none.
DEFAULT_RENDEZVOUS_TIMEOUT_S = 300


def _images(np_rng, shape, device):
    """A float32 NHWC draw, as the JAX program makes it, as NCHW."""
    x = np_rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device).permute(0, 3, 1, 2).contiguous()


def _tensor(array, device, dtype=None):
    return torch.from_numpy(np.asarray(array, dtype)).to(device)


class Gang:
    """The ranks of one gang, over the default process group (gloo's):
    each rank's batch is one shard of the global batch. A tensor on a card
    travels through pinned host memory (``parallel/mesh.py``)."""

    def __init__(self):
        import torch.distributed as dist

        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.backend = dist.get_backend()

    def _sum(self, tensor: torch.Tensor, group=None) -> torch.Tensor:
        """``tensor`` summed over the ranks (of ``group``, by default
        every rank), in place; returned."""
        import torch.distributed as dist

        return collective_in_place(dist.all_reduce, tensor,
                                   dist.ReduceOp.SUM, group)

    def average_gradients(self, params, mesh=None, sharded=()) -> None:
        """Every gradient becomes its mean over the ranks that hold the
        same parameter: every rank, or for a parameter in ``sharded`` (ids
        of parameters split over ``mesh``'s model axis) the ranks of its
        share, ``mesh``'s token shards. One all-reduce of the flattened
        gradients for each."""
        whole = [p.grad for p in params
                 if p.grad is not None and id(p) not in sharded]
        shares = [p.grad for p in params
                  if p.grad is not None and id(p) in sharded]
        for grads, (group, size) in (
                (whole, (None, self.world)),
                (shares, mesh.group(TOKENS) if shares else (None, 1))):
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            if size > 1:
                self._sum(flat, group)
                flat /= size
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def broadcast_state(self, model, opt, mesh=None) -> None:
        """Rank 0's parameters, buffers and optimizer moments on every
        rank (after each rank restored the checkpoint rank 0 wrote); with
        a model axis, each share's from the first rank that holds it."""
        import torch.distributed as dist

        group, src = None, 0
        if model_parallel(mesh) > 1:
            # The token shards are fewer than the world here.
            group, size = mesh.group(TOKENS)
            if size == 1:
                return
            src = mesh.members[TOKENS][0]
        state = opt.full_state_dict()["state"]
        steps = torch.tensor([s["step"] for s in state.values()],
                             dtype=torch.float64)
        for tensor in [*model.state_dict().values(), steps,
                       *(s[k] for s in state.values() for k in ("m", "v"))]:
            collective_in_place(dist.broadcast, tensor, src, group)
        params = [p for group in opt.param_groups for p in group["params"]]
        for p, count in zip(params, steps.tolist()):
            opt.state[p]["step"] = int(count)

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """``value``'s mean over the ranks."""
        return self._sum(value.detach().clone()) / self.world


def shard_dims(model, mesh) -> dict:
    """{parameter name: the dimension it splits along} for the parameters
    split over a gang's model axis (the Transformer's; none off one)."""
    if not isinstance(model, TransformerLM) or model_parallel(mesh) == 1:
        return {}
    return {name: model_shard_dim(name) for name, _ in model.named_parameters()
            if model_shard_dim(name) is not None}


def whole_state(model, opt, mesh=None):
    """(model state, optimizer state) with whole parameters: a rank's
    shares gathered over the model axis (every rank of it calls this), or
    the rank's own state off one."""
    dims = shard_dims(model, mesh)
    if not dims:
        return model.state_dict(), opt.state_dict()
    model_state, opt_state = model.state_dict(), opt.full_state_dict()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    moments = {}
    for i, entry in opt_state["state"].items():
        dim = dims.get(names[i])
        moments[i] = entry if dim is None else {**entry, **{
            k: torch.cat(list(mesh.all_gather(entry[k], AXIS).unbind(0)),
                         dim=dim) for k in ("m", "v")}}
    return gather_state(model_state, mesh), {**opt_state, "state": moments}


def load_whole_state(model, opt, model_state, opt_state, mesh=None) -> None:
    """Loads whole parameters (``whole_state``'s) into a rank: its share
    of each split parameter and its moments."""
    dims = shard_dims(model, mesh)
    if dims:
        index, parts = mesh.index(AXIS), mesh.sizes[AXIS]
        model_state = shard_state(model_state, index, parts)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        moments = {}
        for i, entry in opt_state["state"].items():
            dim = dims.get(names[int(i)])
            moments[i] = entry if dim is None else {**entry, **{
                k: entry[k].chunk(parts, dim=dim)[index].contiguous()
                for k in ("m", "v")}}
        opt_state = {**opt_state, "state": moments}
    model.load_state_dict(model_state)
    opt.load_state_dict(opt_state)


def state_digest(model, mesh=None) -> str:
    """A digest of the model's parameters and buffers, bit for bit (a
    gang's ranks print theirs to show they hold the same state; with a
    model axis, of the whole parameters)."""
    import hashlib

    state = model.state_dict()
    if shard_dims(model, mesh):
        state = gather_state(state, mesh)
    digest = hashlib.sha256()
    for name, tensor in sorted(state.items()):
        digest.update(name.encode())
        digest.update(tensor.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()[:16]


def build_family(name, args, device, mesh=None, gang=None, draw=True):
    """Returns (model, step_fn(batch) -> loss, optimizer,
    batch_fn(np_rng) -> batch). ``step_fn`` takes one AdamW step and
    returns the loss before it, detached and not synchronised. ``mesh``
    is the grid ring and Ulysses attention shard over
    (``parallel/mesh.py``); over a gang's processes the Transformer's
    ``batch_fn`` draws the data group's batch and keeps this rank's
    sequence shard of it. The weights are drawn on the CPU from
    ``--seed``, so every device starts from the same ones. With a
    ``gang`` (:class:`Gang`) each step is the global batch's: BatchNorm
    takes the global statistics, the gradients and the returned loss are
    the ranks' means, a sharded parameter's gradient over the ranks of its
    share. ``draw=False`` (a run about to restore a checkpoint) leaves the
    Transformer's weights undrawn."""
    generator = torch.Generator().manual_seed(args.seed)
    bs = args.batch_size

    if name == "Transformer":
        cfg = TransformerConfig(
            vocab_size=args.vocab_size,
            d_model=args.d_model,
            num_heads=args.num_heads,
            num_layers=args.num_layers,
            d_ff=4 * args.d_model,
            max_len=args.seq_len,
            dtype=args.dtype,
            attention=args.attention,
            attention_window=args.attention_window,
            num_kv_heads=args.num_kv_heads,
            positional=args.positional,
            num_experts=args.num_experts,
            moe_aux_weight=args.moe_aux_weight,
            moe_capacity_factor=args.moe_capacity_factor,
            moe_dispatch=args.moe_dispatch,
            remat=args.remat,
        )
        model = TransformerLM(cfg, generator=generator, mesh=mesh, draw=draw)

        def loss_fn(batch):
            return lm_loss(model, batch, logit_chunk=args.logit_chunk)

        shard = (mesh.sizes["seq"] if isinstance(mesh, ProcessMesh)
                 else 1)
        if args.seq_len % shard:
            raise ValueError(f"seq_len {args.seq_len} does not divide into "
                             f"{shard} sequence shards")
        s_local = args.seq_len // shard
        first = mesh.index("seq") * s_local if shard > 1 else 0

        def batch_fn(np_rng):
            tokens = np_rng.integers(0, cfg.vocab_size,
                                     (bs, args.seq_len + 1))
            # This rank's inputs and their next tokens.
            return _tensor(tokens[:, first:first + s_local + 1], device)

    elif name in ("ResNet-18", "ResNet-50"):
        model = (ResNet18 if name == "ResNet-18" else ResNet50)(generator)

        def loss_fn(batch):
            images, labels = batch
            return sm.token_xent(model(images), labels)

        def batch_fn(np_rng):
            return (_images(np_rng, (bs, 32, 32, 3), device),
                    _tensor(np_rng.integers(0, 10, bs), device))

    elif name == "LM":
        model = sm.LSTMLanguageModel(generator=generator)

        def loss_fn(batch):
            return sm.token_xent(model(batch[:, :-1]), batch[:, 1:])

        def batch_fn(np_rng):
            return _tensor(np_rng.integers(0, 10000, (bs, args.seq_len + 1)),
                           device)

    elif name == "Recommendation":
        model = sm.NeuMF(generator=generator)

        def loss_fn(batch):
            pairs, labels = batch
            return torch.mean(sm.sigmoid_binary_cross_entropy(model(pairs),
                                                              labels))

        def batch_fn(np_rng):
            return (_tensor(np_rng.integers(0, 2048, (bs, 2)), device),
                    _tensor(np_rng.integers(0, 2, bs), device, np.float32))

    elif name == "A3C":
        model = sm.ActorCritic(generator=generator)

        def loss_fn(batch):
            obs, actions, returns = batch
            logits, values = model(obs)
            return sm.a3c_loss(logits, values, actions, returns)

        def batch_fn(np_rng):
            return (_images(np_rng, (bs, 84, 84, 4), device),
                    _tensor(np_rng.integers(0, 6, bs), device),
                    _tensor(np_rng.normal(size=bs), device, np.float32))

    elif name == "CycleGAN":
        model = sm.CycleGAN(generator)

        def loss_fn(batch):
            real_a, real_b = batch
            fake_b = model.gen(real_a)
            # Generator: fool the discriminator, stay near the target.
            gen_loss = (torch.mean((model.disc(fake_b) - 1.0) ** 2)
                        + torch.mean(torch.abs(fake_b - real_b)))
            # Discriminator: its loss does not reach the generator (the
            # image is detached), while gen_loss above reaches both.
            disc_loss = sm.lsgan_loss(model.disc(real_b),
                                      model.disc(fake_b.detach()))
            return gen_loss + disc_loss

        def batch_fn(np_rng):
            return (_images(np_rng, (bs, 64, 64, 3), device),
                    _images(np_rng, (bs, 64, 64, 3), device))

    else:
        raise ValueError(f"Unknown model family {name!r}")

    model = model.to(device)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = FusedAdamW(params, args.learning_rate)
    split = set(shard_dims(model, mesh))
    sharded = {id(p) for name, p in model.named_parameters() if name in split}
    if gang is not None:
        for module in model.modules():
            if isinstance(module, FlaxBatchNorm2d):
                module.global_batch = True

    def step_fn(batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        if gang is not None:
            gang.average_gradients(params, mesh, sharded)
            loss = gang.mean(loss)
        opt.step()
        return loss.detach()

    return model, step_fn, opt, batch_fn


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("-n", "--num_steps", type=int, required=True)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--ckpt_backend", type=str, default="msgpack",
                        choices=["msgpack", "orbax"],
                        help="msgpack: one train_state.pt file; orbax: a "
                        "torch.distributed.checkpoint directory at "
                        "orbax_state (the JAX program's path)")
    parser.add_argument("--enable_shockwave_iterator", action="store_true")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (default) raises when no card is present")
    parser.add_argument("--gang_device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where a gang's ranks train (default: "
                        "--device); the card driver runs gangs on the CPU")
    # Transformer knobs.
    parser.add_argument("--vocab_size", type=int, default=1024)
    parser.add_argument("--d_model", type=int, default=128)
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--attention", type=str, default="dense",
                        choices=["dense", "ring", "ulysses", "flash"])
    parser.add_argument("--attention_window", type=int, default=None)
    parser.add_argument("--num_kv_heads", type=int, default=None)
    parser.add_argument("--logit_chunk", type=int, default=None)
    parser.add_argument("--positional", type=str, default="learned",
                        choices=["learned", "rope"])
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="activation dtype (params stay float32)")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--num_experts", type=int, default=0)
    parser.add_argument("--moe_aux_weight", type=float, default=1e-2)
    parser.add_argument("--moe_capacity_factor", type=float, default=1.25)
    parser.add_argument("--moe_dispatch", type=str, default="grouped",
                        choices=["grouped", "dense"])
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--seq_parallel", type=int, default=1)
    # Gang rendezvous (appended by the scheduler).
    parser.add_argument("--distributed_addr", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--worker_rank", type=int, default=0)
    parser.add_argument(
        "--distributed_timeout", type=float, default=None,
        help="gang rendezvous timeout in seconds (rounded up): fail fast "
        "when a rank never arrives (default "
        f"{DEFAULT_RENDEZVOUS_TIMEOUT_S})")
    return parser.parse_args(argv)


def _in_gang(args) -> bool:
    return bool(args.distributed_addr) and args.num_workers > 1


def rendezvous(args) -> Gang:
    """Joins the gang's process group at ``--distributed_addr`` over gloo
    (two ranks may share a card, which NCCL refuses); raises after
    ``--distributed_timeout`` seconds (rounded up to whole seconds, at
    least 1, as the JAX program rounds them) when a rank is missing."""
    import datetime
    import math

    import torch.distributed as dist

    seconds = (DEFAULT_RENDEZVOUS_TIMEOUT_S
               if args.distributed_timeout is None
               else max(1, math.ceil(args.distributed_timeout)))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{args.distributed_addr}",
        world_size=args.num_workers, rank=args.worker_rank,
        timeout=datetime.timedelta(seconds=seconds))
    return Gang()


class FileCheckpoint:
    """``train_state.pt``: one ``torch.save`` file, written beside its
    path and renamed into place. It holds whole parameters: with a gang's
    ``mesh`` of a model axis, ``save`` gathers them (every rank calls it,
    the ``write`` one writes) and ``load`` takes the rank's share."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, CHECKPOINT_NAME)

    def load(self, model, opt, device, mesh=None) -> int:
        try:
            state = torch.load(self.path, map_location=device,
                               weights_only=True)
        except FileNotFoundError:
            raise RuntimeError(
                f"checkpoint at {self.path} disappeared between resume "
                "detection and restore"
            ) from None
        load_whole_state(model, opt, state["model"], state["opt"], mesh)
        return int(state.get("step", 0))

    def save(self, model, opt, step: int, mesh=None,
             write: bool = True) -> None:
        model_state, opt_state = whole_state(model, opt, mesh)
        if not write:
            return
        os.makedirs(self.directory, exist_ok=True)
        tmp_path = self.path + ".tmp"
        torch.save({"model": model_state, "opt": opt_state, "step": step},
                   tmp_path)
        os.replace(tmp_path, self.path)


def _one_process() -> dict:
    """In a gang the directory checkpoint is still one process's (rank 0
    writes it, each rank reads it): keep the library off the group."""
    import torch.distributed as dist

    return {"no_dist": True} if dist.is_initialized() else {}


class DirectoryCheckpoint:
    """``orbax_state``: a ``torch.distributed.checkpoint`` directory (one
    process). Each save writes a new version directory beside it and then
    swaps the ``orbax_state`` link onto it in one rename, so a kill
    mid-save leaves the link on the previous complete version; older
    versions are removed after the swap. Whole parameters, as
    ``FileCheckpoint``'s."""

    def __init__(self, directory: str):
        self.path = os.path.join(os.path.abspath(directory),
                                 DIRECTORY_CHECKPOINT_NAME)

    @staticmethod
    def _tensors(model_state, opt_state, step: int) -> dict:
        """The train state as tensors only (the library restores tensors
        in place and plain values not at all): the model, every
        parameter's moments, their step counts and the steps taken."""
        state = opt_state["state"]
        return {"model": model_state,
                "moments": {f"{i}.{k}": s[k] for i, s in state.items()
                            for k in ("m", "v")},
                "moment_steps": torch.tensor([s["step"]
                                              for s in state.values()]),
                "step": torch.tensor(step)}

    def load(self, model, opt, device, mesh=None) -> int:
        import torch.distributed.checkpoint as dcp

        # Whole tensors to fill: the rank's own with one share, else the
        # gathered shares (templates).
        opt.full_state_dict()
        model_state, opt_state = whole_state(model, opt, mesh)
        tensors = self._tensors(model_state, opt_state, 0)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_ONE_PROCESS)
            dcp.load(tensors, checkpoint_id=os.path.realpath(self.path),
                     **_one_process())
        # The tensors were filled in place: with one share, the model's
        # and the optimizer's own (its state entries are the optimizer's).
        counts = tensors["moment_steps"].tolist()
        for entry, count in zip(opt_state["state"].values(), counts):
            entry["step"] = count
        if shard_dims(model, mesh):
            load_whole_state(model, opt, model_state, opt_state, mesh)
        return int(tensors["step"])

    def save(self, model, opt, step: int, mesh=None,
             write: bool = True) -> None:
        import torch.distributed.checkpoint as dcp

        opt.full_state_dict()
        model_state, opt_state = whole_state(model, opt, mesh)
        if not write:
            return
        parent, name = os.path.split(self.path)
        os.makedirs(parent, exist_ok=True)
        version = f"{self.path}.v{time.time_ns()}"
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_ONE_PROCESS)
            dcp.save(self._tensors(model_state, opt_state, step),
                     checkpoint_id=version, **_one_process())
        link = self.path + ".link"
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.basename(version), link)
        os.replace(link, self.path)
        for entry in os.listdir(parent):
            if (entry.startswith(name + ".v")
                    and entry != os.path.basename(version)):
                shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)


def main(argv=None):
    """Train; prints the steps line and returns a summary dict with the
    per-step losses, the elapsed train time and the phase timings."""
    args = parse_args(argv)
    # Opt-in phase breakdown (SHOCKWAVE_PHASE_TIMINGS=1): one PHASES line
    # splitting the attempt's wall clock into build/restore/
    # first_step_compile/train/save, as the JAX program prints it. Here the
    # first step pays the kernels' build instead of a compile.
    timed = bool(os.environ.get("SHOCKWAVE_PHASE_TIMINGS"))
    phase_timings = {}
    phase_start = time.time()

    def mark_phase(name):
        nonlocal phase_start
        if timed:
            now = time.time()
            phase_timings[name] = phase_timings.get(name, 0.0) + now - phase_start
            phase_start = now

    gang = None
    if _in_gang(args):
        gang = rendezvous(args)
        mark_phase("rendezvous")
    device = resolve_device(args.gang_device if gang and args.gang_device
                            else args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    checkpoint = None
    if args.checkpoint_dir:
        checkpoint = (DirectoryCheckpoint if args.ckpt_backend == "orbax"
                      else FileCheckpoint)(args.checkpoint_dir)
    resuming = bool(checkpoint and os.path.exists(checkpoint.path))
    if gang is not None:
        # The mesh spans the gang's processes, one place a rank.
        mesh = make_process_mesh(args.seq_parallel, args.model_parallel)
        print(f"MESH backend={gang.backend} rank={gang.rank} "
              f"world={gang.world} mesh={mesh.sizes} device={device}",
              flush=True)
    else:
        # The run holds one device (a card, or the CPU): as in the JAX
        # program, --seq_parallel and --model_parallel must divide that
        # count.
        mesh = make_mesh(factorize_gang(1, args.seq_parallel,
                                        args.model_parallel), [device])
    model, step_fn, opt, batch_fn = build_family(args.model, args, device,
                                                 mesh, gang, draw=not resuming)
    sync()
    mark_phase("build")
    if resuming:
        start_step = checkpoint.load(model, opt, device, mesh)
        if gang is not None:
            gang.broadcast_state(model, opt, mesh)
        sync()
        print(f"RESUMED from {checkpoint.path} at step {start_step}",
              flush=True)
    else:
        start_step = 0
    mark_phase("restore")

    def save_checkpoint():
        # Rank 0 writes the gang's whole state (gathered over a model
        # axis, which every rank takes part in).
        if checkpoint and (gang is None or gang.rank == 0
                           or shard_dims(model, mesh)):
            checkpoint.save(model, opt, start_step + len(losses), mesh,
                            write=gang is None or gang.rank == 0)

    # Each data group draws its own shard of the global batch; its sequence
    # shards share the draw.
    np_rng = np.random.default_rng(
        args.seed + (mesh.index("data") if gang else 0))

    class Batches:
        def __iter__(self):
            while True:
                yield batch_fn(np_rng)

    use_iterator = (args.enable_shockwave_iterator
                    and "SHOCKWAVE_JOB_ID" in os.environ)
    if use_iterator:
        from shockwave_tpu_torch.runtime.iterator import ShockwaveIterator

        # The lease ends the loop early; the checkpoint below is saved on
        # expiry and on completion alike.
        loader = ShockwaveIterator(
            Batches(), args.checkpoint_dir or ".",
            save_checkpoint_func=save_checkpoint,
        )
    else:
        loader = Batches()
    losses = []
    start = time.time()
    for batch in loader:
        losses.append(step_fn(batch))
        if len(losses) == 1 and timed:
            # Fences the first step (the kernels' build lands there) so
            # the scrape does not charge it to steady-state training.
            sync()
            mark_phase("first_step_compile")
        if len(losses) >= args.num_steps:
            if use_iterator:
                loader.complete()
            break
    sync()
    elapsed = time.time() - start
    mark_phase("train")
    save_checkpoint()
    mark_phase("save")
    if phase_timings:
        print("PHASES " + " ".join(
            f"{k}={v:.1f}s" for k, v in phase_timings.items()))
    loss_values = [float(x) for x in losses]
    loss_str = f"{loss_values[-1]:.4f}" if loss_values else "n/a"
    steps = len(loss_values)
    print(
        f"[{args.model}] steps={steps} loss={loss_str} "
        f"throughput={steps / max(elapsed, 1e-9):.2f} steps/s "
        f"device={device.type}"
    )
    if device.type == "cuda":
        from shockwave_tpu_torch.ops import flash_attention

        print("LAUNCHES " + json.dumps(flash_attention.LAUNCHES,
                                       sort_keys=True), flush=True)
    if gang is not None:
        import torch.distributed as dist

        print(f"GANG rank={gang.rank} world={gang.world} "
              f"params={state_digest(model, mesh)} losses="
              + json.dumps(loss_values), flush=True)
        dist.destroy_process_group()
    return {"steps": steps, "losses": loss_values, "elapsed_s": elapsed,
            "phases": phase_timings, "resumed": resuming,
            "start_step": start_step, "device": device.type,
            "rank": gang.rank if gang else 0}


if __name__ == "__main__":
    main()
