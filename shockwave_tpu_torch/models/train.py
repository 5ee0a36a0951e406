"""Training program for the Transformer family, in PyTorch.

The port's counterpart of ``shockwave_tpu/models/train.py``, the process
the scheduler's dispatcher launches on a worker:

  python -m shockwave_tpu_torch.models.train --model Transformer \
      --batch_size 8 -n <steps> --checkpoint_dir <dir> [--device cpu]

Same flags, the same synthetic token batches (``np.random.default_rng``
drawn exactly as the JAX program draws them, so both see the same
batches), the same ``[Transformer] steps=N loss=... throughput=...
steps/s`` line (which then names the device the run resolved, as
``device=cuda``) and the same ``SHOCKWAVE_PHASE_TIMINGS`` PHASES line. It
runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. On a card it also prints the flash kernels' launch
counts (``LAUNCHES {...}``).

Checkpoint: ``train_state.pt`` in ``--checkpoint_dir`` (model and
optimizer state and the steps taken so far), written beside the final
path and renamed into place so a kill mid-save keeps the previous good
checkpoint. A run that finds one restores it before its first step and
prints ``RESUMED from <path> at step N``.

Under the scheduler (``--enable_shockwave_iterator`` with
``SHOCKWAVE_JOB_ID`` set by the dispatcher) the batches come through the
leased iterator (``runtime/iterator.py``): the run ends when its lease
expires or its ``-n`` steps are done, saves its checkpoint either way, and
the iterator's progress line tells the dispatcher how far it got.

``--attention ring --seq_parallel P`` and ``--attention ulysses
--seq_parallel P`` run ring or Ulysses attention over a mesh built as the
JAX program builds it: ``factorize_gang`` over the devices the run holds
(one card, or the CPU), so P must divide their count.

Not ported (each raises NotImplementedError, see ROADMAP.md): the other
families, gang rendezvous over several workers (queue 1, item 8), model
parallelism and the orbax backend.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from shockwave_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    lm_loss,
)
from shockwave_tpu_torch.ops.fused_adamw import FusedAdamW
from shockwave_tpu_torch.parallel.mesh import factorize_gang, make_mesh
from shockwave_tpu_torch.utils.device import resolve_device

CHECKPOINT_NAME = "train_state.pt"
_LATER_FAMILIES = ("ResNet-18", "ResNet-50", "LM", "Recommendation", "A3C",
                   "CycleGAN")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to shockwave_tpu_torch yet; see ROADMAP.md"
    )


def build_family(name, args, device, mesh=None):
    """Returns (model, step_fn(batch) -> loss, optimizer,
    batch_fn(np_rng) -> batch). ``step_fn`` takes one AdamW step and
    returns the loss before it, detached and not synchronised. ``mesh``
    is the grid ring and Ulysses attention shard over
    (``parallel/mesh.py``)."""
    if name in _LATER_FAMILIES:
        raise _not_ported(f"the {name} family")
    if name != "Transformer":
        raise ValueError(f"Unknown model family {name!r}")
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
        remat=args.remat,
    )
    # Initialised on the CPU from the seed, so every device starts from
    # the same weights.
    generator = torch.Generator().manual_seed(args.seed)
    model = TransformerLM(cfg, generator=generator, mesh=mesh).to(device)
    opt = FusedAdamW(model.parameters(), args.learning_rate)
    logit_chunk = args.logit_chunk
    bs = args.batch_size

    def batch_fn(np_rng):
        tokens = np_rng.integers(0, cfg.vocab_size, (bs, args.seq_len + 1))
        return torch.from_numpy(tokens).to(device)

    def step_fn(batch):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, batch, logit_chunk=logit_chunk)
        loss.backward()
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
                        help="msgpack: one train_state.pt file (the name is "
                        "the JAX program's); orbax is not ported")
    parser.add_argument("--enable_shockwave_iterator", action="store_true")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (default) raises when no card is present")
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
    parser.add_argument("--distributed_timeout", type=float, default=None)
    return parser.parse_args(argv)


def _check_args(args) -> None:
    if args.distributed_addr and args.num_workers > 1:
        raise _not_ported(
            "gang training over several workers (ROADMAP.md, queue 1, "
            "item 8)")
    if args.model_parallel > 1:
        raise _not_ported("model parallelism")
    if args.ckpt_backend == "orbax":
        raise _not_ported("the orbax checkpoint backend")


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

    _check_args(args)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ckpt_path = (os.path.join(args.checkpoint_dir, CHECKPOINT_NAME)
                 if args.checkpoint_dir else None)
    resuming = bool(ckpt_path and os.path.exists(ckpt_path))
    # The run holds one device (a card, or the CPU): as in the JAX program,
    # --seq_parallel and --model_parallel must divide that count.
    mesh = make_mesh(factorize_gang(1, args.seq_parallel, args.model_parallel),
                     [device])
    model, step_fn, opt, batch_fn = build_family(args.model, args, device,
                                                 mesh)
    sync()
    mark_phase("build")
    if resuming:
        try:
            state = torch.load(ckpt_path, map_location=device,
                               weights_only=True)
        except FileNotFoundError:
            raise RuntimeError(
                f"checkpoint at {ckpt_path} disappeared between resume "
                "detection and restore"
            ) from None
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        start_step = int(state.get("step", 0))
        sync()
        print(f"RESUMED from {ckpt_path} at step {start_step}", flush=True)
    else:
        start_step = 0
    mark_phase("restore")

    def save_checkpoint():
        if not ckpt_path:
            return
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        tmp_path = ckpt_path + ".tmp"
        torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                    "step": start_step + len(losses)}, tmp_path)
        os.replace(tmp_path, ckpt_path)

    np_rng = np.random.default_rng(args.seed)

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
    return {"steps": steps, "losses": loss_values, "elapsed_s": elapsed,
            "phases": phase_timings, "resumed": resuming,
            "start_step": start_step, "device": device.type}


if __name__ == "__main__":
    main()
