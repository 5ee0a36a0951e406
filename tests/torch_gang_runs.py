"""Gangs of the port's sequence-parallel and MoE paths on the CPU, for the
tests: each rank a spawned process in a gloo group, beside the one-process
run it must equal.

``spawn_gang(fn, world, *args)`` runs ``fn(rank, world, addr, *args)`` in
``world`` spawned processes and returns each rank's result (what ``fn``
returned, passed back through ``torch.save``).

Ranks and references compute on one CPU thread (:func:`one_thread`): with
two, this host's float32 products now and then split a batch across
threads whose kernels sum in another order, which moves a CPU attention
output by up to 1.1e-4 from one run to the next.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from shockwave_tpu_torch.runtime.testing import free_port


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _entry(rank, fn, world, addr, out_dir, args):
    torch.set_num_threads(1)
    result = fn(rank, world, addr, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_gang(fn, world: int, *args, timeout_s: float = 240.0):
    """``fn(rank, world, addr, *args)`` on ``world`` spawned ranks; their
    results in rank order."""
    import torch.multiprocessing as mp

    addr = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        context = mp.start_processes(
            _entry, args=(fn, world, addr, out_dir, args), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.time() + timeout_s
        try:
            while not context.join(timeout=2.0):
                if time.time() > deadline:
                    raise TimeoutError(f"the gang ran past {timeout_s} s")
        finally:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                for r in range(world)]


def init_gloo(rank: int, world: int, addr: str) -> None:
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


# -- the attention bodies alone ------------------------------------------


def attention_inputs(B, S, H, Hkv, D, seed=0):
    """Seeded float32 q, k, v ([B, S, heads, D]) and an output cotangent."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return draw(B, S, H, D), draw(B, S, Hkv, D), draw(B, S, Hkv, D), \
        draw(B, S, H, D)


def attention_rank(rank, world, addr, kind, inner, shape):
    """This rank's sequence shard through ``ring_attention`` (``inner``)
    or ``ulysses_attention`` (its local body) over the gang's seq axis:
    (output shard, dq, dk, dv shards)."""
    import torch.distributed as dist

    from shockwave_tpu_torch.parallel.mesh import make_process_mesh
    from shockwave_tpu_torch.parallel.ring_attention import ring_attention
    from shockwave_tpu_torch.parallel.ulysses import ulysses_attention

    init_gloo(rank, world, addr)
    mesh = make_process_mesh(seq_parallel=world)
    q, k, v, g = attention_inputs(**shape)
    s = shape["S"] // world
    part = slice(rank * s, (rank + 1) * s)
    q, k, v = (x[:, part].clone().requires_grad_() for x in (q, k, v))
    if kind == "ring":
        out = ring_attention(q, k, v, mesh, inner=inner)
    else:
        out = ulysses_attention(q, k, v, mesh, local_attention=inner)
    out.backward(g[:, part])
    result = [t.detach() for t in (out, q.grad, k.grad, v.grad)]
    dist.destroy_process_group()
    return result


# -- training ------------------------------------------------------------


def train_argv(*extra, steps=2, batch=2):
    """The Transformer's flags at the tests' widths."""
    return ["--model", "Transformer", "-n", str(steps), "--batch_size",
            str(batch), "--device", "cpu", "--d_model", "64", "--num_layers",
            "2", "--num_heads", "4", "--vocab_size", "128", *extra]


def moe_stats(model):
    """(mean balance loss, mean dropped share) over the model's MoE
    layers, from their last forward."""
    layers = [b.moe for b in model.blocks if hasattr(b, "moe")]
    return (float(sum(m.balance for m in layers) / len(layers)),
            float(sum(m.dropped for m in layers) / len(layers)))


def train_rank(rank, world, addr, argv):
    """One rank of a gang of ``models/train.py``'s step on ``argv``: the
    process mesh, the data group's draw from ``--seed + d``, the step of
    the global batch. Returns each step's (loss, balance, dropped) and the
    final parameters."""
    import torch.distributed as dist

    from shockwave_tpu_torch.models import train
    from shockwave_tpu_torch.parallel.mesh import make_process_mesh

    args = train.parse_args(argv)
    init_gloo(rank, world, addr)
    gang = train.Gang()
    cpu = torch.device("cpu")
    mesh = make_process_mesh(args.seq_parallel)
    model, step_fn, _, batch_fn = train.build_family(args.model, args, cpu,
                                                     mesh, gang)
    rng = np.random.default_rng(args.seed + mesh.index("data"))
    steps = []
    for _ in range(args.num_steps):
        loss = float(step_fn(batch_fn(rng)))
        steps.append((loss, *moe_stats(model)) if args.num_experts
                     else (loss,))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    dist.destroy_process_group()
    return {"steps": steps, "params": params, "sizes": mesh.sizes,
            "data": mesh.index("data"), "seq": mesh.index("seq")}


def one_process(argv, data_groups: int, seq_places: int = 1):
    """The same steps in one process on the global batch (the data
    groups' draws from ``--seed + d``, stacked), over a ``seq_places``
    mesh of the CPU. Returns what :func:`train_rank` returns."""
    from shockwave_tpu_torch.models import train
    from shockwave_tpu_torch.parallel.mesh import make_mesh

    args = train.parse_args(argv)
    whole = train.parse_args(
        argv + ["--batch_size", str(args.batch_size * data_groups),
                "--seq_parallel", "1"])
    whole.seq_parallel = seq_places
    cpu = torch.device("cpu")
    mesh = make_mesh((1, 1, seq_places, 1), [cpu] * seq_places)
    model, step_fn, _, _ = train.build_family(args.model, whole, cpu, mesh)
    shard_args = train.parse_args(argv + ["--seq_parallel", "1"])
    _, _, _, draw = train.build_family(args.model, shard_args, cpu)
    rngs = [np.random.default_rng(args.seed + d) for d in range(data_groups)]
    steps = []
    with one_thread():
        for _ in range(args.num_steps):
            batch = torch.cat([draw(rng) for rng in rngs])
            loss = float(step_fn(batch))
            steps.append((loss, *moe_stats(model)) if args.num_experts
                         else (loss,))
    return {"steps": steps,
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}


# -- the pipeline ----------------------------------------------------------


def toy_stage(params, x):
    """``tests/test_pipeline.py``'s stage: one affine map and a tanh."""
    return torch.tanh(x @ params["w"] + params["b"])


def toy_params(rng, S, d):
    """``tests/test_pipeline.py::_toy_params``'s draws, as tensors."""
    return {"w": torch.from_numpy((rng.normal(size=(S, d, d)) * 0.3)
                                  .astype(np.float32)),
            "b": torch.from_numpy((rng.normal(size=(S, d)) * 0.1)
                                  .astype(np.float32))}


def gpipe_rank(rank, world, addr, params, x):
    """Stage ``rank`` of ``gpipe_apply`` over a gang's pipe axis: the
    outputs (on every rank), the gradient of their sum of squares with
    respect to this rank's stage, and the input's gradient."""
    import torch.distributed as dist

    from shockwave_tpu_torch.parallel.mesh import make_process_mesh
    from shockwave_tpu_torch.parallel.pipeline import gpipe_apply

    init_gloo(rank, world, addr)
    mesh = make_process_mesh(pipe_parallel=world)
    mine = {k: v[rank:rank + 1].clone().requires_grad_() for k, v in
            params.items()}
    x = x.clone().requires_grad_()
    y = gpipe_apply(toy_stage, mine, x, mesh)
    (y ** 2).sum().backward()
    result = (y.detach(), {k: v.grad[0] for k, v in mine.items()},
              x.grad if x.grad is not None else torch.zeros_like(x))
    dist.destroy_process_group()
    return result


def pipelined_steps(model, params, tokens, steps, lr=1e-3):
    """``steps`` AdamW steps of ``model.loss`` on ``tokens`` (a pipe
    gang's replicated gradients summed over its ranks): the losses and the
    parameters after them."""
    from shockwave_tpu_torch.ops.fused_adamw import FusedAdamW
    from shockwave_tpu_torch.parallel.pipeline import _leaves

    for leaf in _leaves(params):
        leaf.requires_grad_()
    opt = FusedAdamW(_leaves(params), lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, tokens)
        loss.backward()
        model.sum_replicated_gradients(params)
        opt.step()
        losses.append(float(loss.detach()))
    return losses, params


def pipelined_lm_rank(rank, world, addr, cfg, microbatches, params, tokens,
                      steps):
    """Stage ``rank`` of a ``PipelinedLM`` over a gang's pipe axis, trained
    ``steps`` steps: the losses and this rank's parameters."""
    import torch.distributed as dist

    from shockwave_tpu_torch.parallel.mesh import make_process_mesh
    from shockwave_tpu_torch.parallel.pipeline import PipelinedLM

    init_gloo(rank, world, addr)
    mesh = make_process_mesh(pipe_parallel=world)
    model = PipelinedLM(cfg, world, microbatches, mesh)
    # The spawned ranks share ``params``' memory with the caller: train a
    # copy.
    params = {k: ({n: p.clone() for n, p in v.items()}
                  if isinstance(v, dict) else v.clone())
              for k, v in params.items()}
    losses, mine = pipelined_steps(model, model.shard_params(params), tokens,
                                   steps)
    logits = model.logits(mine, tokens[:, :-1]).detach()
    dist.destroy_process_group()
    detached = {k: ({n: p.detach() for n, p in v.items()}
                    if isinstance(v, dict) else v.detach())
                for k, v in mine.items()}
    return losses, detached, logits
