"""Where a training step of the port spends its device time.

    python -m shockwave_tpu_torch.tools.profile_step            # 110M tier
    python -m shockwave_tpu_torch.tools.profile_step --steps 5 --d_model 512
    python -m shockwave_tpu_torch.tools.profile_step --attention ring

Builds the Transformer family exactly as ``models/train.py`` does (the
defaults here are the 110M tier: vocab 8192, d_model 1024, 8 heads, 8
layers, seq 2048, batch 8, bf16, flash attention; ``--attention ring``
shards the sequence over a (1, 1, 4, 1) mesh of the one card, as
``chip_smoke.py`` does), takes two warm-up steps, then runs ``--steps`` steps under ``torch.profiler`` with CPU and
CUDA activities. It prints one JSON object:

- ``step_ms``: host clock around ``--steps`` steps run without the
  profiler, synchronised at the end, divided by the step count;
- ``profiled_step_ms``: the same around the profiled steps;
- ``device_busy_ms`` / ``device_idle_share``: the union of all kernel
  intervals on the card over the same window, and the rest of it;
- ``by_category``: kernel time summed by what the kernel is (flash
  kernels, matrix products, elementwise, reductions, ...), ms per step;
- ``top_kernels``: the 15 kernels with the most time, ms per step.

Needs a card; runs nothing on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from shockwave_tpu_torch.models import train
from shockwave_tpu_torch.utils.device import resolve_device

# First matching pattern names a kernel's category.
CATEGORIES = [
    ("flash_fwd_nc", r"flash_fwd_\w+<\d+, false>"),
    ("flash_dkv_nc", r"flash_dkv_\w+<\d+, false>"),
    ("flash_dq_nc", r"flash_dq_\w+<\d+, false>"),
    ("flash_fwd", r"flash_fwd_"),
    ("flash_dkv", r"flash_dkv_"),
    ("flash_dq", r"flash_dq_"),
    ("matmul", r"gemm|nvjet|xmma|cutlass|cublas|splitK"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("softmax_xent", r"softmax|logsumexp|log_softmax|nll"),
    ("reduce", r"reduce|Reduce"),
    ("copy_cast", r"copy|Copy|cast|bfloat16|to_"),
    ("elementwise", r"elementwise|vectorized|Elementwise|unrolled"),
    ("index", r"index|gather|scatter|embedding"),
]


# Sequence shards of --attention ring, all on the one card.
RING_SHARDS = 4


def _category(name: str) -> str:
    for label, pattern in CATEGORIES:
        if re.search(pattern, name):
            return label
    return "other"


def _union_us(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--vocab_size", type=int, default=8192)
    parser.add_argument("--d_model", type=int, default=1024)
    parser.add_argument("--num_heads", type=int, default=8)
    parser.add_argument("--num_layers", type=int, default=8)
    parser.add_argument("--seq_len", type=int, default=2048)
    parser.add_argument("--attention", default="flash")
    parser.add_argument("--dtype", default="bfloat16")
    opts = parser.parse_args(argv)

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args = train.parse_args([
        "--model", "Transformer", "-n", str(opts.steps),
        "--batch_size", str(opts.batch_size),
        "--vocab_size", str(opts.vocab_size), "--d_model", str(opts.d_model),
        "--num_heads", str(opts.num_heads),
        "--num_layers", str(opts.num_layers), "--seq_len", str(opts.seq_len),
        "--attention", opts.attention, "--dtype", opts.dtype,
    ])
    mesh = None
    if opts.attention == "ring":
        from shockwave_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh((1, 1, RING_SHARDS, 1), [device] * RING_SHARDS)
    _, step_fn, _, batch_fn = train.build_family("Transformer", args, device,
                                                 mesh)
    rng = np.random.default_rng(0)
    batches = [batch_fn(rng) for _ in range(2 * opts.steps + 2)]
    for batch in batches[:2]:
        step_fn(batch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for batch in batches[2:2 + opts.steps]:
        step_fn(batch)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for batch in batches[2 + opts.steps:]:
            step_fn(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)

    # Device-side events, without the ranges that record_function
    # annotations (e.g. "Optimizer.step#FusedAdamW.step") mirror there.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    if not kernels:
        print("profile_step: the profiler recorded no device time",
              file=sys.stderr)
        sys.exit(1)
    busy_ms = _union_us(
        [(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_name, by_cat = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + ms, c + 1)
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    steps = opts.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "card": card,
        "config": vars(opts),
        "step_ms": plain_ms / steps,
        "profiled_step_ms": wall_ms / steps,
        "device_busy_ms": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": len(kernels) / steps,
        "by_category": {k: v / steps for k, v in
                        sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms": t / steps,
                         "launches": c / steps} for n, (t, c) in top],
    }, indent=1))


if __name__ == "__main__":
    main()
