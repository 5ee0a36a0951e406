#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``shockwave_tpu_torch/ops/csrc`` into
   ``shockwave_tpu_torch/_build/`` (one nvcc for each source, started
   together, ~13 s), prints the flash kernels' registers, stack and
   shared memory (``cuobjdump -res-usage``) and the planning kernels'
   registers and spills (``-Xptxas -v``)
   and fails unless the SASS (``cuobjdump -sass``) of every bf16 forward,
   dK/dV and dQ instantiation, causal and non-causal, holds wgmma
   (``HGMMA``) and TMA loads (``UTMALDG``), or if ptxas reported
   serialising any wgmma (the build log, ``-Xptxas -v``).
3. Holds each kernel (flash forward, dK/dV, dQ) against its plain PyTorch
   version on the card: at the training shape (B=8, S=2048, H=8, D=128,
   bf16, causal) on inputs from seeds 1 and 0, at two GQA-plus-window
   shapes in bf16 (B=2, S=512, H=4, Hkv=2, D=64, window=200; B=1,
   S=1024, H=4, Hkv=1, D=128, window=333), which reach the kernels'
   window-straddle and skip code, and at the first of those in float32,
   under the per-element (with its one-flip term) and Frobenius limits
   of ``flash_attention.KERNEL_TOLERANCE``; then shows that those limits
   reject planted faults (a skipped tile of the width each kernel walks,
   misweighted rows) at the training shape. The inputs, the check and the
   timing are ``shockwave_tpu_torch/tools/bench_flash.py``'s.
4. Times each kernel, its plain version and PyTorch's
   scaled_dot_product_attention with CUDA events, beside the kernel's
   bound on an H100 SXM, and the backward pair (dK/dV + dQ) beside SDPA's
   backward, which computes dq, dk and dv in one call.
5. Checks a small model on the card: the flash path against the dense
   path on the same weights.
6. Drives the main path: ``shockwave_tpu_torch.models.train.main`` at the
   110M tier (vocab 8192, d_model 1024, 8 heads of 128, 8 layers, seq
   2048, batch 8, bf16, flash, AdamW) for 5 steps with a checkpoint, then
   resumes from it for 2 more. The launch counters must show 8 launches
   of every causal kernel per step (one per layer) and none non-causal.
7. Drives the ring slice (``run_ring``): (a) each kernel against its
   plain version under ``KERNEL_TOLERANCE`` at the shapes the ring gives
   it: causal in bf16 at the 110M tier's ring-hop shape (B=8, Sq=Sk=512,
   H=8, D=128, each shard's hop 0), and non-causal in bf16 at that shape
   and at a GQA shape with Sk != Sq (B=2, Sq=512, Sk=1024, H=4, Hkv=2,
   D=64), and in float32 at the latter, with the planted faults rejected
   at the hop shape; (b) ``ring_attention`` (flash body, a
   4-shard seq mesh of the one card) against ``flash_attention`` in
   float32 (B=2, S=1024, H=4, Hkv=2, D=64), output and q/k/v gradients
   within rtol 1e-3, atol 1e-4; (c) the 110M tier with
   ``attention="ring"`` on a (1, 1, 4, 1) mesh of the card through
   ``train.build_family`` against the flash model on the same seed-0
   weights and batches: on the first batch its loss within 2e-5 and every
   parameter's gradient within 0.08 (relative Frobenius) of the flash
   model's, limits that four planted hop faults (the last live hop
   dropped or weighted twice, in every layer or the last) must each fail;
   then 5 steps, each loss within 5e-5 of the flash run's (item 6), with
   32 causal and 48 non-causal launches of each kernel per step (8 layers
   x (4 shards + 6 live hops)); then ``train.main --attention ring --seq_parallel 1`` for
   2 steps; (d) the non-causal kernels timed at the hop shape beside
   their bound and SDPA with ``is_causal=False``, and the ring step's
   steps/s and peak memory beside the flash step's.
8. Drives the second main path, trace-driven simulation under the
   Shockwave planner with its level-set solve on the card
   (``shockwave_tpu_torch/tools/bench_sim.py``): (a) the committed 12-job
   trace on 8 GPUs under ``shockwave_tpu_level`` and ``shockwave_native``,
   each within 1e-3 of the JAX package's golden (tests/test_golden.py),
   every level solve of the first run on the card (16); (b) the 2048-job
   trace on 256 GPUs with 120 s rounds under ``shockwave_tpu``, the
   production dispatch, within 1e-3 of the JAX package's run on the CPU,
   with at least one level solve on the card; (c) the level solve on the
   card against the port's CPU solve (which the tests hold to the JAX
   package), counts equal and objectives within 1e-6, on the 204 seeded
   parity problems (slot bands 64 to 1024, with and without a switch
   bonus), on a seeded problem of every timing band and on every planning
   problem the 2048-job run built; (d) per slot band (64 to 1024 jobs on
   256 GPUs, 20 rounds, seeded) and on a sample of the 2048-job run's own
   problems across their job counts, the level solve's time, device head
   and host tail, the median of 20 after a warm-up, its kernel launches
   and the device's busy time under torch.profiler, and the native
   greedy's time on the same problem, with the crossover of each set. It
   prints one JSON line ``{"simulation": {...}}`` of these readings.
9. Drives the planner's first-order backends, kernels A (restarted PDHG,
   ``csrc/eg_pdhg.cu``) and B (relaxed PGD, ``csrc/eg_relaxed.cu``), each
   one launch a solve (``shockwave_tpu_torch/tools/bench_sim.py``): (a) the
   2048-job trace on 256 GPUs under ``shockwave_tpu_pdhg``, every plan
   audited (``EGProblem.audit_schedule``), with its makespan, average JCT
   and solves, their device head apart from their host tail, within 1e-3
   of the JAX package's run on the CPU; on 8 of its windows spread over
   their job counts the pdhg plan's objective at least the level
   backend's less 1e-3 of it (the JAX package's bar,
   tests/test_pdhg.py:47-58); the 12-job trace under
   ``shockwave_tpu_pdhg`` and ``shockwave_tpu_relaxed`` within 1e-3 of the
   JAX package's metrics, every launch of the tier and of both golden
   runs taking an instantiation with its per-job state in shared memory;
   (b) each kernel against its plain version on the card on seeded
   problems of 64, 256, 1024 and 4096 jobs (256 GPUs, 20 rounds) and on
   those 8 windows: ``s`` within rtol = atol = 5e-3, the objective within
   1e-3 (1 + |obj|), the rounded counts' objective within 2e-3 (1 + |o|),
   two runs bitwise equal, and equal in every bit to the kernel's
   sequential instantiation (one bisection step a barrier, state in
   global memory); (c) the degradation ladder: the 12-job trace under
   ``shockwave_tpu`` with a planning deadline and one injected
   ``solver_timeout``, whose record must show the pdhg rung ``ok``; (d)
   at 256 to 65536 jobs the wrapper's instantiation and the sequential
   one timed in turns, each with its block barriers and its floor (the
   barriers at a probe kernel's us per empty reduction), the two equal
   in every bit, with the plain version's time (up to 4096 jobs) and the
   bounds. It prints one JSON line ``{"first_order": ...}``.
10. Prints one JSON line ``{"kernels": [...]}`` (a row for each kernel
   and mode) and, last, ``{"ok": true, "device": {...}}``. Every printed
   reading of the ring phase carries the card's name and power limit.

Any failed phase exits nonzero without the last line. It needs one card
and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "_smoke_ckpt"

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

SOURCE = "shockwave_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "shockwave_tpu/ops/flash_attention.py:285",
    "flash_dkv": "shockwave_tpu/ops/flash_attention.py:491",
    "flash_dq": "shockwave_tpu/ops/flash_attention.py:543",
    # Jitted XLA loops, not Pallas kernels: the planner's device work.
    "eg_pdhg": "shockwave_tpu/solver/eg_pdhg.py:121",
    "eg_relaxed": "shockwave_tpu/solver/eg_jax.py:121",
}
SOURCES = {
    "eg_pdhg": "shockwave_tpu_torch/ops/csrc/eg_pdhg.cu",
    "eg_relaxed": "shockwave_tpu_torch/ops/csrc/eg_relaxed.cu",
}
# Widths of the tiles the bf16 kernels walk (FWD_BN, DKV_BQ and DQ_BN in
# the source): a planted fault skips one such tile.
DKV_Q_TILE = 64
DQ_K_TILE = 128


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def live_pairs(S: int, window, causal: bool = True, Sk=None) -> int:
    """(row, col) score entries the mask keeps: the causal (windowed) ones,
    or every one of S x Sk when not causal."""
    if not causal:
        return S * (S if Sk is None else Sk)
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def bound(kernel: str, bh: int, bhkv: int, S: int, D: int, dtype, window,
          causal: bool = True, Sk=None):
    """Least time (ms) for the kernel's work on an H100 SXM, and what
    bounds it: products over the live entries at the dtype's tensor rate,
    or each input read once and each output written once. q-like tensors
    have S rows, k/v (and dk/dv, per query head) Sk."""
    Sk = S if Sk is None else Sk
    products = {"flash_fwd": 2, "flash_dkv": 4, "flash_dq": 3}[kernel]
    flops = products * 2 * D * live_pairs(S, window, causal, Sk) * bh
    e = torch.tensor([], dtype=dtype).element_size()
    qlike, kvlike, rows = bh * S * D * e, bhkv * Sk * D * e, bh * S * 4
    nbytes = {
        "flash_fwd": qlike + 2 * kvlike + qlike + rows,
        "flash_dkv": 2 * qlike + 2 * kvlike + 2 * rows + 2 * bh * Sk * D * e,
        "flash_dq": 2 * qlike + 2 * kvlike + 2 * rows + qlike,
    }[kernel]
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# Kernels whose SASS must hold wgmma and TMA loads, at every head dim.
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_dkv_bf16", "flash_dq_bf16")


def kernel_of(mangled: str):
    """(kernel, head dim, causal) of a mangled instantiation such as
    ``..._14flash_fwd_bf16ILi128ELb1EEEv...``, or None for another
    symbol."""
    m = re.search(r"\d(flash_(?:fwd|dkv|dq)_(?:bf16|f32))ILi(\d+)ELb([01])E",
                  mangled)
    return (m.group(1), int(m.group(2)), m.group(3) == "1") if m else None


def inspect_library(_build, path):
    """Print registers, stack, shared and local memory of each kernel
    (cuobjdump -res-usage); fail unless the SASS of every instantiation of
    HOPPER_KERNELS holds HGMMA (wgmma) and UTMALDG (TMA tile load)
    instructions, or if the build log shows ptxas serialising wgmma
    instructions (it then waits on each product before the next, which
    the kernels' overlaps rely on it not doing). Returns
    {(kernel, D): {"REG": .., "STACK": .., ...}}."""
    serialized = [line.strip() for line in
                  path.with_suffix(".log").read_text().splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    for line in serialized:
        print(f"  {line}")
    if serialized:
        fail(f"ptxas serialised wgmma in {len(serialized)} function(s)")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")

    def dump(flag):
        return subprocess.run([str(cuobjdump), flag, str(path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    usage, current = {}, None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function"):
            current = kernel_of(line)
        elif current and "REG:" in line:
            usage[current] = {k: int(v) for k, v in
                              re.findall(r"(\w+):(\d+)", line)}
    print("kernel resources (cuobjdump -res-usage; LOCAL > 0 would be "
          "spills):")
    for (name, D, causal), u in sorted(usage.items()):
        print(f"  {name}<{D}, {'causal' if causal else 'non-causal'}>: "
              f"{u['REG']} registers, stack {u['STACK']} B, static shared "
              f"{u['SHARED']} B, local {u['LOCAL']} B")
    counts, current = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            current = kernel_of(line)
            counts.setdefault(current, {"HGMMA": 0, "UTMALDG": 0})
        elif current:
            for op in ("HGMMA", "UTMALDG"):
                counts[current][op] += op in line
    print("SASS of the bf16 kernels (cuobjdump -sass):")
    missing = []
    for name in HOPPER_KERNELS:
        for D in (16, 32, 64, 128):
            for causal in (True, False):
                c = counts.get((name, D, causal), {"HGMMA": 0, "UTMALDG": 0})
                label = f"{name}<{D}, {'causal' if causal else 'non-causal'}>"
                print(f"  {label}: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                      "UTMALDG")
                if not (c["HGMMA"] and c["UTMALDG"]):
                    missing.append(label)
    if missing:
        fail("no wgmma (HGMMA) or TMA (UTMALDG) instructions in "
             + ", ".join(missing))
    return usage


def check_kernels(fa, bench, label, seed, B, S, H, Hkv, D, dtype, window,
                  device, causal=True, Sk=None):
    """Each kernel against its plain version on the same inputs from
    ``seed``, under ``fa.KERNEL_TOLERANCE`` (``bench.check_kernels``).
    Prints the readings of every output and fails after the last if any
    broke a limit. Returns the largest absolute error of each kernel, and
    the inputs and plain outputs."""
    found, inputs, plain = bench.check_kernels(
        fa, fa, seed, B, S, H, Hkv, D, dtype, window, device, causal=causal,
        Sk=Sk)
    errors, broken = {}, []
    for (kernel, what), r in found.items():
        print(f"  {label} seed {seed} {kernel} {what}: " + bench.describe(r))
        if not r["ok"]:
            broken.append(f"{label} seed {seed} {kernel} {what}")
        errors[kernel] = max(errors.get(kernel, 0.0), r["max_abs_err"])
    if broken:
        fail("disagree with their plain versions: " + ", ".join(broken))
    return errors, inputs, plain


def planted_faults(fa, q, k, v, g, lse, delta, num_q_heads, causal=True):
    """What a kernel with one bug would return on these inputs (no window,
    as many KV heads as q heads, Sk = S, in the mode ``causal``), from the
    plain versions' math: the forward skipping the k tile at mid-sequence,
    dQ skipping the k tile there and dK/dV the q tile there, each of the
    width that kernel walks, and the forward weighting the later half of
    its rows 2% high. Returns {(output, fault): tensor}."""
    BH, S, D = q.shape
    dtype = q.dtype
    s = fa._masked_scores(q, k, num_q_heads, None, causal)
    s_skip = s.clone()
    s_skip[:, :, S // 2:S // 2 + fa._FWD_K_TILE] = -1e30
    p_skip = torch.softmax(s_skip, dim=-1)
    out_skip = (p_skip.to(dtype).float() @ v.float()).to(dtype)
    del s_skip, p_skip

    def grads(p):
        ds = (p * (g.float() @ v.float().transpose(1, 2) - delta[..., None]))
        return p.to(dtype).float(), ds.to(dtype).float()

    p = torch.exp(s - lse[..., None])
    del s
    p_cols = p.clone()
    p_cols[:, :, S // 2:S // 2 + DQ_K_TILE] = 0
    _, ds = grads(p_cols)
    dq = ((ds @ k.float()) / math.sqrt(D)).to(dtype)
    p[:, S // 2:S // 2 + DKV_Q_TILE, :] = 0
    p_rows, ds = grads(p)
    dv = (p_rows.transpose(1, 2) @ g.float()).to(dtype)
    dk = (ds.transpose(1, 2) @ q.float()).to(dtype)
    out_heavy = fa.flash_fwd_plain(q, k, v, num_q_heads, None,
                                   causal)[0].clone()
    out_heavy[:, S // 2:] = (out_heavy[:, S // 2:].float() * 1.02).to(dtype)
    return {("out", "k tile skipped"): out_skip, ("dq", "k tile skipped"): dq,
            ("dk", "q tile skipped"): dk, ("dv", "q tile skipped"): dv,
            ("out", "later rows 2% heavy"): out_heavy}


def check_planted_faults(fa, bench, inputs, plain, H, causal=True):
    """The tolerance, flip terms included, must reject every planted
    fault."""
    tol = fa.KERNEL_TOLERANCE[inputs[0].dtype]
    terms = fa.largest_terms(*inputs, H, None, causal)
    mode = "" if causal else "non-causal "
    for (what, fault), bad in planted_faults(fa, *inputs, H, causal).items():
        r = fa.compare(bad, plain[what], tol, terms[what])
        print(f"  planted fault, {mode}{what} with {fault}: "
              + bench.describe(dict(r, tol=tol)))
        if r["ok"]:
            fail(f"the tolerance accepts {what} with {fault}")
    sync()


def check_small_model(device):
    """A small model on the card: the flash kernels against the dense
    reference on the same weights, loss and every gradient, float32."""
    from shockwave_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    kw = dict(vocab_size=512, d_model=256, num_heads=2, num_layers=2,
              d_ff=1024, max_len=256)
    gen = torch.Generator().manual_seed(3)
    flash = TransformerLM(TransformerConfig(**kw, attention="flash"), gen)
    dense = TransformerLM(TransformerConfig(**kw, attention="dense"))
    dense.load_state_dict(flash.state_dict())
    flash.to(device), dense.to(device)
    tokens = torch.randint(0, 512, (2, 257), generator=gen).to(device)
    losses = []
    for model in (flash, dense):
        loss = lm_loss(model, tokens)
        loss.backward()
        losses.append(float(loss.detach()))
    sync()
    if not all(math.isfinite(x) for x in losses):
        fail(f"small model: non-finite loss {losses}")
    if abs(losses[0] - losses[1]) > 1e-4 * abs(losses[1]):
        fail(f"small model: flash loss {losses[0]} vs dense {losses[1]}")
    worst = 0.0
    for (name, p), q in zip(flash.named_parameters(), dense.parameters()):
        err = float((p.grad - q.grad).abs().max())
        scale = float(q.grad.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if err > 1e-3 * scale:
            fail(f"small model: gradient {name} off by {err} (scale {scale})")
    print(f"small model (f32, S=256, D=128): flash loss {losses[0]:.6f} "
          f"dense {losses[1]:.6f}; worst gradient error {worst:.2e} of max")


def train_args(steps: int, attention: str = "flash"):
    """The 110M tier's command line (its checkpoint in CKPT_DIR)."""
    return ["--model", "Transformer", "--batch_size", "8", "-n", str(steps),
            "--vocab_size", "8192", "--d_model", "1024", "--num_heads", "8",
            "--num_layers", "8", "--seq_len", "2048", "--attention", attention,
            "--dtype", "bfloat16", "--learning_rate", "1e-3", "--seed", "0",
            "--checkpoint_dir", str(CKPT_DIR), "--device", "cuda"]


def run_main_path(fa, train, steps: int, resume: bool):
    fa.reset_launch_counts()
    result = train.main(train_args(steps))
    launches = dict(fa.LAUNCHES)
    if result["resumed"] != resume:
        fail(f"expected resumed={resume}, got {result['resumed']}")
    losses = result["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"losses {losses}")
    for name, count in launches.items():
        expected = 0 if name.endswith("_nc") else 8 * steps
        if count != expected:
            fail(f"{name} launched {count} times in {steps} steps of an "
                 f"8-layer model, expected {expected}")
    return result, launches


# The ring phase: a 4-shard seq mesh of the one card. At the 110M tier's
# seq 2048 a shard holds 512 tokens, so a hop is B=8, Sq=Sk=512, H=8, D=128.
RING_SHARDS = 4
RING_GQA = dict(B=2, S=512, Sk=1024, H=4, Hkv=2, D=64)
# The ring 110M tier against the flash model on the same seed-0 weights and
# batches, bf16. On an H100 the first losses are 4.9e-6 apart (relative),
# the five steps' at most 1.1e-5, and every parameter's gradient on the
# first batch within 0.032 of the flash model's (relative Frobenius; the
# last layers' query and key weights, whose gradients are small at random
# weights). A live hop dropped or weighted twice, in every layer or in the
# last alone, moves some parameter's gradient by 0.125 or more, and the
# first loss by as little as 8e-6.
RING_LOSS_RTOL = 2e-5
RING_STEPS_RTOL = 5e-5
RING_GRAD_RTOL = 0.08


def check_ring_against_flash(device):
    """Ring attention (flash body, a RING_SHARDS-shard seq mesh of the
    card) against flash_attention on the same float32 inputs: output and
    q/k/v gradients within rtol 1e-3, atol 1e-4, the JAX package's limits
    for ring against dense (tests/test_ring_attention.py). Returns the
    largest absolute error."""
    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.parallel.mesh import make_mesh
    from shockwave_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh((1, 1, RING_SHARDS, 1), [device] * RING_SHARDS)
    gen = torch.Generator(device=device).manual_seed(0)
    B, S, H, Hkv, D = 2, 1024, 4, 2, 64
    inputs = [torch.randn(B, S, h, D, generator=gen, device=device)
              for h in (H, Hkv, Hkv)]
    w = torch.randn(B, S, H, D, generator=gen, device=device)
    results = []
    for attend in (lambda *a: ring_attention(*a, mesh, inner="flash"),
                   fa.flash_attention):
        leaves = [x.clone().requires_grad_() for x in inputs]
        out = attend(*leaves)
        (out * w).sum().backward()
        results.append([out.detach()] + [x.grad for x in leaves])
    sync()
    worst = 0.0
    for what, got, ref in zip(("out", "dq", "dk", "dv"), *results):
        err = (got - ref).abs()
        worst = max(worst, float(err.max()))
        over = int((err > 1e-4 + 1e-3 * ref.abs()).sum())
        if over or not bool(torch.isfinite(got).all()):
            fail(f"ring against flash: {what} has {over} elements past "
                 "rtol 1e-3, atol 1e-4")
    return worst


def loss_and_grads(model, batch):
    """The model's loss on ``batch`` and each parameter's gradient, in
    float32; leaves no gradient on the model."""
    from shockwave_tpu_torch.models.transformer import lm_loss

    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, batch)
    loss.backward()
    grads = {name: p.grad.float() for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def worst_grad_error(grads, ref):
    """(name, error) of the parameter whose gradient is furthest from
    ``ref``'s, in relative Frobenius norm."""
    errors = {name: float((grads[name] - g).norm() / g.norm().clamp_min(
        1e-30)) for name, g in ref.items()}
    name = max(errors, key=errors.get)
    return name, errors[name]


def ring_fault(attend, kind: str, layers, live: int):
    """``flash_attention_lse`` as the ring's flash body would see it with
    one bug: in each layer of ``layers`` (None: every layer) the last live
    hop (the last shard attending the first shard's block) is dropped
    (``kind`` "drop": its lse is -inf, so the merge gives it no weight) or
    weighted twice ("double": its lse raised by ln 2). ``live`` is the
    count of live hops a layer; a forward calls the body's non-causal
    hops layer by layer, each layer's in hop order."""
    calls = [0]

    def faulty(q, k, v, causal=True, window=None):
        out, lse = attend(q, k, v, causal=causal, window=window)
        if causal:
            return out, lse
        layer, hop = divmod(calls[0], live)
        calls[0] += 1
        if hop == live - 1 and (layers is None or layer in layers):
            lse = (torch.full_like(lse, -math.inf) if kind == "drop"
                   else lse + math.log(2.0))
        return out, lse

    return faulty


def run_ring(fa, bench, train, device, card, flash_losses):
    """The ring slice (docstring, item 7): the kernels against their
    plain versions at the ring's shapes with planted faults rejected, ring
    against flash, the 110M tier under ring attention (its first loss and
    gradients against the flash model's, planted hop faults rejected, 5
    steps against ``flash_losses``, the flash run's, and its launches),
    ``train.main --attention ring --seq_parallel 1`` for 2 steps, and the
    non-causal kernels timed. Returns the readings; fails on any miss."""
    from shockwave_tpu_torch.parallel import ring_attention as ra
    from shockwave_tpu_torch.parallel.mesh import make_mesh

    B, S, H, D = bench.HOP_SHAPE
    print(f"ring phase [{card}]: the kernels against their plain versions "
          "at the shapes the ring gives them:", flush=True)
    # Hop 0 of every shard is a causal launch at the hop shape.
    causal_errors = check_kernels(fa, bench, "ring-hop causal bf16", 0, B, S,
                                  H, H, D, torch.bfloat16, None, device)[0]
    errors, inputs, plain = check_kernels(
        fa, bench, "ring-hop bf16", 0, B, S, H, H, D, torch.bfloat16, None,
        device, causal=False)
    g = RING_GQA
    for dtype in (torch.bfloat16, torch.float32):
        label = f"gqa Sk!=Sq {'bf16' if dtype == torch.bfloat16 else 'f32'}"
        found = check_kernels(fa, bench, label, 0, g["B"], g["S"], g["H"],
                              g["Hkv"], g["D"], dtype, None, device,
                              causal=False, Sk=g["Sk"])[0]
        if dtype == torch.bfloat16:
            errors = {k: max(e, found[k]) for k, e in errors.items()}
    print("planted faults against the bf16 tolerance, non-causal (all must "
          "fail it):")
    check_planted_faults(fa, bench, inputs, plain, H, causal=False)
    del inputs, plain
    ring_err = check_ring_against_flash(device)
    print(f"ring ({RING_SHARDS} shards of one card, flash body) against "
          f"flash_attention, f32 B=2 S=1024 H=4 Hkv=2 D=64: out and q/k/v "
          f"gradients within rtol 1e-3 atol 1e-4, largest |err| "
          f"{ring_err:.3e} [{card}]", flush=True)

    # The flash model's loss and gradients on the seed-0 weights and first
    # batch, against the ring model's on the same.
    args = train.parse_args(train_args(5, "flash"))
    model, _, _, batch_fn = train.build_family("Transformer", args, device)
    first_batch = batch_fn(np.random.default_rng(args.seed))
    flash_loss, flash_grads = loss_and_grads(model, first_batch)
    del model

    args = train.parse_args(train_args(5, "ring"))
    mesh = make_mesh((1, 1, RING_SHARDS, 1), [device] * RING_SHARDS)
    model, step_fn, _, batch_fn = train.build_family("Transformer", args,
                                                     device, mesh)
    live = RING_SHARDS * (RING_SHARDS - 1) // 2
    ring_loss, grads = loss_and_grads(model, first_batch)
    grad_err = worst_grad_error(grads, flash_grads)
    del grads
    loss_err = abs(ring_loss - flash_loss) / abs(flash_loss)
    print(f"110M tier, first batch: ring loss {ring_loss!r} against flash's "
          f"{flash_loss!r} ({loss_err:.3e} relative, limit "
          f"{RING_LOSS_RTOL:g}); worst gradient {grad_err[0]} at "
          f"{grad_err[1]:.4f} relative (limit {RING_GRAD_RTOL:g}) [{card}]",
          flush=True)
    if loss_err > RING_LOSS_RTOL or grad_err[1] > RING_GRAD_RTOL:
        fail("ring 110M tier: first loss or gradients past their limits")
    print("planted hop faults against those limits (all must fail them):")
    last = args.num_layers - 1
    faults = {}
    for kind, layers in (("drop", None), ("drop", (last,)),
                         ("double", None), ("double", (last,))):
        attend = ra.flash_attention_lse
        ra.flash_attention_lse = ring_fault(attend, kind, layers, live)
        try:
            f_loss, f_grads = loss_and_grads(model, first_batch)
        finally:
            ra.flash_attention_lse = attend
        f_name, f_err = worst_grad_error(f_grads, flash_grads)
        del f_grads
        f_loss_err = abs(f_loss - flash_loss) / abs(flash_loss)
        what = (f"last live hop {'dropped' if kind == 'drop' else 'doubled'}"
                f" in {'every layer' if layers is None else f'layer {last}'}")
        faults[what] = {"loss_rel": f_loss_err, "worst_grad": f_name,
                        "worst_grad_rel": f_err}
        print(f"  {what}: loss {f_loss_err:.3e} relative, worst gradient "
              f"{f_name} at {f_err:.4f}")
        if f_loss_err <= RING_LOSS_RTOL and f_err <= RING_GRAD_RTOL:
            fail(f"the ring limits accept the {what}")
    del flash_grads

    np_rng = np.random.default_rng(args.seed)
    sync()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses = [step_fn(batch_fn(np_rng))]
    sync()
    start = time.perf_counter()
    for _ in range(args.num_steps - 1):
        losses.append(step_fn(batch_fn(np_rng)))
    sync()
    steady_s = (time.perf_counter() - start) / (args.num_steps - 1)
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del model, step_fn
    losses = [float(x) for x in losses]
    steps_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         flash_losses))
    print(f"110M tier, ring on a (1, 1, {RING_SHARDS}, 1) mesh of one card: "
          f"losses {losses} against the flash run's {flash_losses} (at most "
          f"{steps_err:.3e} relative, limit {RING_STEPS_RTOL:g}); "
          f"{1 / steady_s:.3f} steps/s after the "
          f"first ({args.batch_size * args.seq_len / steady_s:.0f} "
          f"tokens/s); peak memory {peak_gib:.2f} GiB; launches {launches} "
          f"[{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"ring 110M tier: losses {losses}")
    if len(losses) != len(flash_losses) or steps_err > RING_STEPS_RTOL:
        fail(f"ring 110M tier: losses {losses} against the flash run's "
             f"{flash_losses}, past {RING_STEPS_RTOL:g} of them")
    # A layer runs RING_SHARDS causal hops and P(P-1)/2 live non-causal
    # ones, forward and backward.
    layers, steps = args.num_layers, args.num_steps
    for name, count in launches.items():
        expected = layers * steps * (live if name.endswith("_nc")
                                     else RING_SHARDS)
        if count != expected:
            fail(f"ring 110M tier: {name} launched {count} times in {steps} "
                 f"steps, expected {expected}")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        fa.reset_launch_counts()
        one = train.main(train_args(2, "ring") + ["--seq_parallel", "1"])
        one_launches = dict(fa.LAUNCHES)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"train.main --attention ring --seq_parallel 1: losses "
          f"{one['losses']}, launches {one_launches} [{card}]", flush=True)
    if len(one["losses"]) != 2 or not all(math.isfinite(x)
                                          for x in one["losses"]):
        fail(f"train.main --attention ring: losses {one['losses']}")
    if one_launches != {name: 0 if name.endswith("_nc") else 2 * layers
                        for name in one_launches}:
        fail(f"train.main --attention ring --seq_parallel 1: launches "
             f"{one_launches}")

    ms, sdpa_fwd, sdpa_bwd = bench.time_kernels(fa, B, S, H, D,
                                                torch.bfloat16, device,
                                                causal=False)
    return {"max_abs_err": errors, "causal_max_abs_err": causal_errors,
            "ring_vs_flash_max_abs_err": ring_err,
            "flash_first_loss": flash_loss, "ring_first_loss": ring_loss,
            "first_loss_rel": loss_err, "worst_grad": grad_err[0],
            "worst_grad_rel": grad_err[1], "planted_hop_faults": faults,
            "losses": losses, "flash_losses": flash_losses,
            "losses_max_rel": steps_err,
            "steps_per_s": 1 / steady_s,
            "tokens_per_s": args.batch_size * args.seq_len / steady_s,
            "peak_gib": peak_gib, "launches": launches,
            "seq_parallel_1": {"losses": one["losses"],
                               "launches": one_launches},
            "ms": ms, "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd}


def run_simulation(device) -> dict:
    """Phases (a)-(d) of the simulation path (docstring, item 8); fails
    on any metric past its tolerance, a level solve off the card or
    counts that differ from the CPU's."""
    from shockwave_tpu_torch.tools import bench_sim as sim

    golden = {}
    for policy in ("shockwave_tpu_level", "shockwave_native"):
        r = sim.run_trace(sim.GOLDEN_TRACE, policy, 8, device)
        print(f"golden trace, {policy}: makespan {r['makespan']:.3f} avg "
              f"JCT {r['avg_jct']:.3f} worst FTF {r['worst_ftf']:.3f}, "
              f"{r['rounds']} rounds, solves {r['solves']} on "
              f"{r['device_solves']}, {r['wall_s']:.2f} s", flush=True)
        bad = sim.check_run(r, sim.GOLDEN[policy])
        if bad:
            fail(f"golden trace under {policy}: " + ", ".join(bad))
        golden[policy] = r
    level = golden["shockwave_tpu_level"]
    if level["device_solves"] != {"cuda": 16} or level["solves"] != {
            "level": 16}:
        fail(f"golden level run: expected 16 level solves on cuda, got "
             f"{level['solves']} on {level['device_solves']}")

    problems = []
    tier = sim.run_trace(sim.TRACE_2048, "shockwave_tpu", 256, device,
                         capture=problems)
    print(f"2048-job tier, shockwave_tpu on 256 GPUs: makespan "
          f"{tier['makespan']:.3f} avg JCT {tier['avg_jct']:.3f} worst FTF "
          f"{tier['worst_ftf']:.3f}, {tier['rounds']} rounds; solves "
          f"{tier['solves']} taking {tier['solve_s']} s (level solves by "
          f"device {tier['device_solves']}); wall {tier['wall_s']:.2f} s",
          flush=True)
    bad = sim.check_run(tier, sim.TIER_2048)
    if bad:
        fail("2048-job tier: " + ", ".join(bad))
    on_card = tier["device_solves"].get("cuda", 0)
    if on_card == 0 or on_card != tier["solves"].get("level", 0):
        fail(f"2048-job tier: level solves {tier['solves']} but "
             f"{tier['device_solves']} by device")

    bad, report = sim.solve_report(device, problems)
    if bad:
        fail("level solve on the card against the CPU's: " + "; ".join(bad))
    return {"golden": golden, "tier_2048": tier, **report}


def check_resident(what: str, run: dict, kernel: str) -> None:
    """Fails unless every launch of ``kernel`` in ``run`` (a
    ``bench_sim.run_trace`` result) took a resident instantiation: the
    per-job state in shared memory."""
    variants = run["variants"][kernel]
    print(f"  {what}: {kernel} launches by instantiation {variants}",
          flush=True)
    if not variants or any(not v.endswith("-resident") for v in variants) \
            or sum(variants.values()) != run["launches"][kernel]:
        fail(f"{what}: {kernel} launched {variants}, not every launch "
             f"resident")


def run_first_order(device) -> dict:
    """Phases (a)-(d) of the first-order backends (docstring, item 9);
    fails on a plan that is not feasible, a window where pdhg falls below
    the level backend's bar, a metric past its tolerance, a kernel that
    disagrees with its plain version or repeats differently, a ladder that
    did not absorb the fault on its pdhg rung, or a kernel the main path
    did not launch. Returns the readings and each kernel's main-path
    launches."""
    from shockwave_tpu_torch.runtime import faults
    from shockwave_tpu_torch.solver import eg_pdhg as pdhg_solver
    from shockwave_tpu_torch.solver.eg_level import solve_eg_level
    from shockwave_tpu_torch.solver.eg_pdhg import solve_eg_pdhg
    from shockwave_tpu_torch.tools import bench_sim as sim

    # The device head of each pdhg solve (pack, copy, kernel A, fetch),
    # timed apart from the solve's host tail (rounding, polish, placement).
    head = {"s": 0.0}
    device_head = pdhg_solver.solve_pdhg_relaxed

    def timed_head(*args, **kwargs):
        start = time.perf_counter()
        try:
            return device_head(*args, **kwargs)
        finally:
            head["s"] += time.perf_counter() - start

    problems, plans = [], []
    pdhg_solver.solve_pdhg_relaxed = timed_head
    try:
        tier = sim.run_trace(sim.TRACE_2048, "shockwave_tpu_pdhg", 256,
                             device, capture=problems, plans=plans)
    finally:
        pdhg_solver.solve_pdhg_relaxed = device_head
    tier["device_head_s"] = head["s"]
    launches = {"eg_pdhg": tier["launches"]["eg_pdhg"]}
    for problem, (round_index, Y) in zip(problems, plans):
        try:
            problem.audit_schedule(Y)
        except AssertionError as e:
            fail(f"2048-job tier under pdhg, round {round_index}: {e}")
    print(f"2048-job tier, shockwave_tpu_pdhg on 256 GPUs: makespan "
          f"{tier['makespan']:.3f} avg JCT {tier['avg_jct']:.3f} worst FTF "
          f"{tier['worst_ftf']:.3f}, {tier['rounds']} rounds; solves "
          f"{tier['solves']} taking {tier['solve_s']} s (device head "
          f"{head['s']:.3f} s, the rest the host tail), kernel A launched "
          f"{launches['eg_pdhg']} times; {len(plans)} plans audited; wall "
          f"{tier['wall_s']:.2f} s", flush=True)
    off = sim.check_run(tier, sim.TIER_2048_PDHG)
    print(f"  against the JAX package's run on the CPU "
          f"({sim.TIER_2048_PDHG}): "
          + (", ".join(off) if off else "within 1e-3"), flush=True)
    if off:
        fail("2048-job tier under pdhg against the JAX package's run: "
             + ", ".join(off))
    if tier["solves"] != {"pdhg": len(plans)} or launches["eg_pdhg"] < len(
            plans):
        fail(f"2048-job tier under pdhg: solves {tier['solves']}, kernel A "
             f"launches {launches}, {len(plans)} plans")
    check_resident("2048-job tier under pdhg", tier, "eg_pdhg")
    windows = sim.sample_by_jobs(problems, 8)
    vs_level = []
    for problem in windows:
        Y_pdhg = solve_eg_pdhg(problem, device=device)
        problem.audit_schedule(Y_pdhg)
        o_pdhg = problem.objective_value(Y_pdhg)
        o_level = problem.objective_value(solve_eg_level(problem, device))
        vs_level.append(dict(jobs=problem.num_jobs, pdhg=o_pdhg,
                             level=o_level))
        print(f"  window of {problem.num_jobs} jobs: pdhg objective "
              f"{o_pdhg!r}, level {o_level!r}", flush=True)
        if o_pdhg < o_level - 1e-3 * abs(o_level):
            fail(f"window of {problem.num_jobs} jobs: pdhg objective "
                 f"{o_pdhg} below level {o_level} by more than 1e-3")

    golden = {}
    for policy, expected in sim.GOLDEN_FIRST_ORDER.items():
        r = sim.run_trace(sim.GOLDEN_TRACE, policy, 8, device)
        print(f"golden trace, {policy}: makespan {r['makespan']:.3f} avg "
              f"JCT {r['avg_jct']:.3f} worst FTF {r['worst_ftf']:.3f}, "
              f"solves {r['solves']}, kernel launches {r['launches']}",
              flush=True)
        bad = sim.check_run(r, expected)
        if bad:
            fail(f"golden trace under {policy}: " + ", ".join(bad))
        check_resident(f"golden trace under {policy}", r,
                       "eg_pdhg" if policy.endswith("pdhg") else "eg_relaxed")
        golden[policy] = {k: r[k] for k in ("makespan", "avg_jct",
                                            "worst_ftf", "solves",
                                            "launches", "variants",
                                            "wall_s")}
    launches["eg_relaxed"] = golden["shockwave_tpu_relaxed"]["launches"][
        "eg_relaxed"]
    for name, count in launches.items():
        if count == 0:
            fail(f"the main path launched {name} no time")

    print("first-order kernels against their plain versions and their "
          f"sequential instantiations (seeded problems of "
          f"{sim.EG_CHECK_BANDS} jobs, 8 tier windows):", flush=True)
    checked = [sim.seeded_problem(jobs) for jobs in sim.EG_CHECK_BANDS]
    bad, max_err = sim.check_eg_kernels(checked + windows, device)
    if bad:
        fail("first-order kernels against their plain versions or their "
             "sequential instantiations: " + "; ".join(bad))
    print(f"  both kernels within the limits on {len(checked + windows)} "
          f"problems, bitwise repeatable and equal to the sequential "
          f"instantiation in every bit; largest |s| error {max_err}",
          flush=True)

    faults.configure(faults.FaultPlan(
        seed=0, events=[faults.FaultEvent(0, "solver_timeout", round=0)]))
    try:
        r = sim.run_trace(sim.GOLDEN_TRACE, "shockwave_tpu", 8, device,
                          config={"plan_deadline_s": 30.0})
    finally:
        faults.reset()
    degraded = [rec for rec in r["records"] if rec.get("degraded")]
    print(f"ladder: golden trace under shockwave_tpu with a 30 s deadline "
          f"and one injected solver_timeout: degraded solves {degraded}",
          flush=True)
    if len(degraded) != 1 or degraded[0]["ladder"] != [
            {"backend": "tpu", "outcome": "timeout_injected"},
            {"backend": "pdhg", "outcome": "ok"}]:
        fail(f"ladder did not absorb the timeout on its pdhg rung: "
             f"{degraded}")
    print("first-order kernels timed, the wrapper's instantiation and the "
          f"sequential one in turns (CUDA events, median of {sim.EG_ITERS}; "
          f"plain: one run, up to {sim.EG_PLAIN_MAX_JOBS} jobs):", flush=True)
    timings = sim.time_eg_kernels(device)
    differ = [f"{r['kernel']} {r['jobs']} jobs" for r in timings
              if not r["identical"]]
    if differ:
        fail("instantiations that differ from the sequential one in some "
             "bit: " + ", ".join(differ))
    return {"tier_2048_pdhg": {k: tier[k] for k in (
                "makespan", "avg_jct", "worst_ftf", "rounds", "solves",
                "solve_s", "device_head_s", "launches", "wall_s")},
            "windows_vs_level": vs_level, "golden": golden,
            "max_abs_err": max_err, "ladder": degraded,
            "timings": timings, "launches": launches}


def main() -> None:
    started = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT))
    try:
        from shockwave_tpu_torch.models import train
        from shockwave_tpu_torch.ops import _build
        from shockwave_tpu_torch.ops import flash_attention as fa
        from shockwave_tpu_torch.tools import bench_flash as bench
        from shockwave_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")

    device = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t0 = time.time()
    libraries = _build.build_all(["flash_attention", *SOURCES])
    print(f"built kernels in {time.time() - t0:.1f} s (one nvcc each, "
          f"together: {', '.join(p.name for p in libraries.values())})",
          flush=True)
    usage = inspect_library(_build, libraries["flash_attention"])
    from shockwave_tpu_torch.tools.bench_sim import ptxas_usage

    for name in SOURCES:
        u = ptxas_usage(libraries[name])
        usage[(name, None)] = u
        for kernel, k in u.items():
            print(f"  {name} {kernel}: {k['REG']} registers, {k['STACK']} "
                  f"bytes of stack, {k['SPILL']} bytes of spill stores, "
                  f"{k['SMEM']} bytes of static shared memory (ptxas -v)")

    print("kernels against their plain versions:")
    B, S, H, D = bench.TRAIN_SHAPE
    # Seed 1 as well: on its inputs a few elements need the flip term.
    errors = check_kernels(fa, bench, "train-shape bf16", 1, B, S, H, H, D,
                           torch.bfloat16, None, device)[0]
    seed0, inputs, plain = check_kernels(
        fa, bench, "train-shape bf16", 0, B, S, H, H, D, torch.bfloat16,
        None, device)
    errors = {name: max(err, seed0[name]) for name, err in errors.items()}
    check_kernels(fa, bench, "gqa-window bf16 D=64", 0, 2, 512, 4, 2, 64,
                  torch.bfloat16, 200, device)
    check_kernels(fa, bench, "gqa-window bf16 D=128", 0, 1, 1024, 4, 1, 128,
                  torch.bfloat16, 333, device)
    check_kernels(fa, bench, "gqa-window f32", 0, 2, 512, 4, 2, 64,
                  torch.float32, 200, device)
    print("planted faults against the bf16 tolerance (all must fail it):")
    check_planted_faults(fa, bench, inputs, plain, H)
    del inputs, plain

    ms, sdpa_fwd, sdpa_bwd = bench.time_kernels(fa, B, S, H, D,
                                                torch.bfloat16, device)
    check_small_model(device)

    os.environ["SHOCKWAVE_PHASE_TIMINGS"] = "1"
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        first, launches = run_main_path(fa, train, 5, resume=False)
        if abs(first["losses"][0] - math.log(8192)) > 0.5:
            fail(f"first loss {first['losses'][0]} is not near ln 8192")
        resumed, resume_launches = run_main_path(fa, train, 2, resume=True)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady_s = first["phases"]["train"] / (first["steps"] - 1)
    print(f"110M tier: losses {first['losses']} then resumed "
          f"{resumed['losses']}")
    print(f"110M tier: {first['steps'] / first['elapsed_s']:.3f} steps/s "
          f"over all {first['steps']} steps, {1 / steady_s:.3f} steps/s "
          f"after the first ({B * S / steady_s:.0f} tokens/s); "
          f"peak memory {peak_gib:.2f} GiB; launches {launches}, "
          f"resume {resume_launches} [{card}]")

    ring_started = time.time()
    ring = run_ring(fa, bench, train, device, card, first["losses"])
    ring["phase_s"] = time.time() - ring_started
    print(f"ring phase: {ring['phase_s']:.1f} s [{card}]", flush=True)
    print(f"110M tier step [{card}]: ring ({RING_SHARDS} shards) "
          f"{ring['steps_per_s']:.3f} steps/s, peak {ring['peak_gib']:.2f} "
          f"GiB; flash {1 / steady_s:.3f} steps/s, peak {peak_gib:.2f} GiB",
          flush=True)

    simulation = run_simulation(device)
    first_order = run_first_order(device)

    backward_ms = ms["flash_dkv"][0] + ms["flash_dq"][0]
    kernels = []
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        bound_ms, bound_by = bound(name, B * H, B * H, S, D, torch.bfloat16,
                                   None)
        res = usage.get((name + "_bf16", D, True), {})
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            # The training shape's and the ring's causal hop shape's.
            "max_abs_err": max(errors[name],
                               ring["causal_max_abs_err"][name]),
            "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sdpa_fwd if name == "flash_fwd" else None,
            "share_of_bound": bound_ms / ms[name][0],
            "registers": res.get("REG"), "local_bytes": res.get("LOCAL"),
        }
        if name != "flash_fwd":
            # SDPA's backward computes dq, dk and dv in one call.
            row["sdpa_backward_ms"] = sdpa_bwd
            row["backward_ms"] = backward_ms
        print(f"{name}: {ms[name][0]:.4f} ms (bound {bound_ms:.4f} ms by "
              f"{bound_by}, {100 * bound_ms / ms[name][0]:.1f}% of it; "
              f"plain {ms[name][1]:.3f} ms; SDPA "
              f"{'forward' if name == 'flash_fwd' else 'backward'} "
              f"{sdpa_fwd if name == 'flash_fwd' else sdpa_bwd:.4f} ms)")
        kernels.append(row)
    print(f"backward (flash_dkv + flash_dq): {backward_ms:.4f} ms; SDPA "
          f"backward {sdpa_bwd:.4f} ms ({backward_ms / sdpa_bwd:.2f}x) "
          f"[{card}]")
    hB, hS, hH, hD = bench.HOP_SHAPE
    nc_backward_ms = ring["ms"]["flash_dkv"][0] + ring["ms"]["flash_dq"][0]
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        t, t_plain = ring["ms"][name]
        bound_ms, bound_by = bound(name, hB * hH, hB * hH, hS, hD,
                                   torch.bfloat16, None, causal=False)
        res = usage.get((name + "_bf16", hD, False), {})
        row = {
            "name": name + "_nc", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": ring["launches"][name + "_nc"],
            "max_abs_err": ring["max_abs_err"][name], "ms": t,
            "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": ring["sdpa_fwd_ms"] if name == "flash_fwd"
            else None,
            "share_of_bound": bound_ms / t, "shape": list(bench.HOP_SHAPE),
            "registers": res.get("REG"), "local_bytes": res.get("LOCAL"),
        }
        if name != "flash_fwd":
            row["sdpa_backward_ms"] = ring["sdpa_bwd_ms"]
            row["backward_ms"] = nc_backward_ms
        print(f"{name} non-causal at the hop shape: {t:.4f} ms (bound "
              f"{bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / t:.1f}% of "
              f"it; plain {t_plain:.3f} ms; SDPA is_causal=False "
              f"{'forward' if name == 'flash_fwd' else 'backward'} "
              f"{ring['sdpa_fwd_ms'] if name == 'flash_fwd' else ring['sdpa_bwd_ms']:.4f}"
              f" ms) [{card}]")
        kernels.append(row)
    print(f"non-causal backward (flash_dkv + flash_dq) at the hop shape: "
          f"{nc_backward_ms:.4f} ms; SDPA backward {ring['sdpa_bwd_ms']:.4f} "
          f"ms [{card}]")
    for name, solver in (("eg_pdhg", "pdhg"), ("eg_relaxed", "relaxed")):
        rows = [r for r in first_order["timings"] if r["kernel"] == solver]
        # The row of the largest band the main path's instantiation (state
        # resident) takes and the plain version was timed at.
        row = [r for r in rows
               if r["resident"] and r["plain_ms"] is not None][-1]
        kernel = (f"{solver}_kernel<{row['levels']}, "
                  f"{'true' if row['resident'] else 'false'}>")
        res = usage[(name, None)].get(kernel, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": first_order["launches"][name],
            "max_abs_err": first_order["max_abs_err"][solver],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "jobs": row["jobs"],
            "ms_before": row["ms_before"],
            "barriers": row["barriers"],
            "barriers_before": row["barriers_before"],
            "floor_ms": row["floor_ms"],
            "floor_ms_before": row["floor_ms_before"],
            "us_per_barrier": row["us_per_barrier"],
            "state_hbm_ms": row["state_hbm_ms"],
            "state_l2_ms": row["state_l2_ms"],
            "instantiation": kernel,
            "registers": res.get("REG"), "spill_bytes": res.get("SPILL"),
            "stack_bytes": res.get("STACK"),
            "bands": [{k: r[k] for k in (
                "jobs", "slots", "levels", "resident", "ms", "ms_before",
                "barriers", "barriers_before", "floor_ms", "floor_ms_before",
                "identical", "bound_ms", "plain_ms")} for r in rows],
        })
        print(f"{name}: {row['ms']:.4f} ms at {row['jobs']} jobs ({kernel}; "
              f"sequential {row['ms_before']:.4f} ms; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}; "
              f"{row['barriers']} block barriers against "
              f"{row['barriers_before']}, floor {row['floor_ms']:.4f} ms; "
              f"plain {row['plain_ms']:.1f} ms; no PyTorch call computes "
              f"it) [{card}]")
    print(f"chip_smoke: all phases in {time.time() - started:.1f} s")
    for run in (simulation["tier_2048"], *simulation["golden"].values()):
        run.pop("records", None)
    print(json.dumps({"simulation": simulation, "card": card}))
    print(json.dumps({"first_order": first_order, "card": card}))
    print(json.dumps({"ring": {k: v for k, v in ring.items() if k != "ms"},
                      "card": card}))
    print(json.dumps({"kernels": kernels, "card": card,
                      "train_steps_per_s": 1 / steady_s,
                      "train_tokens_per_s": B * S / steady_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
