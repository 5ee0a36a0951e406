#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``shockwave_tpu_torch/ops/csrc`` into
   ``shockwave_tpu_torch/_build/`` (nvcc, a few seconds), prints each
   kernel's registers, stack and shared memory (``cuobjdump -res-usage``)
   and fails unless the SASS (``cuobjdump -sass``) of every bf16 forward,
   dK/dV and dQ instantiation holds wgmma (``HGMMA``) and TMA loads
   (``UTMALDG``), or if ptxas reported serialising any wgmma (the build
   log, ``-Xptxas -v``).
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
   of every kernel per step (one per layer).
7. Prints one JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``.

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


def live_pairs(S: int, window) -> int:
    """(row, col) score entries the causal (windowed) mask keeps."""
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def bound(kernel: str, bh: int, bhkv: int, S: int, D: int, dtype, window):
    """Least time (ms) for the kernel's work on an H100 SXM, and what
    bounds it: products over the live entries at the dtype's tensor rate,
    or each input read once and each output written once."""
    products = {"flash_fwd": 2, "flash_dkv": 4, "flash_dq": 3}[kernel]
    flops = products * 2 * D * live_pairs(S, window) * bh
    e = torch.tensor([], dtype=dtype).element_size()
    qlike, kvlike, rows = bh * S * D * e, bhkv * S * D * e, bh * S * 4
    nbytes = {
        "flash_fwd": qlike + 2 * kvlike + qlike + rows,
        "flash_dkv": 2 * qlike + 2 * kvlike + 2 * rows + 2 * qlike,
        "flash_dq": 2 * qlike + 2 * kvlike + 2 * rows + qlike,
    }[kernel]
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# Kernels whose SASS must hold wgmma and TMA loads, at every head dim.
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_dkv_bf16", "flash_dq_bf16")


def kernel_of(mangled: str):
    """(kernel, head dim) of a mangled instantiation such as
    ``..._14flash_fwd_bf16ILi128EEEv...``, or None for another symbol."""
    m = re.search(r"\d(flash_(?:fwd|dkv|dq)_(?:bf16|f32))ILi(\d+)E", mangled)
    return (m.group(1), int(m.group(2))) if m else None


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
    for (name, D), u in sorted(usage.items()):
        print(f"  {name}<{D}>: {u['REG']} registers, stack {u['STACK']} B, "
              f"static shared {u['SHARED']} B, local {u['LOCAL']} B")
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
            c = counts.get((name, D), {"HGMMA": 0, "UTMALDG": 0})
            print(f"  {name}<{D}>: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                  f"UTMALDG")
            if not (c["HGMMA"] and c["UTMALDG"]):
                missing.append(f"{name}<{D}>")
    if missing:
        fail("no wgmma (HGMMA) or TMA (UTMALDG) instructions in "
             + ", ".join(missing))
    return usage


def check_kernels(fa, bench, label, seed, B, S, H, Hkv, D, dtype, window,
                  device):
    """Each kernel against its plain version on the same inputs from
    ``seed``, under ``fa.KERNEL_TOLERANCE`` (``bench.check_kernels``).
    Prints the readings of every output and fails after the last if any
    broke a limit. Returns the largest absolute error of each kernel, and
    the inputs and plain outputs."""
    found, inputs, plain = bench.check_kernels(
        fa, fa, seed, B, S, H, Hkv, D, dtype, window, device)
    errors, broken = {}, []
    for (kernel, what), r in found.items():
        print(f"  {label} seed {seed} {kernel} {what}: " + bench.describe(r))
        if not r["ok"]:
            broken.append(f"{label} seed {seed} {kernel} {what}")
        errors[kernel] = max(errors.get(kernel, 0.0), r["max_abs_err"])
    if broken:
        fail("disagree with their plain versions: " + ", ".join(broken))
    return errors, inputs, plain


def planted_faults(fa, q, k, v, g, lse, delta, num_q_heads):
    """What a kernel with one bug would return on these inputs (causal,
    no window, as many KV heads as q heads), from the plain versions' math:
    the forward skipping the k tile at mid-sequence, dQ skipping the k tile
    there and dK/dV the q tile there, each of the width that kernel walks,
    and the forward weighting the later half of its rows 2% high. Returns
    {(output, fault): tensor}."""
    BH, S, D = q.shape
    dtype = q.dtype
    s = fa._masked_scores(q, k, num_q_heads, None)
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
    out_heavy = fa.flash_fwd_plain(q, k, v, num_q_heads, None)[0].clone()
    out_heavy[:, S // 2:] = (out_heavy[:, S // 2:].float() * 1.02).to(dtype)
    return {("out", "k tile skipped"): out_skip, ("dq", "k tile skipped"): dq,
            ("dk", "q tile skipped"): dk, ("dv", "q tile skipped"): dv,
            ("out", "later rows 2% heavy"): out_heavy}


def check_planted_faults(fa, bench, inputs, plain, H):
    """The tolerance, flip terms included, must reject every planted
    fault."""
    tol = fa.KERNEL_TOLERANCE[inputs[0].dtype]
    terms = fa.largest_terms(*inputs, H, None)
    for (what, fault), bad in planted_faults(fa, *inputs, H).items():
        r = fa.compare(bad, plain[what], tol, terms[what])
        print(f"  planted fault, {what} with {fault}: "
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


def train_args(steps: int):
    return ["--model", "Transformer", "--batch_size", "8", "-n", str(steps),
            "--vocab_size", "8192", "--d_model", "1024", "--num_heads", "8",
            "--num_layers", "8", "--seq_len", "2048", "--attention", "flash",
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
        if count != 8 * steps:
            fail(f"{name} launched {count} times in {steps} steps of an "
                 f"8-layer model, expected {8 * steps}")
    return result, launches


def main() -> None:
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
    built = _build.build("flash_attention")
    print(f"built kernels in {time.time() - t0:.1f} s ({built.name})",
          flush=True)
    usage = inspect_library(_build, built)

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
          f"resume {resume_launches}")

    backward_ms = ms["flash_dkv"][0] + ms["flash_dq"][0]
    kernels = []
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        bound_ms, bound_by = bound(name, B * H, B * H, S, D, torch.bfloat16,
                                   None)
        res = usage.get((name + "_bf16", D), {})
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errors[name], "ms": ms[name][0],
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
          f"backward {sdpa_bwd:.4f} ms ({backward_ms / sdpa_bwd:.2f}x)")
    print(json.dumps({"kernels": kernels, "card": card,
                      "train_steps_per_s": 1 / steady_s,
                      "train_tokens_per_s": B * S / steady_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
