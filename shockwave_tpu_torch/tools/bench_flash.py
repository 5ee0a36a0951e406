"""Check and time the three flash kernels at the training shape on one card.

    python -m shockwave_tpu_torch.tools.bench_flash
    python shockwave_tpu_torch/tools/bench_flash.py --root OTHER_CHECKOUT

``chip_smoke.py`` and the card tests use the helpers here: the inputs
(``make_inputs``), each kernel held against its plain version under
``flash_attention.KERNEL_TOLERANCE`` (``check_kernels``) and the CUDA-event
timing (``time_ms``, ``time_kernels``).

As a tool it builds the kernels, holds them against their plain versions
at the training shape (B=8, S=2048, H=8, D=128, bf16, causal) on inputs
from each seed of ``SEEDS``, printing each output's readings, then times
each kernel, its plain version and PyTorch's scaled_dot_product_attention
as ``chip_smoke.py`` does. The last line is one JSON object with the ms of
each, of the backward pair (dK/dV + dQ, beside SDPA's backward), the atol
each output needed on each seed with and without the one-flip term of the
tolerance, the card's name and power limit, and the checkout the kernels
came from.

``--root`` takes the kernels, their wrappers and plain versions from
another checkout (for example an older commit unpacked with
``git archive``), so that two versions can be checked and timed in turns
in one run on one card: old, new, new, old. They are held to this
checkout's tolerance. Needs a card; runs nothing on the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ITERS = 20  # timed launches of each kernel (3 of each plain version)
SEEDS = (0, 1, 2, 3)
TRAIN_SHAPE = (8, 2048, 8, 128)  # B, S, H (= Hkv), D


def time_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
    """ms per call of ``fn``, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(seed, B, S, H, Hkv, D, dtype, device):
    """q, k, v, g from ``seed``, drawn in the order q, g, k, v."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q, g = randn(B * H, S, D), randn(B * H, S, D)
    k, v = randn(B * Hkv, S, D), randn(B * Hkv, S, D)
    return q, k, v, g


def check_kernels(fa, rule, seed, B, S, H, Hkv, D, dtype, window, device):
    """Each kernel of ``fa`` against ``fa``'s plain version on the same
    inputs from ``seed``, under ``rule``'s KERNEL_TOLERANCE with its flip
    terms (``rule`` is the flash_attention module whose tolerance holds;
    ``fa`` may come from another checkout). Returns
    ({(kernel, output): readings with the limits under "tol"},
    (qs, k, v, g, lse, delta), {output: plain tensor})."""
    import torch

    q, k, v, g = make_inputs(seed, B, S, H, Hkv, D, dtype, device)
    qs = fa.scale_q(q)
    out, lse = fa.flash_fwd(qs, k, v, H, window)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(qs, k, v, H, window)
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, window)
    dk, dv = fa.flash_dkv(*args)
    torch.cuda.synchronize()
    dk_p, dv_p = fa.flash_dkv_plain(*args)
    dq = fa.flash_dq(*args)
    torch.cuda.synchronize()
    dq_p = fa.flash_dq_plain(*args)
    terms = rule.largest_terms(*args)
    plain = {"out": out_p, "lse": lse_p, "dk": dk_p, "dv": dv_p, "dq": dq_p}
    found = {}
    for kernel, pairs in (
        ("flash_fwd", [("out", out), ("lse", lse)]),
        ("flash_dkv", [("dk", dk), ("dv", dv)]),
        ("flash_dq", [("dq", dq)]),
    ):
        for what, got in pairs:
            tol = rule.KERNEL_TOLERANCE["lse" if what == "lse" else dtype]
            r = rule.compare(got, plain[what], tol, terms.get(what))
            found[kernel, what] = dict(r, tol=tol)
    torch.cuda.synchronize()
    return found, args[:6], plain


def describe(r: dict) -> str:
    """One line of a check_kernels reading."""
    tol = r["tol"]
    return (f"max|err| {r['max_abs_err']:.3e}, atol needed "
            f"{r['atol_needed']:.3e} (limit {tol['atol']:.3e} at rtol "
            f"{tol['rtol']:.3e}, flip {tol['flip']:.3e}), rel_fro "
            f"{r['rel_fro']:.3e} (limit {r['rel_fro_limit']:.3e}), "
            f"{r['over']} elements over ({r['over_without_flip']} "
            f"without the flip term)")


def time_kernels(fa, B, S, H, D, dtype, device):
    """ms of each kernel and its plain version at [B*H, S, D] (causal, as
    many KV heads as q heads, inputs from seed 1), and of PyTorch's
    scaled_dot_product_attention forward and backward on the same inputs:
    ({kernel: (ms, plain ms)}, sdpa forward ms, sdpa backward ms)."""
    import torch
    import torch.nn.functional as F

    q, k, v, g = make_inputs(1, B, S, H, H, D, dtype, device)
    qs = fa.scale_q(q)
    out, lse = fa.flash_fwd(qs, k, v, H)
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, None)
    fwd = (qs, k, v, H, None)
    ms = {
        "flash_fwd": (time_ms(lambda: fa.flash_fwd(*fwd)),
                      time_ms(lambda: fa.flash_fwd_plain(*fwd), 3)),
        "flash_dkv": (time_ms(lambda: fa.flash_dkv(*args)),
                      time_ms(lambda: fa.flash_dkv_plain(*args), 3)),
        "flash_dq": (time_ms(lambda: fa.flash_dq(*args)),
                     time_ms(lambda: fa.flash_dq_plain(*args), 3)),
    }
    q4, k4, v4, g4 = (x.view(B, H, S, D) for x in (q, k, v, g))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        o4, leaves, g4, retain_graph=True), 10)
    return ms, sdpa_fwd, sdpa_bwd


def _rule_of_this_checkout():
    """This checkout's flash_attention module, loaded from its file, for
    when the package on the path is another checkout's."""
    path = Path(__file__).resolve().parents[1] / "ops" / "flash_attention.py"
    spec = importlib.util.spec_from_file_location("_flash_rule", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to take shockwave_tpu_torch from")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from shockwave_tpu_torch.ops import _build
    from shockwave_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs an NVIDIA card")
    package = Path(fa.__file__).resolve().parents[2]
    if args.root and package != Path(args.root).resolve():
        raise SystemExit(f"the package came from {package}, not --root: "
                         "run this file as a script, not with -m")
    here = Path(__file__).resolve().parents[2]
    rule = fa if package == here else _rule_of_this_checkout()
    _build.build("flash_attention")
    device = torch.device("cuda")
    B, S, H, D = TRAIN_SHAPE
    needed = {}
    for seed in SEEDS:
        found, _, _ = check_kernels(fa, rule, seed, B, S, H, H, D,
                                    torch.bfloat16, None, device)
        for (kernel, what), r in found.items():
            print(f"seed {seed} {kernel} {what}: {describe(r)}", flush=True)
            needed.setdefault(what, {})[seed] = {
                "atol_needed": r["atol_needed"], "over": r["over"],
                "over_without_flip": r["over_without_flip"],
                "rel_fro": r["rel_fro"]}
        del found
    ms, sdpa_fwd, sdpa_bwd = time_kernels(fa, B, S, H, D, torch.bfloat16,
                                          device)
    result = {
        "ms": {name: t for name, (t, _) in ms.items()},
        "plain_ms": {name: t for name, (_, t) in ms.items()},
        "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
        "backward_ms": ms["flash_dkv"][0] + ms["flash_dq"][0],
        "readings": needed,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0],
        "package": str(package),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
