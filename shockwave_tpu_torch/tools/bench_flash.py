"""Check and time the three flash kernels on one card, in both modes.

    python -m shockwave_tpu_torch.tools.bench_flash
    python shockwave_tpu_torch/tools/bench_flash.py --root OTHER_CHECKOUT

``chip_smoke.py`` and the card tests use the helpers here: the inputs
(``make_inputs``), each kernel held against its plain version under
``flash_attention.KERNEL_TOLERANCE`` (``check_kernels``) and the CUDA-event
timing (``time_ms``, ``time_kernels``; ``retime_noncausal`` reads the
non-causal kernels' back-to-back time beside the host's issue time and
the card's time with the launches queued).

As a tool it builds the kernels, holds them against their plain versions
at the training shape (B=8, S=2048, H=8, D=128, bf16, causal) and at the
110M tier's ring-hop shape (B=8, Sq=Sk=512, H=8, D=128, bf16, non-causal)
on inputs from each seed of ``SEEDS``, printing each output's readings,
then times each kernel, its plain version and PyTorch's
scaled_dot_product_attention (``is_causal`` as the mode) at both shapes, as
``chip_smoke.py`` does. The last line is one JSON object with the ms of
each, of the backward pair (dK/dV + dQ, beside SDPA's backward), the atol
each output needed on each seed with and without the one-flip term of the
tolerance, the card's name and power limit, and the checkout the kernels
came from.

``--root`` takes the kernels, their wrappers and plain versions from
another checkout (for example an older commit unpacked with
``git archive``), so that two versions can be checked and timed in turns
in one run on one card: old, new, new, old. They are held to this
checkout's tolerance. Needs a card; runs nothing on the CPU.

``--sass OTHER_CHECKOUT`` instead compiles this checkout's
``flash_attention.cu`` and the other's to cubins (``nvcc -cubin``, the
library's arch and optimisation flags) and prints, for each causal
instantiation, both builds' registers and shared memory (``cuobjdump
-res-usage``), SASS instruction counts, whether the instruction streams
are identical, and the mnemonics whose counts differ. A checkout from
before the non-causal mode has one instantiation per head dim, all
causal. Needs ``nvcc``, not a card.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ITERS = 20  # timed launches of each kernel (3 of each plain version)
SEEDS = (0, 1, 2, 3)
TRAIN_SHAPE = (8, 2048, 8, 128)  # B, S, H (= Hkv), D
# A ring hop of the 110M tier on a 4-shard seq mesh: B, Sq = Sk, H, D.
HOP_SHAPE = (8, 512, 8, 128)


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


def make_inputs(seed, B, S, H, Hkv, D, dtype, device, Sk=None):
    """q, k, v, g from ``seed``, drawn in the order q, g, k, v; k and v
    have ``Sk`` rows (default S)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    Sk = S if Sk is None else Sk
    q, g = randn(B * H, S, D), randn(B * H, S, D)
    k, v = randn(B * Hkv, Sk, D), randn(B * Hkv, Sk, D)
    return q, k, v, g


def check_kernels(fa, rule, seed, B, S, H, Hkv, D, dtype, window, device,
                  causal=True, Sk=None):
    """Each kernel of ``fa`` against ``fa``'s plain version on the same
    inputs from ``seed`` (q rows ``S``, k/v rows ``Sk``, in the mode
    ``causal``), under ``rule``'s KERNEL_TOLERANCE with its flip terms
    (``rule`` is the flash_attention module whose tolerance holds; ``fa``
    may come from another checkout). Returns
    ({(kernel, output): readings with the limits under "tol"},
    (qs, k, v, g, lse, delta), {output: plain tensor})."""
    import torch

    q, k, v, g = make_inputs(seed, B, S, H, Hkv, D, dtype, device, Sk)
    qs = fa.scale_q(q)
    mode = {} if causal else {"causal": False}
    out, lse = fa.flash_fwd(qs, k, v, H, window, **mode)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(qs, k, v, H, window, **mode)
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, window)
    dk, dv = fa.flash_dkv(*args, **mode)
    torch.cuda.synchronize()
    dk_p, dv_p = fa.flash_dkv_plain(*args, **mode)
    dq = fa.flash_dq(*args, **mode)
    torch.cuda.synchronize()
    dq_p = fa.flash_dq_plain(*args, **mode)
    terms = rule.largest_terms(*args, **mode)
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


def time_kernels(fa, B, S, H, D, dtype, device, causal=True):
    """ms of each kernel and its plain version at [B*H, S, D] (in the mode
    ``causal``, Sk = S, as many KV heads as q heads, inputs from seed 1),
    and of PyTorch's scaled_dot_product_attention forward and backward on
    the same inputs with ``is_causal=causal``:
    ({kernel: (ms, plain ms)}, sdpa forward ms, sdpa backward ms)."""
    import torch
    import torch.nn.functional as F

    q, k, v, g = make_inputs(1, B, S, H, H, D, dtype, device)
    qs = fa.scale_q(q)
    mode = {} if causal else {"causal": False}
    out, lse = fa.flash_fwd(qs, k, v, H, None, **mode)
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, None)
    fwd = (qs, k, v, H, None)
    ms = {
        "flash_fwd": (time_ms(lambda: fa.flash_fwd(*fwd, **mode)),
                      time_ms(lambda: fa.flash_fwd_plain(*fwd, **mode), 3)),
        "flash_dkv": (time_ms(lambda: fa.flash_dkv(*args, **mode)),
                      time_ms(lambda: fa.flash_dkv_plain(*args, **mode), 3)),
        "flash_dq": (time_ms(lambda: fa.flash_dq(*args, **mode)),
                     time_ms(lambda: fa.flash_dq_plain(*args, **mode), 3)),
    }
    q4, k4, v4, g4 = (x.view(B, H, S, D) for x in (q, k, v, g))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal))
    leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        o4, leaves, g4, retain_graph=True), 10)
    return ms, sdpa_fwd, sdpa_bwd


def time_host_and_queued(fn, iters: int = ITERS) -> dict:
    """Three readings of ``fn``'s launches: ``events_ms``, the ms a call of
    ``time_ms`` (CUDA events around ``iters`` calls back to back);
    ``host_ms``, the host's time to issue one call (host clock around
    ``iters`` calls, no synchronise inside); and ``queued_ms``, the card's
    time a call with every launch already queued behind a sleep kernel
    (``torch.cuda._sleep``), which no host delay between launches can
    stretch. Where ``host_ms`` is above ``queued_ms``, back-to-back events
    time the host's issue rate and not the kernel."""
    import time as clock

    import torch

    events_ms = time_ms(fn, iters)
    torch.cuda.synchronize()
    start_s = clock.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (clock.perf_counter() - start_s) / iters
    torch.cuda.synchronize()
    # Sleep long enough (at 2 GHz, twice over) to cover issuing them all.
    torch.cuda._sleep(int(2e9 * 2 * (iters * host_ms / 1e3 + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return dict(events_ms=events_ms, host_ms=host_ms,
                queued_ms=start.elapsed_time(end) / iters)


def retime_noncausal(fa, device) -> dict:
    """The three non-causal kernels and SDPA's ``is_causal=False`` forward
    at the ring-hop shape (``HOP_SHAPE``, bf16, inputs from seed 1), each
    read by :func:`time_host_and_queued`."""
    import torch
    import torch.nn.functional as F

    B, S, H, D = HOP_SHAPE
    q, k, v, g = make_inputs(1, B, S, H, H, D, torch.bfloat16, device)
    qs = fa.scale_q(q)
    out, lse = fa.flash_fwd(qs, k, v, H, None, causal=False)
    delta = (g.float() * out.float()).sum(-1)
    args = (qs, k, v, g, lse, delta, H, None)
    q4, k4, v4 = (x.view(B, H, S, D) for x in (q, k, v))
    return {
        "flash_fwd": time_host_and_queued(
            lambda: fa.flash_fwd(qs, k, v, H, None, causal=False)),
        "flash_dkv": time_host_and_queued(
            lambda: fa.flash_dkv(*args, causal=False)),
        "flash_dq": time_host_and_queued(
            lambda: fa.flash_dq(*args, causal=False)),
        "sdpa_fwd": time_host_and_queued(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=False)),
    }


def _rule_of_this_checkout():
    """This checkout's flash_attention module, loaded from its file, for
    when the package on the path is another checkout's."""
    path = Path(__file__).resolve().parents[1] / "ops" / "flash_attention.py"
    spec = importlib.util.spec_from_file_location("_flash_rule", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _causal_kernel(mangled: str):
    """(kernel, head dim) of a mangled causal instantiation, from a build
    with the mode flag (``...ILi128ELb1EE...``) or without it
    (``...ILi128EE...``); None for any other symbol."""
    m = re.search(r"\d(flash_(?:fwd|dkv|dq)_(?:bf16|f32))ILi(\d+)E(Lb([01])E)?",
                  mangled)
    if not m or m.group(4) == "0":
        return None
    return m.group(1), int(m.group(2))


def _cubin_report(source: Path, cubin: Path) -> dict:
    """{(kernel, D): {"usage": {...}, "sass": [mnemonic, ...]}} of the
    causal instantiations of one source."""
    from shockwave_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    subprocess.run([nvcc, *_build.NVCC_FLAGS[:4], "-cubin", "-o", str(cubin),
                    str(source)], check=True, capture_output=True, timeout=600)
    cuobjdump = Path(nvcc).with_name("cuobjdump")

    def dump(flag):
        return subprocess.run([str(cuobjdump), flag, str(cubin)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout

    found, current = {}, None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function"):
            current = _causal_kernel(line)
        elif current and "REG:" in line:
            found[current] = {"usage": {k: int(v) for k, v in re.findall(
                r"(\w+):(\d+)", line)}, "sass": []}
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            current = _causal_kernel(line)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\S*)",
                     line)
        if m and current in found:
            found[current]["sass"].append(m.group(1).rstrip(";"))
    return found


def compare_sass(other: Path) -> dict:
    """The causal instantiations of this checkout's flash_attention.cu
    against ``other``'s (module docstring, ``--sass``)."""
    from shockwave_tpu_torch.ops import _build

    here = Path(__file__).resolve().parents[1] / "ops" / "csrc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    for side, csrc in (("other", Path(other).resolve()
                        / "shockwave_tpu_torch" / "ops" / "csrc"),
                       ("this", here)):
        builds[side] = _cubin_report(csrc / "flash_attention.cu",
                                     _build.BUILD_DIR / f"sass_{side}.cubin")
    report = {}
    for key in sorted(set(builds["this"]) | set(builds["other"])):
        this, that = builds["this"].get(key), builds["other"].get(key)
        row = {side: None if b is None else dict(
            b["usage"], instructions=len(b["sass"]))
            for side, b in (("this", this), ("other", that))}
        if this and that:
            diff = collections.Counter(this["sass"])
            diff.subtract(collections.Counter(that["sass"]))
            row["identical"] = this["sass"] == that["sass"]
            row["mnemonic_counts_this_less_other"] = {
                k: v for k, v in sorted(diff.items()) if v}
        report[f"{key[0]}<{key[1]}, causal>"] = row
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to take shockwave_tpu_torch from")
    ap.add_argument("--sass", default=None, metavar="OTHER_CHECKOUT",
                    help="compare the causal kernels' SASS with another "
                    "checkout's and exit")
    args = ap.parse_args(argv)
    if args.sass:
        report = compare_sass(Path(args.sass))
        for name, row in report.items():
            print(f"{name}: {json.dumps(row)}", flush=True)
        return report
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
    needed, timed = {}, {}
    # Both modes: the causal training shape, then the non-causal hop.
    modes = [("train", TRAIN_SHAPE, True)]
    if hasattr(fa, "flash_attention_lse"):  # a checkout with the mode
        modes.append(("hop", HOP_SHAPE, False))
    for label, (B, S, H, D), causal in modes:
        for seed in SEEDS:
            found, _, _ = check_kernels(fa, rule, seed, B, S, H, H, D,
                                        torch.bfloat16, None, device,
                                        causal=causal)
            for (kernel, what), r in found.items():
                print(f"{label} seed {seed} {kernel} {what}: {describe(r)}",
                      flush=True)
                needed.setdefault(label, {}).setdefault(what, {})[seed] = {
                    "atol_needed": r["atol_needed"], "over": r["over"],
                    "over_without_flip": r["over_without_flip"],
                    "rel_fro": r["rel_fro"]}
            del found
        ms, sdpa_fwd, sdpa_bwd = time_kernels(fa, B, S, H, D, torch.bfloat16,
                                              device, causal=causal)
        timed[label] = {
            "ms": {name: t for name, (t, _) in ms.items()},
            "plain_ms": {name: t for name, (_, t) in ms.items()},
            "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
            "backward_ms": ms["flash_dkv"][0] + ms["flash_dq"][0]}
    result = {
        **timed,
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
