"""Throughput-profiling harness: measure a real oracle on the card.

    python -m shockwave_tpu_torch.tools.measure_throughput \\
        --families ResNet-18 LM --warmup 5 --steps 30 -o measured_oracle.json
    python -m shockwave_tpu_torch.tools.measure_throughput --families \\
        A3C CycleGAN LM Recommendation ResNet-18 ResNet-50 Transformer \\
        -o results/measured_oracle_h100.json      # every family, every size

The port's counterpart of the JAX package's
``scripts/profiling/measure_throughput.py``: builds each (model family,
batch size) through the training program's ``build_family``
(``models/train.py``) at the CLI's default widths plus any
``--payload_args``, so the rate is that of the payload the physical
drivers launch, measures its isolated steps/s on ``--device`` (default
``cuda``), optionally measures co-located pairs, and writes an oracle in
the throughputs-file format (``data/throughputs.py::read_throughputs``,
``--throughputs_file`` everywhere) under ``--worker_type`` (default
``h100``).

Rates are slope-based: each measurement times an n-step and a 2n-step run
and divides n by the difference, with n growing 4x until the difference
spans ``_MIN_SLOPE_SECONDS``, so the constant cost of a run's sync (the
loss's ``.item()``, then ``torch.cuda.synchronize()``) cancels out; at the
``_MAX_SLOPE_STEPS`` cap it falls back, with a warning, to the plain rate
of the longer run.

Co-location on one card is measured as strict time-slicing (the two jobs'
steps alternate; each side's rate is steps / elapsed), clamped to each
side's isolated rate. Scale factors above 1 are extrapolated with the
synthetic oracle's per-doubling gang efficiency (``_GANG_EFFICIENCY``)
unless ``--measured_scale_factors_only`` is passed.
"""

from __future__ import annotations

import argparse
import gc
import shlex
import subprocess
import time

import numpy as np
import torch

from shockwave_tpu_torch.data.default_oracle import (
    _FAMILY_BATCH_SIZES,
    _GANG_EFFICIENCY,
)
from shockwave_tpu_torch.data.throughputs import stringify_throughputs
from shockwave_tpu_torch.utils.fileio import atomic_write_json

SCALE_FACTORS = [1, 2, 4, 8]
_MIN_SLOPE_SECONDS = 0.5
_MAX_SLOPE_STEPS = 8192


def job_type(family: str, batch_size: int) -> str:
    return f"{family} (batch size {batch_size})"


def build_step(family: str, batch_size: int, device: str = "cuda",
               payload_args: str = ""):
    """One training step of the payload ``models.train --model family
    --batch_size batch_size <payload_args>`` on ``device``, on one fixed
    batch: a callable that takes a step and returns its loss (not
    synchronised)."""
    from shockwave_tpu_torch.models import train
    from shockwave_tpu_torch.parallel.mesh import factorize_gang, make_mesh
    from shockwave_tpu_torch.utils.device import resolve_device

    args = train.parse_args(
        ["--model", family, "--batch_size", str(batch_size), "-n", "1",
         "--device", device] + shlex.split(payload_args))
    dev = resolve_device(args.device)
    mesh = make_mesh(factorize_gang(1, args.seq_parallel,
                                    args.model_parallel), [dev])
    _, step_fn, _, batch_fn = train.build_family(family, args, dev, mesh)
    batch = batch_fn(np.random.default_rng(args.seed))

    def one_step():
        return step_fn(batch)

    return one_step


def _sync(loss) -> float:
    """The loss's value, then the card's queue drained."""
    value = loss.item()
    if torch.cuda.is_available() and loss.is_cuda:
        torch.cuda.synchronize()
    return value


def _measure_slope(run, steps: int) -> float:
    """Rate via the slope between an n-step and a 2n-step timed run: the
    constant per-run sync cost cancels out. n grows 4x until the slope
    spans ``_MIN_SLOPE_SECONDS``; at ``_MAX_SLOPE_STEPS`` the plain rate
    of the longer run is returned, with a warning."""
    n = steps
    while True:
        t0 = time.time()
        run(n)
        t1 = time.time()
        run(2 * n)
        t2 = time.time()
        diff = (t2 - t1) - (t1 - t0)
        if diff >= _MIN_SLOPE_SECONDS:
            return n / diff
        if n >= _MAX_SLOPE_STEPS:
            rate = (2 * n) / max(t2 - t1, 1e-9)
            print(f"    [warn] slope signal below jitter at n={n}; "
                  f"falling back to biased plain rate {rate:.1f} steps/s")
            return rate
        n *= 4


def measure_isolated(one_step, warmup: int, steps: int) -> float:
    def run(n):
        loss = None
        for _ in range(n):
            loss = one_step()
        if loss is not None:
            _sync(loss)

    run(warmup)
    return _measure_slope(run, steps)


def measure_pair(step_a, step_b, warmup: int, steps: int):
    """Strict time-slicing: alternate steps; each side's effective rate is
    steps / total elapsed. Slope-based like :func:`measure_isolated`."""

    def run(n):
        la = lb = None
        for _ in range(n):
            la = step_a()
            lb = step_b()
        if la is not None:
            _sync(la)
            _sync(lb)

    run(warmup)
    rate = _measure_slope(run, steps)
    return rate, rate


def _release() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def measure_oracle(rows, worker_type: str = "h100", warmup: int = 5,
                   steps: int = 30, device: str = "cuda", pairs=False,
                   measured_scale_factors_only=False,
                   payload_args: str = "") -> dict:
    """The oracle ``{worker_type: {(job_type, sf): {"null": rate, ...}}}``
    of ``rows``, each ``(family, batch_size)`` or ``(family, batch_size,
    payload_args)`` (else the shared ``payload_args``)."""
    rows = [tuple(r) + (payload_args,) * (3 - len(r)) for r in rows]
    per_type, isolated = {}, {}
    for family, bs, extra in rows:
        tput = measure_isolated(build_step(family, bs, device, extra),
                                warmup, steps)
        _release()
        isolated[(family, bs)] = tput
        label = job_type(family, bs)
        print(f"  {label}: {tput:.2f} steps/s", flush=True)
        per_type[(label, 1)] = {"null": tput}
        if not measured_scale_factors_only:
            for sf in SCALE_FACTORS[1:]:
                gang = sf * (_GANG_EFFICIENCY ** (sf - 1).bit_length())
                per_type[(label, sf)] = {"null": tput * gang}
    if pairs:
        for i, (fam_a, bs_a, extra_a) in enumerate(rows):
            for fam_b, bs_b, extra_b in rows[i:]:
                step_a = build_step(fam_a, bs_a, device, extra_a)
                step_b = build_step(fam_b, bs_b, device, extra_b)
                ta, tb = measure_pair(step_a, step_b, warmup, steps)
                del step_a, step_b
                _release()
                # The two steps' kernels can overlap on the card, so the
                # interleaved rate can pass the isolated one: clamp it, as
                # the estimator needs co-location fractions in [0, 1].
                ta = min(ta, isolated[(fam_a, bs_a)])
                tb = min(tb, isolated[(fam_b, bs_b)])
                key_a = (job_type(fam_a, bs_a), 1)
                key_b = (job_type(fam_b, bs_b), 1)
                per_type[key_a][key_b] = [ta, tb]
                if key_a != key_b:
                    per_type[key_b][key_a] = [tb, ta]
                print(f"  {key_a[0]} || {key_b[0]}: {ta:.2f} / {tb:.2f} "
                      "steps/s", flush=True)
    return {worker_type: per_type}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def table_rows(families, batch_sizes=None):
    """Each family's (family, batch size) rows of ``_FAMILY_BATCH_SIZES``,
    restricted to ``batch_sizes`` when given."""
    return [(family, bs) for family in families
            for bs in _FAMILY_BATCH_SIZES[family]
            if not batch_sizes or bs in batch_sizes]


def main(args) -> dict:
    from shockwave_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Profiling on {device.type}:{name}", flush=True)
    if device.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    oracle = measure_oracle(
        table_rows(args.families, args.batch_sizes), args.worker_type,
        args.warmup, args.steps, args.device, args.pairs,
        args.measured_scale_factors_only, args.payload_args)
    atomic_write_json(args.output, stringify_throughputs(oracle))
    print(f"Wrote {args.output}")
    return oracle


def build_parser():
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--families", type=str, nargs="+",
                        default=["ResNet-18", "LM", "Recommendation"],
                        choices=sorted(_FAMILY_BATCH_SIZES))
    parser.add_argument("--batch_sizes", type=int, nargs="*", default=None,
                        help="restrict to these batch sizes (default: the "
                        "family's table)")
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument(
        "--steps", type=int, default=30,
        help="the slope's STARTING step count; it grows 4x a try, up to "
        f"{_MAX_SLOPE_STEPS}, until the slope clears the sync's jitter")
    parser.add_argument("--pairs", action="store_true")
    parser.add_argument("--worker_type", type=str, default="h100")
    parser.add_argument("--measured_scale_factors_only", action="store_true")
    parser.add_argument("--payload_args", type=str, default="",
                        help="extra flags for every payload, as "
                        "run_physical --payload_args")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (default) raises when no card is present")
    parser.add_argument("-o", "--output", type=str,
                        default="measured_oracle.json")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
