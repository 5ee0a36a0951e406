#!/usr/bin/env python3
"""Synthetic training workload for runtime integration testing (the port
of the JAX package's ``scripts/workloads/synthetic.py``).

Behaves like a real trainer from the scheduler's point of view: wraps a
data loader in ShockwaveIterator, resumes its step counter from a
checkpoint, runs ``--num_steps`` more steps at ``--steps_per_sec``, writes
a checkpoint on preemption or completion. No accelerator needed: the
``--device`` every dispatcher appends is accepted and unused.

    python shockwave_tpu_torch/runtime/synthetic.py -n <steps> \
        --checkpoint_dir <dir> --enable_shockwave_iterator
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
)

from shockwave_tpu_torch.runtime.iterator import ShockwaveIterator
from shockwave_tpu_torch.utils.fileio import atomic_write_json, atomic_write_text


class SyntheticLoader:
    def __init__(self, batch_size):
        self.batch_size = batch_size

    def __iter__(self):
        while True:
            yield [0] * self.batch_size


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", "--num_steps", type=int, required=True)
    parser.add_argument("--checkpoint_dir", type=str, required=True)
    parser.add_argument("--enable_shockwave_iterator", action="store_true")
    parser.add_argument("--steps_per_sec", type=float, default=100.0)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default="cpu")
    # Gang rendezvous args appended by the scheduler for scale_factor > 1.
    parser.add_argument("--distributed_addr", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--worker_rank", type=int, default=0)
    # Failure injection (runtime fault-tolerance tests).
    parser.add_argument(
        "--crash_attempts",
        type=int,
        default=0,
        help="Die before making progress on the first N launches "
        "(-1 = every launch); tracked via a counter file in checkpoint_dir",
    )
    parser.add_argument(
        "--hang",
        action="store_true",
        help="Never step and never exit (exercises the straggler kill)",
    )
    parser.add_argument(
        "--spin",
        action="store_true",
        help="Busy-wait the step budget instead of sleeping: the workload "
        "becomes compute-bound, so space-shared co-location on a shared "
        "core shows up as a measurable per-process rate drop (the packed "
        "runtime test's co-location evidence)",
    )
    args = parser.parse_args()

    ckpt_path = os.path.join(args.checkpoint_dir, "state.json")

    if args.crash_attempts:
        attempt_path = os.path.join(args.checkpoint_dir, "attempts.txt")
        attempts = 0
        if os.path.exists(attempt_path):
            with open(attempt_path) as f:
                attempts = int(f.read().strip() or 0)
        attempts += 1
        atomic_write_text(attempt_path, str(attempts))
        if args.crash_attempts < 0 or attempts <= args.crash_attempts:
            # Hard exit: no checkpoint, no iterator progress line -> the
            # dispatcher reports zero progress and the scheduler counts a
            # micro-task failure.
            os._exit(13)

    if args.hang:
        while True:
            time.sleep(3600)

    def load_checkpoint():
        if os.path.exists(ckpt_path):
            with open(ckpt_path) as f:
                return json.load(f)
        return {"steps": 0}

    def save_checkpoint(state):
        atomic_write_json(ckpt_path, state, indent=0)

    state = load_checkpoint()
    loader = SyntheticLoader(args.batch_size)
    iterator = ShockwaveIterator(
        loader, args.checkpoint_dir, load_checkpoint, save_checkpoint
    )

    step_budget = 1.0 / args.steps_per_sec

    if args.spin and hasattr(os, "sched_setaffinity"):
        # Every spinner shares core 0, so co-located processes contend
        # even on multi-core hosts — the packed test's slowdown evidence
        # does not depend on the machine happening to have one CPU.
        try:
            os.sched_setaffinity(0, {0})
        except OSError:
            pass

    def pace():
        if args.spin:
            # Burn step_budget of CPU time (not wall time): under
            # co-location the process's CPU share drops, so the step
            # takes proportionally longer wall-clock — fixed work per
            # step, like a real compute-bound trainer.
            deadline = time.process_time() + step_budget
            while time.process_time() < deadline:
                pass
        else:
            time.sleep(step_budget)

    steps_this_task = 0
    for _ in iterator:
        pace()
        steps_this_task += 1
        state["steps"] += 1
        if steps_this_task >= args.num_steps:
            iterator.complete()
            break
    save_checkpoint(state)


if __name__ == "__main__":
    main()
