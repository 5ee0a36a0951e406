"""Physical-cluster entry point of the PyTorch port: run a trace against
real worker agents.

    python -m shockwave_tpu_torch.run_physical -t jobs.trace \\
        -p shockwave_tpu_pdhg --config shockwave.json --port 50060 \\
        --expected_workers 2 --time_per_iteration 120 --device cuda \\
        --payload_args "--vocab_size 8192 --d_model 1024 --num_heads 8 \\
            --num_layers 8 --seq_len 2048 --dtype bfloat16 --attention flash"
    python -m shockwave_tpu_torch.runtime.worker -t v100 -n 2 \\
        -a 127.0.0.1 -s 50060 -p 50061

The counterpart of the JAX package's ``scripts/run_physical.py``: starts
the scheduler's server (``core/physical.py``), waits for
``--expected_workers`` slots to register, replays the trace's arrival
times in (``--time_scale``-scaled) wall clock through the streaming
admission front door (``SubmitterClient``, the SubmitJobs RPC), closes
the stream after the last arrival, and drives rounds until every
admitted job completed; then prints the makespan and the average JCT.

The trace's commands are the reference's workloads; each job runs the
port's training program instead (``--payload train``:
``python -m shockwave_tpu_torch.models.train --model <family>
--batch_size <trace batch size> <--payload_args>``, its steps the trace's
own), or the synthetic payload
(``--payload synthetic``, ``runtime/synthetic.py``, no model). Every
family of the reference's traces has a model (``models.train.FAMILIES``);
a job of another family raises ValueError.

``--device`` is where the Shockwave planner's device solves run (default
``cuda``; the payloads' device is the worker agent's own ``--device``).
The telemetry flags are the simulate CLI's (``obs.add_telemetry_args``);
``--metrics-port`` also serves the fleet's scrape endpoint.

``--driver card`` and ``--driver localhost`` are the drivers' modes
(``tools/physical_drivers.py``): one command brings up the scheduler and a
worker agent, runs the whole trace (the golden one by default) and writes
its summary; ``card`` runs the payloads on the card with steps sized from
the measured oracle (``--oracle results/measured_oracle_h100.json``) and
the gangs' ranks on the host's CPU, ``localhost`` runs every payload on
the host's CPU. ``--driver card --help`` lists a mode's flags.
"""

from __future__ import annotations

import argparse
import json
import shlex
import sys
import threading
import traceback

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.core.physical import PhysicalScheduler
from shockwave_tpu_torch.data import (
    load_or_synthesize_profiles,
    parse_trace,
    read_throughputs,
)
from shockwave_tpu_torch.data.default_oracle import generate_oracle
from shockwave_tpu_torch.data.workload_info import parse_job_type
from shockwave_tpu_torch.models.train import FAMILIES
from shockwave_tpu_torch.policies import get_available_policies, get_policy


def localize_jobs(jobs, payload: str, payload_args: str = "") -> None:
    """Point each trace job at the port's payload, in place: the
    training program for its family (raises for a family it has no
    model for) or the synthetic payload."""
    from shockwave_tpu_torch.runtime.testing import SYNTHETIC_WORKLOAD

    for job in jobs:
        family, batch_size = parse_job_type(job.job_type)
        if payload == "train":
            if family not in FAMILIES:
                raise ValueError(f"the training program has no model for "
                                 f"the {family} family")
            command = (
                f"{shlex.quote(sys.executable)} -m "
                f"shockwave_tpu_torch.models.train --model {family} "
                f"--batch_size {batch_size}"
            )
        elif payload == "synthetic":
            command = (
                f"{shlex.quote(sys.executable)} "
                f"{shlex.quote(SYNTHETIC_WORKLOAD)} "
                f"--batch_size {batch_size}"
            )
        else:
            raise ValueError(f"unknown payload {payload!r}")
        job.command = f"{command} {payload_args}".rstrip()
        job.working_directory = ""
        job.needs_data_dir = False
        job.num_steps_arg = "-n"


def main(args) -> dict:
    obs.apply_telemetry_args(args)
    jobs, arrival_times = parse_trace(args.trace_file)
    throughputs = (
        read_throughputs(args.throughputs_file)
        if args.throughputs_file
        else generate_oracle()
    )
    profiles = load_or_synthesize_profiles(args.trace_file, jobs, throughputs)
    for i, job in enumerate(jobs):
        job.duration = sum(profiles[i]["duration_every_epoch"])
    localize_jobs(jobs, args.payload, args.payload_args)

    shockwave_config = None
    if args.policy.startswith("shockwave"):
        with open(args.config) as f:
            shockwave_config = json.load(f)
        shockwave_config["time_per_iteration"] = args.time_per_iteration
        shockwave_config.setdefault("num_gpus", args.expected_workers)

    sched = PhysicalScheduler(
        get_policy(args.policy, device=args.device, seed=args.seed),
        port=args.port,
        throughputs=throughputs,
        seed=args.seed or 0,
        time_per_iteration=args.time_per_iteration,
        profiles=profiles,
        shockwave_config=shockwave_config,
        metrics_port=args.metrics_port,
        completion_buffer_seconds=args.completion_buffer_seconds,
    )
    print(f"Scheduler listening on :{args.port}; waiting for "
          f"{args.expected_workers} workers...", flush=True)
    sched.wait_for_workers(args.expected_workers, timeout=args.worker_timeout)

    # Arrivals are replayed on their own thread through the front door;
    # the close (sent even when the submitter fails) ends the run.
    errors = []

    def submit():
        from shockwave_tpu_torch.runtime.rpc.submitter_client import (
            SubmitterClient,
        )

        client = SubmitterClient("127.0.0.1", args.port, client_id="driver")
        try:
            client.submit_trace(
                jobs, arrival_times, time_scale=args.time_scale
            )
        except Exception:
            errors.append(traceback.format_exc())
            print("ERROR: submitter thread failed:\n" + errors[-1],
                  file=sys.stderr)
        finally:
            client.close()

    sched.expect_stream()
    submitter = threading.Thread(target=submit, daemon=True)
    submitter.start()
    sched.run(max_rounds=args.max_rounds)
    submitter.join(timeout=1)

    avg_jct = sched.get_average_jct()
    makespan = sched.get_current_timestamp()
    print(f"Makespan: {makespan:.1f}s")
    if avg_jct:
        print(f"Average JCT: {avg_jct:.1f}s")
    print(f"Completed jobs: {len(sched._completed_jobs)} of {len(jobs)}; "
          f"rounds: {sched._num_completed_rounds}", flush=True)
    obs.export_run_summary(
        metrics_out=args.metrics_out,
        trace_out=args.trace_out,
        makespan=makespan,
        avg_jct=avg_jct,
    )
    if errors:
        raise SystemExit("the submitter failed (see above)")
    return {"makespan": makespan, "avg_jct": avg_jct,
            "completed": len(sched._completed_jobs),
            "rounds": sched._num_completed_rounds}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("-t", "--trace_file", type=str, required=True)
    parser.add_argument(
        "-p", "--policy", type=str, default="fifo",
        choices=get_available_policies(),
    )
    parser.add_argument("--throughputs_file", type=str, default=None)
    parser.add_argument("--port", type=int, default=50060)
    parser.add_argument("--expected_workers", type=int, default=1)
    parser.add_argument("--worker_timeout", type=float, default=300.0)
    parser.add_argument("--time_per_iteration", type=float, default=360.0)
    parser.add_argument(
        "--time_scale", type=float, default=1.0,
        help="Multiplier on trace arrival times (e.g. 0.01 to compress)",
    )
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the planner's device solves run")
    parser.add_argument("--payload", type=str, default="train",
                        choices=["train", "synthetic"])
    parser.add_argument("--payload_args", type=str, default="",
                        help="extra flags for every payload command")
    parser.add_argument("--max_rounds", type=int, default=None)
    parser.add_argument("--completion_buffer_seconds", type=float,
                        default=60.0)
    obs.add_telemetry_args(parser)
    return parser.parse_args(argv)


def cli(argv=None):
    """The command line: a driver's mode under ``--driver``, else the
    scheduler alone."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--driver", choices=["card", "localhost"])
    known, rest = pre.parse_known_args(argv)
    if known.driver:
        from shockwave_tpu_torch.tools import physical_drivers

        return physical_drivers.main(known.driver, rest)
    return main(parse_args(rest))


if __name__ == "__main__":
    cli()
