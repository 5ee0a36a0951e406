"""The HA node driver: leader, hot standby or cold restart.

The port of the JAX package's ``shockwave_tpu/ha/standby.py``. One entry
point runs every role. A node takes the leader lease (a standby blocks on
it: the incumbent's death or its release is the cue), replays the
control plane's journal (the checkpoint and its WAL tail; empty on a new
campaign), publishes the front-door map (the scheduler's address and the
admission shards' sockets under its new fenced epoch), waits for the
surviving workers to re-attach, and serves rounds until the campaign
completes, or until it is killed and the next node does the same.

    python -m shockwave_tpu_torch.ha.standby --ha_dir /tmp/ha \\
        --node leader-0 --port 50200 --round_s 3 --expect_workers 2 \\
        --policy shockwave_tpu_pdhg --config '{"future_rounds": 6, ...}' \\
        --summary_out /tmp/ha/leader-0.json
    python -m shockwave_tpu_torch.ha.standby --ha_dir /tmp/ha \\
        --node standby-1 --port 50201 --round_s 3 \\
        --policy shockwave_tpu_pdhg --config '{"future_rounds": 6, ...}' \\
        --summary_out /tmp/ha/standby-1.json

``--device`` (default ``cuda``, which raises on a host with no card) is
where the planner's device solves run: the planner a node builds, the one
it restores from the journal (``planner_from_state``) and its speculation
stream. Jobs arrive through the streaming admission front door
(SubmitJobs), never on the command line: a failover finds them in the
journal. Workers follow the leader with ``--ha_dir`` (the worker agent's
flag, or ``SHOCKWAVE_HA_DIR``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="shockwave_tpu_torch HA scheduler node (leader or "
        "standby)"
    )
    parser.add_argument("--ha_dir", required=True,
                        help="shared HA directory (lease + journal)")
    parser.add_argument("--node", required=True,
                        help="this node's holder id (unique per process)")
    parser.add_argument("--port", type=int, required=True,
                        help="scheduler RPC port for THIS node")
    parser.add_argument("--policy", default="fifo")
    parser.add_argument(
        "--config", default=None,
        help="Shockwave planner config, a JSON file or literal (its "
        "time_per_iteration is --round_s; num_gpus defaults to "
        "--expect_workers)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the planner's device solves run; cuda raises on a "
        "host with no card",
    )
    parser.add_argument("--round_s", type=float, default=3.0)
    parser.add_argument("--completion_buffer_s", type=float, default=6.0)
    parser.add_argument("--heartbeat_timeout_s", type=float, default=4.0)
    parser.add_argument("--lease_ttl_s", type=float, default=3.0)
    parser.add_argument("--expect_workers", type=int, default=0,
                        help="fresh-leader registration wait (0 = skip)")
    parser.add_argument("--reattach_timeout_s", type=float, default=20.0)
    parser.add_argument("--max_rounds", type=int, default=None)
    parser.add_argument("--checkpoint_rounds", type=int, default=1)
    parser.add_argument("--acquire_timeout_s", type=float, default=None,
                        help="give up standing by after this long")
    parser.add_argument("--summary_out", default=None)
    parser.add_argument("--decision_log", default=None)
    return parser


def shockwave_config(args) -> Optional[dict]:
    """The planner's configuration, a deployment fact every node of the
    campaign is given alike (it is not journal state)."""
    if not args.policy.startswith("shockwave"):
        return None
    if args.config is None:
        raise SystemExit(f"--policy {args.policy} needs --config")
    from shockwave_tpu_torch.utils.fileio import read_json_arg

    config = dict(read_json_arg(args.config, "--config"))
    config["time_per_iteration"] = args.round_s
    config.setdefault("num_gpus", max(1, args.expect_workers))
    return config


def run_node(args) -> int:
    from shockwave_tpu_torch import obs
    from shockwave_tpu_torch.core.physical import PhysicalScheduler
    from shockwave_tpu_torch.data.default_oracle import generate_oracle
    from shockwave_tpu_torch.ha.election import LeaderElection, LeaseStore
    from shockwave_tpu_torch.ha.frontdoor import AdmissionFrontDoor
    from shockwave_tpu_torch.ha.journal import ControlPlaneJournal
    from shockwave_tpu_torch.ops import eg_pdhg
    from shockwave_tpu_torch.policies import get_policy
    from shockwave_tpu_torch.utils.device import resolve_device
    from shockwave_tpu_torch.utils.fileio import atomic_write_json

    device = resolve_device(args.device)
    config = shockwave_config(args)
    if args.decision_log:
        obs.configure_recorder(args.decision_log)

    store = LeaseStore(args.ha_dir, ttl_s=args.lease_ttl_s)
    election = LeaderElection(store, holder=args.node)
    # A standby blocks here until the incumbent dies (the lease's TTL) or
    # releases; the CAS mints the next fenced epoch. The lease is taken
    # without an address: workers must not learn of this node until the
    # journal restore has finished (publish() below flips the map once
    # the registry is the restored one).
    lease = election.acquire(
        block=True,
        poll_s=min(0.25, args.lease_ttl_s / 4.0),
        timeout_s=args.acquire_timeout_s,
    )
    if lease is None:
        print(json.dumps({"node": args.node, "outcome": "never_leader"}))
        return 3
    # Renew from the start of the term: replaying a large journal can
    # outlast the TTL, and an unrenewed lease would let a second standby
    # start its own restore (two writers on one journal). The
    # scheduler's constructor swaps in its fencing callback.
    election.start_renewal()

    journal_dir = os.path.join(args.ha_dir, "journal")
    snapshot = ControlPlaneJournal.replay(journal_dir)
    journal = ControlPlaneJournal(journal_dir)
    took_over = snapshot.checkpoint is not None or bool(snapshot.entries)

    sched = PhysicalScheduler(
        get_policy(args.policy, device=device),
        port=args.port,
        throughputs=generate_oracle(),
        time_per_iteration=args.round_s,
        completion_buffer_seconds=args.completion_buffer_s,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        minimum_time_between_allocation_resets=0.0,
        shockwave_config=config,
        ha_journal=journal,
        ha_election=election,
        ha_checkpoint_rounds=args.checkpoint_rounds,
        # Registrations bounce until the restore installs the journaled
        # registry (a cold restart on the dead leader's port would
        # otherwise race the restore).
        ha_restore_pending=took_over,
    )
    restored = {}
    if took_over:
        restored = sched.restore_from_journal(snapshot)
    restored_round = sched._round_id

    if not election.is_leader():
        # Deposed during the restore: serving now would make a second
        # writer. Flag it before the shutdown so that the fleet is left
        # to the real leader.
        sched._ha_deposed = True
        sched.shutdown()
        print(json.dumps({"node": args.node, "outcome": "deposed"}))
        return 4

    # Sockets for the admission shards, published in the lease so that
    # the map follows this epoch: only now do workers learn this node's
    # address.
    frontdoor = AdmissionFrontDoor(sched)
    election.publish(
        sched_addr="127.0.0.1",
        sched_port=args.port,
        admission_ports=frontdoor.ports,
    )

    sched.expect_stream()
    lost_workers = []
    if took_over:
        lost_workers = sched.wait_for_reattach(
            timeout=args.reattach_timeout_s
        )
    elif args.expect_workers > 0:
        sched.wait_for_workers(args.expect_workers)

    # Kernel A's launches from here on are this node's rounds', after
    # its restore when it took over.
    launches_at_serve = eg_pdhg.LAUNCHES["eg_pdhg"]
    streams_at_serve = dict(eg_pdhg.LAUNCHES_BY_STREAM)
    outcome = "completed"
    try:
        sched.run(max_rounds=args.max_rounds)
    except BaseException:
        # The summary is still written, and it says what happened: a
        # crashed successor reporting "completed" would pass the very
        # checks this driver serves.
        outcome = "crashed"
        raise
    finally:
        if sched._ha_deposed:
            outcome = "deposed"
        frontdoor.stop()
        summary = {
            "node": args.node,
            "outcome": outcome,
            "epoch": sched._ha_epoch,
            "took_over": took_over,
            "restored_tail": restored,
            # Beside the JAX package's keys: whether the restore started
            # from a checkpoint, and the round it resumed at.
            "restored_checkpoint": snapshot.checkpoint is not None,
            "restored_round": restored_round,
            "lost_workers": lost_workers,
            "round_id": sched._round_id,
            "makespan_s": sched.get_current_timestamp(),
            "completed_jobs": sorted(
                jid.integer
                for jid, t in sched._job_completion_times.items()
                if t is not None
            ),
            "completion_times": {
                str(jid.integer): t
                for jid, t in sched._job_completion_times.items()
            },
            "total_steps_run": {
                str(jid.integer): int(steps)
                for jid, steps in sched._total_steps_run.items()
            },
            "admission": sched._admission.summary(),
            "journal": ControlPlaneJournal.summarize(journal_dir),
            "device": str(device),
            "kernel_a_launches": (
                eg_pdhg.LAUNCHES["eg_pdhg"] - launches_at_serve
            ),
            "kernel_a_launches_by_stream": {
                str(stream): count - streams_at_serve.get(stream, 0)
                for stream, count in eg_pdhg.LAUNCHES_BY_STREAM.items()
                if count > streams_at_serve.get(stream, 0)
            },
        }
        if args.summary_out:
            atomic_write_json(args.summary_out, summary)
        if args.decision_log:
            obs.get_recorder().close()
        print(json.dumps({k: summary[k] for k in (
            "node", "outcome", "epoch", "took_over", "round_id",
        )}))
    return 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return run_node(args)


if __name__ == "__main__":
    raise SystemExit(main())
