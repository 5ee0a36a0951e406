"""Kill stale workload processes left behind on a worker host.

The port of the JAX package's ``scripts/kill_stale_workloads.py`` (the
reference's GPU hygiene tool, scripts/utils/kill_gpu_processes.py,
SIGKILLs every process holding a GPU). Stragglers are found by the
dispatcher's environment contract: every payload it launches carries
``SHOCKWAVE_JOB_ID`` in its environment
(``shockwave_tpu_torch/runtime/dispatcher.py``), whatever its command line,
so a crashed agent's leftovers are found whichever payload they ran
(``models.train``, the synthetic payload, ...). By default only ORPHANED
payloads count (reparented to init, the mark of a crashed agent; a live
agent's payloads are left alone); ``--all`` drops that requirement and
``--pattern`` matches a command-line substring instead.

  python -m shockwave_tpu_torch.tools.kill_stale_workloads          # list
  python -m shockwave_tpu_torch.tools.kill_stale_workloads --kill   # TERM, then KILL
"""

from __future__ import annotations

import argparse
import os
import signal
import time

ENV_MARKER = "SHOCKWAVE_JOB_ID="


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return (
                f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            )
    except OSError:
        return None


def _has_env_marker(pid, marker=ENV_MARKER):
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            block = f.read()
    except OSError:
        return False
    # Exact variable-name match over the NUL-separated block (a plain
    # substring would also hit e.g. OLD_SHOCKWAVE_JOB_ID=...).
    return any(
        entry.startswith(marker.encode()) for entry in block.split(b"\0")
    )


def _stat_fields(pid):
    """(state, ppid) from /proc/<pid>/stat, parsed after the
    parenthesized comm (which may itself contain spaces)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            rest = f.read().rpartition(")")[2].split()
        return rest[0], int(rest[1])
    except (OSError, IndexError, ValueError):
        return None, None


def _alive(pid):
    """Running and not a zombie (a zombie's /proc entry persists until
    its parent reaps it, but it holds no resources worth waiting for)."""
    state, _ = _stat_fields(pid)
    return state is not None and state != "Z"


def _orphaned(pid):
    """Reparented to init/subreaper — the signature of a crashed parent
    (the dispatcher launches workloads with start_new_session=True, so
    they survive the agent and get ppid 1)."""
    _, ppid = _stat_fields(pid)
    return ppid == 1


def find_stale(pattern=None, include_parented=False):
    """(pid, cmdline) of stale workload processes.

    Default: dispatcher-launched (exact SHOCKWAVE_JOB_ID env marker) AND
    orphaned (ppid 1 — the crashed-agent signature; a live agent's
    in-flight workloads keep the agent as parent and are left alone).
    ``include_parented`` drops the orphan requirement; ``pattern``
    switches to a cmdline substring match instead of the env marker.
    """
    found = []
    for pid_str in os.listdir("/proc"):
        if not pid_str.isdigit():
            continue
        pid = int(pid_str)
        if pid == os.getpid() or not _alive(pid):
            continue
        cmdline = _cmdline(pid)
        if cmdline is None:
            continue
        if pattern is not None:
            if pattern in cmdline:
                found.append((pid, cmdline))
        elif _has_env_marker(pid) and (
            include_parented or _orphaned(pid)
        ):
            found.append((pid, cmdline))
    return found


def kill(pids, grace_s=3.0):
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + grace_s
    while time.time() < deadline:
        if not any(_alive(pid) for pid in pids):
            return
        time.sleep(0.2)
    for pid in pids:
        if _alive(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument(
        "--pattern", type=str, default=None,
        help="match this cmdline substring instead of the "
        "SHOCKWAVE_JOB_ID env marker",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="also match workloads whose worker agent is still alive "
        "(default: only orphans, ppid 1)",
    )
    parser.add_argument("--kill", action="store_true")
    args = parser.parse_args(argv)
    stale = find_stale(args.pattern, include_parented=args.all)
    if not stale:
        print("No stale workload processes.")
        return
    for pid, cmdline in stale:
        print(f"{pid}: {cmdline[:120]}")
    if args.kill:
        kill([pid for pid, _ in stale])
        print(f"Killed {len(stale)} process(es).")
    else:
        print("(dry run; pass --kill to terminate)")


if __name__ == "__main__":
    main()
