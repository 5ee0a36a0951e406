"""The survivable control plane: the port of the JAX package's
``shockwave_tpu/ha/`` (a scheduler's write-ahead journal, leader lease
and hot-standby failover).

* :mod:`~shockwave_tpu_torch.ha.journal`: the control plane's write-ahead
  journal. JSONL deltas (admissions, dispatches, Done reports, worker
  registry changes, the round cursor) between compacted checkpoints of
  the whole scheduler state, through the flight recorder's JSON codec.
* :mod:`~shockwave_tpu_torch.ha.election`: leader election by lease, with
  fenced epochs that only rise. The lease record is also the front-door
  map: workers and submitters read the current leader's address,
  admission sockets and epoch from it, so a failover is a flip of the
  map.
* :mod:`~shockwave_tpu_torch.ha.codec`: the scheduler-state capture and
  restore behind the journal's checkpoints and the simulator's
  ``scheduler_crash`` / ``scheduler_restart`` faults.
* :mod:`~shockwave_tpu_torch.ha.frontdoor`: a socket of its own for each
  admission shard, published in the map under the leader's epoch.
* :mod:`~shockwave_tpu_torch.ha.standby`: the node driver
  (``python -m shockwave_tpu_torch.ha.standby``): a leader takes the
  lease and serves; a hot standby blocks on the lease, replays the
  checkpoint and its tail when it takes over, restores its planner onto
  ``--device`` and resumes with the token ledger, quotas, leases and
  in-flight micro-tasks whole; a cold restart does the same from the
  journal alone.

Fencing: the lease's compare-and-swap mints each epoch once; the
scheduler stamps RunJob and KillJob with its epoch, and workers reject
any below the highest they have seen, so a deposed leader cannot
dispatch twice. Epoch 0 means HA off (unfenced, and the same bytes on
the wire as before).
"""

from shockwave_tpu_torch.ha.codec import (  # noqa: F401
    fingerprint,
    from_json,
    job_from_state,
    job_state,
    json_roundtrip,
    planner_state_or_none,
    restore_sets,
    state_fingerprint,
    to_json,
)
from shockwave_tpu_torch.ha.election import (  # noqa: F401
    Lease,
    LeaderElection,
    LeaseLost,
    LeaseStore,
)
from shockwave_tpu_torch.ha.journal import ControlPlaneJournal  # noqa: F401
