"""The control plane's state codec (the port of the JAX package's
``shockwave_tpu/ha/codec.py``): the scheduler-state capture and restore
the simulator's ``scheduler_crash`` / ``scheduler_restart`` faults round
trip through. Leader election, the journal, the standby and the front
door are not ported yet (ROADMAP.md, queue 1, item 10b)."""

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
