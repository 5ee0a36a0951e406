"""Seeding the what-if fleet from real planner state.

The port of the JAX package's ``shockwave_tpu/whatif/seed.py``. The
scenario batch is seeded from the planner's own problem build: a
recorded decision log (``obs/recorder.py::extract_state``), an
``export-state`` artifact, or a live planner's ``state_dict()``, of
either package. The state is restored on a throwaway planner (the
state dict, never the live planner, since ``_build_problem`` appends to
the finish-time-fairness history) and the base
:class:`~shockwave_tpu_torch.solver.eg_problem.EGProblem` is built by the
same ``_build_problem`` a replan runs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from shockwave_tpu_torch.solver.eg_problem import EGProblem

# The per-job fields of a problem, merged row-wise across cells.
_JOB_FIELDS = ("priorities", "completed_epochs", "total_epochs",
               "epoch_duration", "remaining_runtime", "nworkers",
               "switch_cost", "incumbent")


def base_problem_from_state(
    state: dict,
) -> Tuple[EGProblem, List[str], Optional[np.ndarray]]:
    """Restore a planner state dict and build its EG problem.

    Returns ``(problem, job_keys, s0)``: ``job_keys`` the stringified job
    ids in problem row order, ``s0`` the plan-cache warm start (None when
    the state carries no usable cache). A ``cell_set`` state is merged
    into one global market: per-cell rows concatenated in cell order,
    capacities summed, each cell's warm start (zeros where it has none)
    concatenated."""
    from shockwave_tpu_torch.policies.shockwave import (ShockwavePlanner,
                                                        planner_from_state)

    if state.get("kind") == "cell_set":
        problems, keys, warms = [], [], []
        for child_state in state["children"].values():
            child = ShockwavePlanner.from_state(child_state)
            problem, job_ids = child._build_problem()
            if problem is None:
                continue
            problems.append(problem)
            keys.extend(str(j) for j in job_ids)
            w = child._solution_warm_start()
            warms.append(w if w is not None else np.zeros(problem.num_jobs))
        if not problems:
            raise ValueError("cell_set state has no incomplete jobs to build "
                             "a what-if problem from")
        merged = dataclasses.replace(
            problems[0],
            **{f: np.concatenate([np.asarray(getattr(p, f))
                                  for p in problems]) for f in _JOB_FIELDS},
            num_gpus=int(sum(p.num_gpus for p in problems)),
        )
        return merged, keys, np.concatenate(warms)

    planner = planner_from_state(state)
    if not hasattr(planner, "_build_problem"):
        raise ValueError(
            f"planner kind {state.get('kind')!r} does not expose "
            "_build_problem; seed the what-if fleet from a flat or cell_set "
            "snapshot")
    problem, job_ids = planner._build_problem()
    if problem is None:
        raise ValueError("planner state has no incomplete jobs to build a "
                         "what-if problem from")
    return problem, [str(j) for j in job_ids], planner._solution_warm_start()


def base_problem_from_log(
    path: str, round_index: Optional[int] = None
) -> Tuple[EGProblem, List[str], Optional[np.ndarray], int]:
    """Seed from a decision log: the resolved planner state of
    ``round_index`` (default: the last recorded plan) and its problem.
    Returns ``(problem, job_keys, s0, round)``."""
    from shockwave_tpu_torch.obs.recorder import extract_state

    extracted = extract_state(path, round_index=round_index)
    problem, keys, s0 = base_problem_from_state(extracted["planner_state"])
    return problem, keys, s0, int(extracted["round"])
