"""CellPlanner: a federation of per-cell EG markets behind the
single-planner contract.

The port of the JAX package's ``shockwave_tpu/cells/planner.py``. The
scheduler drives it exactly like a :class:`ShockwavePlanner` (add and
remove jobs, throughput updates, ``current_round_schedule``, capacity
changes, checkpoint state); inside, the fleet is partitioned into cells,
each owning a capacity slice and a disjoint job set and planning its own
market with its own child planner:

* **Selective replanning.** Only *stale* cells (recompute flagged, or
  plan cache exhausted) re-solve each round; the rest keep their cached
  windows.
* **One launch for the fleet.** Stale cells solve as one launch of
  kernel A with a block a cell (:func:`shockwave_tpu_torch.cells.
  batched.solve_cells_pdhg`). A kernel that fails to build or launch
  raises: the batched path never drops to the per-cell path, the plain
  version or the CPU.
* **Reconciliation.** The coordinator reads each solved cell's
  congestion price and moves chips from cheap cells to congested ones;
  when imbalance persists past ``cell_migration_patience`` replans, jobs
  migrate, priced through the switching-cost term, and a migrated
  incumbent carries its incumbency and relaunch overhead.
* **Per-cell degradation.** With fault injection armed or a plan
  deadline set (and only then, as in the reference), cells solve one by
  one through each child's degradation ladder: an injected
  ``solver_timeout`` degrades that cell while the others plan normally,
  and a cell whose ladder is exhausted keeps its cached plan. A device
  fault (a kernel that does not build or launch, a fault the card
  reported) is raised, not isolated.

* **Plan-ahead speculation.** With ``"speculate": true`` the federation
  speculates as a whole (one clone, one coordinated replan over the
  predicted stale set) and reconciles per cell: on a hit the live
  federation adopts the clone's windows and replays its capacity moves
  and migrations; on churn only the stale cells re-solve, warm-started
  from their speculative windows, as lanes of one launch of kernel A.

* **Flight-recorder exactness.** Each coordinated replan records one
  plan record whose planner state is the full pre-replan federation
  snapshot (kind ``cell_set``), stamped (``cells_replay``) with the stale
  set, per-cell backends and warm starts and the reconciliation trail;
  replay restores the federation and re-runs the identical coordinated
  replan. With the recorder or metrics on, the market attribution (per
  cell dual reports, solver/duals.py) is published beside it.

* **A mesh of cards.** With ``cell_mesh`` the stale cells' lanes split
  over the cards visible beside the planner's device: the largest count
  up to the cards that divides the cells' lane band, one grid launch a
  card (:func:`shockwave_tpu_torch.cells.batched.solve_cells_pdhg`'s
  ``mesh``); with one card, no mesh, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.cells import batched, coordinator, partition
from shockwave_tpu_torch.policies.shockwave import (ShockwavePlanner,
                                                    _is_device_fault)
from shockwave_tpu_torch.policies.speculation import SpeculativePlannerMixin

# Solve knobs default to the single-pdhg backend's; config keys
# ("cell_*") override per deployment.
DEFAULT_RECONCILE_ITERS = 2
DEFAULT_PRICE_RATIO_TOL = 0.25
DEFAULT_MIGRATION_PATIENCE = 2
DEFAULT_MAX_MIGRATIONS = 8


class CellPlanner(SpeculativePlannerMixin):
    """Cell-decomposed planner (see module docstring). Config keys:

    ``cells`` (int >= 2, default 2)
        number of cells the fleet partitions into (clamped to
        ``num_gpus``).
    ``cell_backend`` (default ``"pdhg"``)
        the per-cell backend of the individual (ladder) path; the batched
        path is always kernel A.
    ``cell_reconcile_iters`` / ``cell_price_ratio_tol``
        capacity-reconciliation loop bound and the relative price spread
        it stops at.
    ``cell_migration_patience`` / ``cell_max_migrations``
        consecutive imbalanced replans before jobs migrate, and the
        per-replan migration cap.
    ``cell_max_cycles`` / ``cell_inner_iters``
        per-cell PDHG effort (defaults: the pdhg backend's).
    ``cell_mesh`` (default false)
        split the batched lanes over the visible cards (:meth:`_mesh`).
    """

    def __init__(self, config: dict, backend: str = "cells",
                 device="cuda"):
        self._init_speculation(config)
        self.config = dict(config)
        self.backend = backend
        self.device = device
        self.num_gpus = int(config["num_gpus"])
        self.round_duration = float(config["time_per_iteration"])
        self.future_rounds = int(config.get("future_rounds", 20))
        caps = partition.partition_capacity(self.num_gpus,
                                            int(config.get("cells", 2)))
        names = partition.cell_names(len(caps))
        self.cells: "OrderedDict[str, int]" = OrderedDict(zip(names, caps))
        self.child_backend = str(config.get("cell_backend", "pdhg"))
        self.children: "OrderedDict[str, ShockwavePlanner]" = OrderedDict(
            (name, ShockwavePlanner({**config, "num_gpus": cap},
                                    backend=self.child_backend,
                                    device=device))
            for name, cap in self.cells.items()
        )
        for name, child in self.children.items():
            child.pool_label = name
        self.job_cell: Dict[object, str] = {}
        self.assignments: Dict[str, int] = {n: 0 for n in self.cells}
        # O(1) live-load accounting: per-cell gang sizes of INCOMPLETE
        # jobs plus their running sum, maintained by add / remove /
        # complete / migrate and rebuilt on restore.
        self._cell_jobs: Dict[str, Dict[object, float]] = {
            n: {} for n in self.cells}
        self._load: Dict[str, float] = {n: 0.0 for n in self.cells}
        # Admission stickiness: the last-picked cell (partition.pick_cell).
        self.sticky_cell: Optional[str] = None
        # Last-known congestion price and donatable surplus per cell,
        # kept so reconciliation can weigh cells that did not solve this
        # round.
        self.prices: Dict[str, float] = {n: 0.0 for n in self.cells}
        self.spares: Dict[str, int] = {n: 0 for n in self.cells}
        self.imbalance_rounds = 0
        self.migrations_total = 0
        self.pdhg_tol = float(config.get("pdhg_tol", 1e-4))
        raw_deadline = config.get("plan_deadline_s")
        self.plan_deadline_s = (float(raw_deadline)
                                if raw_deadline is not None else None)
        self.reconcile_iters = int(
            config.get("cell_reconcile_iters", DEFAULT_RECONCILE_ITERS))
        self.price_ratio_tol = float(
            config.get("cell_price_ratio_tol", DEFAULT_PRICE_RATIO_TOL))
        self.migration_patience = int(
            config.get("cell_migration_patience", DEFAULT_MIGRATION_PATIENCE))
        self.max_migrations = int(
            config.get("cell_max_migrations", DEFAULT_MAX_MIGRATIONS))
        self.cell_max_cycles = int(config.get("cell_max_cycles", 96))
        self.cell_inner_iters = int(config.get("cell_inner_iters", 40))
        self.use_mesh = bool(config.get("cell_mesh", False))
        # Coordinator-level solve history (the per-cell records ride each
        # child's own solve_records).
        self.coord_solve_records: List[dict] = []
        self._failed_cells: set = set()
        # Merged window of the cells solved by the most recent coordinated
        # replan (what the flight-recorder replay diffs), and the replay
        # stamp of a restored plan record.
        self.schedules: "OrderedDict[int, list]" = OrderedDict()
        self._replay_stamp: Optional[dict] = None
        # The last committed replan's per-job spend across the re-solved
        # cells (the scheduler's tenant-spend gauges; not replayed).
        self.last_market: Optional[dict] = None
        obs.gauge(
            "cells_count", "number of cells the fleet partitions into"
        ).set(float(len(self.cells)))

    # -- scheduler-facing interface -------------------------------------
    @property
    def round_index(self) -> int:
        return next(iter(self.children.values())).round_index

    @property
    def num_jobs(self) -> int:
        return sum(c.num_jobs for c in self.children.values())

    @property
    def solve_records(self) -> List[dict]:
        records = [dict(r) for r in self.coord_solve_records]
        records += [{**r, "cell": name}
                    for name, c in self.children.items()
                    for r in c.solve_records]
        return records

    def _cell_load(self, name: str) -> float:
        """Live demand weight: sum of incomplete jobs' gang sizes."""
        return self._load.get(name, 0.0)

    def _drop_load(self, job_id) -> None:
        name = self.job_cell.get(job_id)
        if name is None:
            return
        gang = self._cell_jobs.get(name, {}).pop(job_id, None)
        if gang is not None:
            self._load[name] = max(0.0, self._load[name] - gang)

    def _shift_load(self, job_id, src: str, dst: str) -> None:
        gang = self._cell_jobs.get(src, {}).pop(job_id, None)
        if gang is not None:
            self._load[src] = max(0.0, self._load[src] - gang)
            self._cell_jobs[dst][job_id] = gang
            self._load[dst] = self._load.get(dst, 0.0) + gang

    def add_job(self, job_id, profile: dict, round_len: float,
                scale_factor: int, submit_time: Optional[float] = None,
                overhead_s: float = 0.0) -> None:
        names = list(self.cells)
        idx = partition.pick_cell(
            int(scale_factor),
            [self._cell_load(n) for n in names],
            [self.cells[n] for n in names],
            sticky=(names.index(self.sticky_cell)
                    if self.sticky_cell in self.cells else None),
        )
        name = names[idx]
        self.sticky_cell = name
        self.job_cell[job_id] = name
        self.assignments[name] = self.assignments.get(name, 0) + 1
        self._cell_jobs[name][job_id] = float(scale_factor)
        self._load[name] = self._load.get(name, 0.0) + float(scale_factor)
        self.children[name].add_job(job_id, profile, round_len,
                                    scale_factor, submit_time,
                                    overhead_s=overhead_s)
        obs.counter(
            "cells_jobs_assigned_total", "jobs admitted into a cell"
        ).inc(cell=name)

    def _child_of(self, job_id) -> Optional[ShockwavePlanner]:
        name = self.job_cell.get(job_id)
        return self.children.get(name) if name is not None else None

    def remove_job(self, job_id) -> None:
        self._drop_load(job_id)
        child = self._child_of(job_id)
        if child is not None:
            child.remove_job(job_id)
        self.job_cell.pop(job_id, None)

    def record_round_throughput(self, job_id, round_id, throughput,
                                bs) -> None:
        child = self._child_of(job_id)
        if child is not None:
            child.record_round_throughput(job_id, round_id, throughput, bs)

    def mark_complete(self, job_id) -> None:
        self._drop_load(job_id)
        child = self._child_of(job_id)
        if child is not None:
            child.mark_complete(job_id)

    def set_progress(self, job_id, num_epochs: int) -> None:
        child = self._child_of(job_id)
        if child is not None:
            child.set_progress(job_id, num_epochs)
            md = child.job_metadata.get(job_id)
            if md is not None and md.completed_epochs >= md.total_epochs:
                self._drop_load(job_id)

    def get_metadata(self, job_id):
        child = self._child_of(job_id)
        return child.get_metadata(job_id) if child is not None else None

    def increment_round(self) -> None:
        for child in self.children.values():
            child.increment_round()

    def set_recompute_flag(self, jobs=None) -> None:
        """With ``jobs`` given, only the cells owning them go stale; a job
        not yet mapped to a cell (or a bare call) stales every cell."""
        if jobs is not None:
            cells = {self.job_cell.get(j) for j in jobs}
            if None not in cells:
                for name in cells:
                    self.children[name].set_recompute_flag()
                return
        for child in self.children.values():
            child.set_recompute_flag()

    def _cell_floor(self, name: str) -> int:
        """A cell can never shrink below its widest incomplete gang."""
        return partition.cell_floor(self._cell_jobs.get(name, {}))

    def set_capacity(self, num_gpus: int) -> None:
        """Fleet capacity changed: spread the delta across cells
        deterministically, respecting each cell's widest-gang floor."""
        num_gpus = max(1, int(num_gpus))
        if num_gpus == self.num_gpus:
            return
        names = list(self.cells)
        new = partition.spread_capacity_delta(
            [self.cells[n] for n in names],
            num_gpus - sum(self.cells.values()),
            [self._cell_floor(n) for n in names],
        )
        for name, cap in zip(names, new):
            if cap != self.cells[name]:
                self.cells[name] = cap
                self.children[name].set_capacity(cap)
        self.num_gpus = sum(new)
        self.config["num_gpus"] = self.num_gpus

    # -- planning -------------------------------------------------------
    def _cell_stale(self, child: ShockwavePlanner) -> bool:
        """The flat planner's replan trigger: recompute flagged, no cached
        round at the cursor, or a cached round whose jobs all completed
        while incomplete jobs remain."""
        if child.recompute_flag or child.round_index not in child.schedules:
            return True
        live = [
            j for j in child.schedules[child.round_index]
            if j in child.job_metadata
            and child.job_metadata[j].completed_epochs
            < child.job_metadata[j].total_epochs
        ]
        return not live and child._has_incomplete_jobs()

    def _needs_replan(self) -> bool:
        return any(self._cell_stale(c) for c in self.children.values())

    def current_round_schedule(self) -> list:
        """This round's fleet-wide job list; a pending speculation for this
        boundary is reconciled first, then a coordinated replan when any
        cell is stale. The wall time spent here on the reconcile and any
        replan is the exposed planning time."""
        start = time.perf_counter()
        reconciled = self._reconcile_speculation()
        if self._needs_replan():
            self._replan()
            for name, child in self.children.items():
                if name not in self._failed_cells:
                    child.recompute_flag = False
            self._observe_boundary(time.perf_counter() - start)
        elif reconciled is not None:
            self._observe_boundary(time.perf_counter() - start)
        return [j for child in self.children.values()
                for j in child.schedules.get(child.round_index, [])]

    # -- plan-ahead pipelining ------------------------------------------
    # speculate_next_round, _reconcile_speculation and _observe_boundary
    # come from SpeculativePlannerMixin; the hooks below are the
    # federation's reconcile semantics (reference planner.py:363-560).
    def _spec_solve_base(self) -> dict:
        return {
            "coord": len(self.coord_solve_records),
            "cells": {n: len(c.solve_records)
                      for n, c in self.children.items()},
        }

    def _augment_mismatch(self, mismatch: dict) -> dict:
        """A recompute-flagged cell is churned even where the fingerprints
        cannot see why (a batch-size switch, a capacity change)."""
        flagged = [n for n, c in self.children.items() if c.recompute_flag]
        if flagged:
            mismatch = dict(mismatch)
            for name in flagged:
                mismatch.setdefault(name, []).append("recompute_flagged")
        return mismatch

    def _install_speculation(self, spec) -> None:
        """No-churn boundary: adopt the clone's coordinated replan whole,
        replaying its migrations and capacity moves on the live federation
        so its topology matches the installed windows. The live
        children's predictor state stays as it is (in simulation it
        equals the clone's by exact prediction)."""
        clone = spec.clone
        if not spec.solved:
            return  # every cell serves its cache either way
        # Migrations first: a move may be why capacities differ.
        for job_id, dst in list(clone.job_cell.items()):
            src = self.job_cell.get(job_id)
            if src is not None and src != dst:
                self._install_migration(job_id, src, dst)
        for name, cap in clone.cells.items():
            if name in self.cells and self.cells[name] != int(cap):
                # Direct writes, not set_capacity: the installed windows
                # were solved at this capacity, so the change must not
                # flag the cell for another replan.
                self.cells[name] = int(cap)
                child = self.children[name]
                child.num_gpus = int(cap)
                child.config["num_gpus"] = int(cap)
        self.num_gpus = sum(self.cells.values())
        self.config["num_gpus"] = self.num_gpus
        base = spec.base_solve_records
        for name, child in self.children.items():
            cchild = clone.children.get(name)
            if cchild is None:
                continue
            child.schedules = OrderedDict(
                (r, list(s)) for r, s in cchild.schedules.items())
            child.finish_time_estimates = {
                j: list(h) for j, h in cchild.finish_time_estimates.items()}
            child.solve_records.extend(
                dict(r)
                for r in cchild.solve_records[base["cells"].get(name, 0):])
            child.recompute_flag = bool(cchild.recompute_flag)
        self.coord_solve_records.extend(
            dict(r) for r in clone.coord_solve_records[base["coord"]:])
        self.schedules = OrderedDict(
            (r, list(s)) for r, s in clone.schedules.items())
        self.prices = dict(clone.prices)
        self.spares = dict(clone.spares)
        self.imbalance_rounds = int(clone.imbalance_rounds)
        self.migrations_total = int(self.migrations_total) + max(
            0, int(clone.migrations_total) - int(self.migrations_total))
        self._failed_cells = set(clone._failed_cells)

    def _install_migration(self, job_id, src: str, dst: str) -> None:
        """Replay one speculative migration on the live federation (the
        mechanics of :meth:`_move_job`; the install governs the recompute
        flags, since the job's window is already in the installed plan)."""
        src_child, dst_child = self.children[src], self.children[dst]
        md = src_child.job_metadata.pop(job_id, None)
        if md is None:
            return
        dst_child.job_metadata[job_id] = md
        history = src_child.finish_time_estimates.pop(job_id, None)
        if history is not None:
            dst_child.finish_time_estimates[job_id] = history
        dst_child.job_overheads[job_id] = src_child.job_overheads.pop(
            job_id, 0.0)
        if job_id in src_child.last_round_jobs:
            src_child.last_round_jobs = [
                j for j in src_child.last_round_jobs if j != job_id]
            dst_child.last_round_jobs = list(
                dst_child.last_round_jobs) + [job_id]
        self._shift_load(job_id, src, dst)
        self.job_cell[job_id] = dst
        self.migrations_total += 1
        obs.counter(
            "cells_migrations_total", "jobs migrated between cells"
        ).inc(src=src, dst=dst)

    def _prepare_repair(self, spec, mismatch: dict) -> bool:
        """Churned boundary. Only when the federation was going to replan
        anyway: each stale cell adopts its speculative window (the rows of
        jobs it still owns) as its warm basis and is flagged, so the
        boundary's batched solve warm-starts from it through
        ``_solution_warm_start``. Cells that are not stale keep their
        caches; the clone's cross-cell moves are dropped, and the
        boundary coordinator decides them again from live prices."""
        if not self._needs_replan():
            return False
        if spec.solved:
            for name, child in self.children.items():
                if not self._cell_stale(child):
                    continue
                cchild = spec.clone.children.get(name)
                if cchild is None:
                    continue
                child.schedules = OrderedDict(
                    (r, [j for j in s if j in child.job_metadata])
                    for r, s in cchild.schedules.items())
                child.recompute_flag = True
        self._last_repair = True
        return True

    def _slot_band(self) -> int:
        from shockwave_tpu_torch.solver.eg_level import num_slots_for

        return num_slots_for(
            max([1] + [c.num_jobs for c in self.children.values()]))

    def _mesh(self):
        """The lane mesh of ``cell_mesh``: the largest n up to the cards
        visible beside the planner's device that divides the cells' lane
        band, or None (no ``cell_mesh``, one card, or n = 1)."""
        if not self.use_mesh:
            return None
        from shockwave_tpu_torch.parallel import mesh

        devices = mesh.visible_devices(self.device)
        n = len(devices)
        lanes = batched.lane_band(len(self.cells))
        while n > 1 and lanes % n:
            n -= 1
        if n <= 1:
            return None
        return mesh.make_solve_mesh(devices[:n], "cells")

    def _replan(self) -> None:
        """One coordinated planning round over the stale cells (module
        docstring). Records one coordinator-level plan record; replay
        restores the federation and re-enters here."""
        from shockwave_tpu_torch.runtime import faults

        recorder = obs.get_recorder()
        pre_state = self.state_dict() if recorder.enabled else None
        self._replan_epoch += 1
        replay = self._replay_stamp
        self._replay_stamp = None
        if replay is not None:
            stale = [n for n in replay["stale"] if n in self.children]
            individual = bool(replay.get("individual"))
        else:
            stale = [n for n, c in self.children.items()
                     if self._cell_stale(c)] or list(self.children)
            # A speculative clone takes the path the live boundary would
            # take, and its children consume no injected fault.
            individual = (faults.active() is not None
                          or self.plan_deadline_s is not None)
        self._failed_cells = set()

        with obs.span(
            "cells_replan", cat="plan", pid="solver", tid="cells",
            args={"round": self.round_index, "stale": len(stale)},
        ):
            built: "OrderedDict[str, tuple]" = OrderedDict(
                (name, self._build_cell(name)) for name in stale)
            t0 = time.time()
            solved: Dict[str, dict] = {}
            warm_used: Dict[str, Optional[np.ndarray]] = {}
            if individual:
                self._solve_cells_individual(stale, built, solved,
                                             warm_used, replay)
                reconcile = {"iterations": 0, "moves": [],
                             "skipped": ("replay" if replay is not None
                                         else "faults_armed")}
                migrations: list = []
            else:
                reconcile, migrations = self._solve_cells_batched(
                    built, solved, warm_used)
            solve_seconds = time.time() - t0
            self._write_schedules(built, solved)
            self._finish_replan(pre_state, recorder, stale, individual,
                                built, solved, warm_used, reconcile,
                                migrations, solve_seconds)

    def _build_cell(self, name: str):
        child = self.children[name]
        for r in [r for r in child.schedules if r < child.round_index]:
            del child.schedules[r]
        return child._build_problem()

    def _solve_cells_individual(self, stale, built, solved, warm_used,
                                replay=None) -> None:
        """Per-cell solves through each child's own solve path (its ladder
        when armed): an injected solver fault charges the cell whose solve
        consumed it, and a cell whose ladder is exhausted keeps its cached
        plan. A device fault is raised. Replaying a recorded replan
        re-enters each cell's recorded backend and fallback flag (no
        injector runs at replay, so the ladder must not re-roll)."""
        for name in stale:
            child = self.children[name]
            problem, _job_ids = built[name]
            if problem is None:
                continue
            t0 = time.time()
            try:
                if replay is not None:
                    child._solve_warm_start = child._solution_warm_start()
                    child._last_ladder = None
                    backend = replay["backends"].get(name,
                                                     self.child_backend)
                    fallback = bool(replay["fallback"].get(name, False))
                    if name in replay.get("failed", ()):
                        self._failed_cells.add(name)
                        continue
                    Y, used = child._solve_backend(backend, problem,
                                                   as_fallback=fallback)
                else:
                    Y, used = child._solve(problem)
                    ladder = child._last_ladder
                    fallback = bool(ladder and ladder.get("degraded"))
            except Exception as e:
                if _is_device_fault(e):
                    raise
                child._record_solve(
                    time.time() - t0,
                    getattr(child, "_attempted_backend", child.backend),
                    problem.num_jobs, ok=False, error=type(e).__name__)
                self._failed_cells.add(name)
                obs.counter(
                    "cells_cell_failures_total",
                    "cell solves that exhausted every recovery rung",
                ).inc(cell=name)
                obs.gauge(
                    "cells_health",
                    "1 healthy / 0.5 degraded rung / 0 failed, per cell",
                ).set(0.0, cell=name)
                continue
            seconds = time.time() - t0
            child._record_solve(seconds, used, problem.num_jobs, ok=True)
            warm_used[name] = getattr(child, "_solve_warm_start", None)
            solved[name] = {"Y": Y, "backend": used, "fallback": fallback}
            self.prices[name] = 0.0  # refreshed on the next batched round
            obs.histogram(
                "cells_cell_solve_seconds",
                "per-cell plan solve wall time (individual path)",
            ).observe(seconds, cell=name)
            obs.gauge(
                "cells_health",
                "1 healthy / 0.5 degraded rung / 0 failed, per cell",
            ).set(0.5 if fallback else 1.0, cell=name)

    def _batched_subset(self, names, built, warm_used, s_by_cell):
        """One launch over ``names``; updates ``s_by_cell`` and the kept
        prices and spares."""
        solve_names = [n for n in names if built[n][0] is not None]
        if not solve_names:
            return {}
        problems = [built[n][0] for n in solve_names]
        # Re-solves within one replan (capacity moves, migrations)
        # warm-start from the in-replan iterates: a migrated job carries
        # its solved row into the destination cell's lane.
        prev_map = {j: float(v) for entry in s_by_cell.values()
                    for j, v in zip(entry["ids"], entry["s"])}
        s0s = []
        for n in solve_names:
            if n in s_by_cell or any(j in prev_map for j in built[n][1]):
                s0 = np.array([prev_map.get(j, 0.0) for j in built[n][1]],
                              dtype=np.float64)
            else:
                child = self.children[n]
                s0 = child._solution_warm_start()
                warm_used[n] = s0
                child._solve_warm_start = s0
            s0s.append(s0)
        s_list, objs, diags = batched.solve_cells_pdhg(
            problems, s0s, tol=self.pdhg_tol,
            max_cycles=self.cell_max_cycles,
            inner_iters=self.cell_inner_iters, slots=self._slot_band(),
            mesh=self._mesh(), device=self.device)
        out = {}
        for i, n in enumerate(solve_names):
            s_by_cell[n] = {"ids": list(built[n][1]), "s": s_list[i]}
            self.prices[n] = coordinator.congestion_price(problems[i],
                                                          s_list[i])
            self.spares[n] = coordinator.spare_chips(problems[i], s_list[i])
            out[n] = {"objective": objs[i], "diag": diags[i]}
            obs.gauge(
                "cells_price",
                "congestion price (marginal welfare density per "
                "chip-round), per cell",
            ).set(self.prices[n], cell=n)
            obs.gauge(
                "cells_health",
                "1 healthy / 0.5 degraded rung / 0 failed, per cell",
            ).set(1.0, cell=n)
        return out

    def _solve_cells_batched(self, built, solved, warm_used):
        """Batched path, the reconciliation loop and migrations."""
        s_by_cell: Dict[str, dict] = {}
        diags = self._batched_subset(list(built), built, warm_used,
                                     s_by_cell)
        names = list(self.cells)
        moves: List[dict] = []
        for _ in range(max(0, self.reconcile_iters)):
            move = coordinator.propose_capacity_move(
                names, self.prices, self.spares, dict(self.cells),
                {n: self._cell_floor(n) for n in names},
                price_ratio_tol=self.price_ratio_tol)
            if move is None:
                break
            self.cells[move.src] -= move.chips
            self.cells[move.dst] += move.chips
            touched = []
            for n in (move.src, move.dst):
                self.children[n].set_capacity(self.cells[n])
                if n in built and built[n][0] is not None:
                    built[n] = (dataclasses.replace(
                        built[n][0], num_gpus=self.cells[n]), built[n][1])
                elif n not in built:
                    built[n] = self._build_cell(n)
                touched.append(n)
                obs.gauge(
                    "cells_capacity", "chips owned, per cell"
                ).set(float(self.cells[n]), cell=n)
            diags.update(self._batched_subset(touched, built, warm_used,
                                              s_by_cell))
            moves.append(move.as_dict())
            obs.counter(
                "cells_capacity_moves_total",
                "chips reconciled between cells",
            ).inc(move.chips)
        # Migration: only when the price spread persists across replans
        # (patience), decided among cells with fresh solves.
        spread_now = self._imbalanced()
        self.imbalance_rounds = (self.imbalance_rounds + 1
                                 if spread_now else 0)
        migrations: List[dict] = []
        if spread_now and self.imbalance_rounds >= self.migration_patience:
            fresh = list(s_by_cell)
            plan = coordinator.plan_migrations(
                fresh,
                {n: built[n][0] for n in fresh},
                {n: s_by_cell[n]["s"] for n in fresh},
                {n: s_by_cell[n]["ids"] for n in fresh},
                self.prices, dict(self.cells),
                max_moves=self.max_migrations,
                price_ratio_tol=self.price_ratio_tol)
            if plan:
                touched = sorted({m.src for m in plan} | {m.dst for m in plan})
                for m in plan:
                    self._move_job(m)
                    migrations.append(m.as_dict())
                for n in touched:
                    built[n] = self._build_cell(n)
                    if built[n][0] is None:
                        # Every job migrated out: nothing to solve, and
                        # the pre-migration lane is stale.
                        s_by_cell.pop(n, None)
                diags.update(self._batched_subset(touched, built, warm_used,
                                                  s_by_cell))
                self.imbalance_rounds = 0
        for n, entry in s_by_cell.items():
            problem = built[n][0]
            if problem is None:
                continue
            solved[n] = {"Y": batched.schedule_cell(problem, entry["s"],
                                                    self.device),
                         "backend": "cells", "fallback": False,
                         "objective": diags[n]["objective"],
                         "diag": diags[n]["diag"]}
        obs.gauge(
            "cells_reconcile_iterations",
            "capacity moves applied by the last coordinated replan",
        ).set(float(len(moves)))
        obs.gauge(
            "cells_price_spread",
            "max-min congestion price across cells (imbalance signal)",
        ).set(self._price_spread())
        reconcile = {"iterations": len(moves), "moves": moves,
                     "prices": {n: self.prices[n] for n in names},
                     "imbalance_rounds": self.imbalance_rounds}
        return reconcile, migrations

    def _price_spread(self) -> float:
        prices = [self.prices.get(n, 0.0) for n in self.cells]
        return float(max(prices) - min(prices)) if prices else 0.0

    def _imbalanced(self) -> bool:
        prices = {n: self.prices.get(n, 0.0) for n in self.cells}
        hi = max(prices.values(), default=0.0)
        lo = min(prices.values(), default=0.0)
        return hi > 0.0 and (hi - lo) >= self.price_ratio_tol * hi

    def _move_job(self, m: "coordinator.Migration") -> None:
        """Migrate one job between cells, carrying its predictor state,
        finish-time history, relaunch overhead and incumbency: a migrated
        incumbent stays an incumbent, so the destination market still
        prices dropping it."""
        src, dst = self.children[m.src], self.children[m.dst]
        md = src.job_metadata.pop(m.job, None)
        if md is None:
            return
        dst.job_metadata[m.job] = md
        history = src.finish_time_estimates.pop(m.job, None)
        if history is not None:
            dst.finish_time_estimates[m.job] = history
        dst.job_overheads[m.job] = src.job_overheads.pop(m.job, 0.0)
        if m.job in src.last_round_jobs:
            src.last_round_jobs = [j for j in src.last_round_jobs
                                   if j != m.job]
            dst.last_round_jobs = list(dst.last_round_jobs) + [m.job]
        self._shift_load(m.job, m.src, m.dst)
        self.job_cell[m.job] = m.dst
        self.migrations_total += 1
        src.recompute_flag = True
        dst.recompute_flag = True
        obs.counter(
            "cells_migrations_total", "jobs migrated between cells"
        ).inc(src=m.src, dst=m.dst)
        obs.instant(
            "cell_migration", cat="plan", pid="solver", tid="cells",
            args={"job": str(m.job), "src": m.src, "dst": m.dst,
                  "gain": m.gain, "cost": m.cost,
                  "incumbent": m.incumbent},
        )

    def _write_schedules(self, built, solved) -> None:
        """Post-process every solved cell as the flat planner does
        (stickiness, backfill), write the child plan caches and rebuild
        the merged window of this replan's decisions."""
        self.schedules = OrderedDict()
        for name, (problem, job_ids) in built.items():
            child = self.children[name]
            if problem is None:
                for i in range(child.future_rounds):
                    child.schedules[child.round_index + i] = []
                continue
            if name not in solved:
                continue  # failed cell: cached plan kept
            info = solved[name]
            Y = child._apply_stickiness(info["Y"], problem)
            Y = child._backfill(Y, problem)
            info["Y"] = Y
            if info.get("objective") is None:
                info["objective"] = float(problem.objective_value(Y))
            for r in range(child.future_rounds):
                child.schedules[child.round_index + r] = [
                    job_ids[j] for j in range(len(job_ids)) if Y[j, r]]
        for name in built:
            child = self.children[name]
            if name in solved or built[name][0] is None:
                for r in range(child.future_rounds):
                    abs_r = child.round_index + r
                    merged = self.schedules.setdefault(abs_r, [])
                    merged.extend(child.schedules.get(abs_r, []))

    def _finish_replan(self, pre_state, recorder, stale, individual, built,
                       solved, warm_used, reconcile, migrations,
                       solve_seconds) -> None:
        """The coordinator's solve record of this replan, its telemetry,
        its market attribution and, with the recorder on, its plan record
        (the JAX package's planner.py:942-1034)."""
        record = {
            "backend": "cells",
            "seconds": solve_seconds,
            "ok": True,
            "round": self.round_index,
            "num_jobs": sum(built[n][0].num_jobs for n in solved
                            if built[n][0] is not None),
            "stale_cells": len(stale),
            "cells": {
                n: {"backend": info["backend"], "degraded": info["fallback"],
                    "num_jobs": built[n][0].num_jobs,
                    **({"cycles": info["diag"]["cycles"],
                        "lanes": info["diag"]["lanes"]}
                       if info.get("diag") else {})}
                for n, info in solved.items()
            },
            "failed_cells": sorted(self._failed_cells),
            "reconcile": reconcile,
            "migrations": migrations,
        }
        if self._last_repair:
            # A repair: the churned stale cells re-planned warm-started
            # from their speculative windows.
            record["repair"] = True
            self._last_repair = False
        self.coord_solve_records.append(record)
        obs.histogram(
            "shockwave_solve_seconds",
            "plan-solve wall time per backend (ok=False: failed solves)",
        ).observe(solve_seconds, backend="cells", ok="True")
        obs.histogram(
            "cells_coordinated_replan_seconds",
            "wall time of one coordinated (batched) cell replan",
        ).observe(solve_seconds)
        self._market_attribution(built, solved, migrations)
        if pre_state is None:
            return
        pre_state["cells_replay"] = {
            "stale": list(stale),
            "individual": bool(individual),
            "backends": {n: info["backend"] for n, info in solved.items()},
            "fallback": {n: info["fallback"] for n, info in solved.items()},
            "failed": sorted(self._failed_cells),
            "warm_starts": {
                n: (None if w is None else [float(x) for x in w])
                for n, w in warm_used.items()
            },
        }
        start = self.round_index
        plan = {r: list(self.schedules.get(start + r, []))
                for r in range(self.future_rounds)}
        objective = float(sum(info["objective"] for info in solved.values()
                              if info.get("objective") is not None))
        recorder.record_plan(
            planner_state=pre_state,
            plan=plan,
            backend="cells",
            objective=objective,
            solve_record=record,
            problem_summary={
                "cells": {
                    n: {"job_ids": list(built[n][1]),
                        "num_gpus": int(self.cells[n])}
                    for n in solved
                },
                "num_gpus": int(self.num_gpus),
                "future_rounds": int(self.future_rounds),
            },
            tags=self._plan_record_tags,
        )

    def _market_attribution(self, built, solved, migrations) -> None:
        """Market explainability tap of the cells market (the JAX
        package's planner.py:1036-1159): per-cell dual reports at the
        final schedules, the fleet price gauges, and one attribution
        record over every re-solved cell (each job row with its cell,
        the coordinator's prices and this replan's migrations). Pure
        reads; one flags check with the recorder and metrics off."""
        speculative = bool(
            self._plan_record_tags
            and self._plan_record_tags.get("speculative")
        )
        recorder = obs.get_recorder()
        if not (recorder.enabled or obs.metrics_enabled()):
            return
        from shockwave_tpu_torch.solver.duals import dual_report

        reports = {}
        for name, info in solved.items():
            problem = built[name][0]
            if problem is None:
                continue
            reports[name] = dual_report(problem, Y=info["Y"])
        fleet_price = max((r.budget_dual for r in reports.values()),
                          default=0.0)
        chips = {n: float(self.cells[n]) for n in reports}
        total_chips = sum(chips.values()) or 1.0
        fleet_drift = sum(reports[n].fairness_drift * chips[n]
                          for n in reports) / total_chips
        if not speculative:
            obs.gauge(
                "market_price",
                "fleet congestion price (budget dual) of the last plan",
            ).set(fleet_price)
            obs.gauge(
                "market_fairness_drift",
                "budget-weighted fair-share deficit of the last plan "
                "[0,1]",
            ).set(fleet_drift)
            self.last_market = {
                "round": int(self.round_index),
                "keys": [str(j) for name in reports
                         for j in built[name][1]],
                "spend": [float(x) for name in reports
                          for x in reports[name].spend],
                "price": float(fleet_price),
            }
        if not recorder.enabled or not reports:
            return
        from shockwave_tpu_torch.obs.recorder import _job_key

        jobs = {
            "keys": [], "cell": [], "share": [], "fair_share": [],
            "welfare": [], "marginal": [], "price": [], "spend": [],
            "bonus": [], "bonus_state": [], "switch_cost": [],
            "makespan_binding": [], "predicted_finish_s": [],
        }
        for name, report in reports.items():
            problem, job_ids = built[name]
            child = self.children[name]
            bonus = problem.switch_bonus()
            granted = report.s >= 0.5
            jobs["keys"].extend(_job_key(j) for j in job_ids)
            jobs["cell"].extend([name] * len(job_ids))
            jobs["share"].extend(float(x) for x in report.s)
            jobs["fair_share"].extend(float(x) for x in report.fair_share)
            jobs["welfare"].extend(
                float(x) for x in report.welfare_contribution)
            jobs["marginal"].extend(
                float(x) for x in report.marginal_welfare)
            jobs["price"].extend(float(x) for x in report.price)
            jobs["spend"].extend(float(x) for x in report.spend)
            jobs["bonus"].extend(float(x) for x in bonus)
            jobs["bonus_state"].extend(
                ("applied" if g else "forfeited") if b > 0.0 else "none"
                for b, g in zip(bonus, granted))
            jobs["switch_cost"].extend(
                float(x) for x in problem.switch_cost)
            jobs["makespan_binding"].extend(
                int(x) for x in report.makespan_binding)
            jobs["predicted_finish_s"].extend(
                float(child.finish_time_estimates[j][-1][1])
                if child.finish_time_estimates.get(j) else None
                for j in job_ids)
        detail = {
            "round": int(self.round_index),
            "backend": "cells",
            "market": {
                "budget_dual": float(fleet_price),
                "fairness_drift": float(fleet_drift),
                "cell_prices": {
                    n: float(r.budget_dual) for n, r in reports.items()},
                "coordinator_prices": {
                    n: float(p) for n, p in self.prices.items()},
            },
            "degraded": any(info["fallback"] for info in solved.values()),
            "fallback_from": None,
            "migrations": [dict(m) for m in migrations],
            "jobs": jobs,
        }
        if speculative:
            detail["speculative"] = True
        recorder.record_attribution(detail)

    # -- serialization --------------------------------------------------
    def state_dict(self) -> dict:
        """The JAX package's ``cell_set`` state, key for key."""
        return {
            "kind": "cell_set",
            "config": dict(self.config),
            "backend": self.backend,
            "round_index": self.round_index,
            "cells": OrderedDict(self.cells),
            "children": OrderedDict(
                (n, c.state_dict()) for n, c in self.children.items()),
            "job_cell": dict(self.job_cell),
            "assignments": dict(self.assignments),
            "prices": dict(self.prices),
            "spares": dict(self.spares),
            "imbalance_rounds": int(self.imbalance_rounds),
            "migrations_total": int(self.migrations_total),
            "sticky_cell": self.sticky_cell,
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "CellPlanner":
        """Restore a ``cell_set`` state either package wrote. A recorded
        plan record's state carries its ``cells_replay`` stamp: the next
        ``_replan`` re-enters the recorded coordinated replan."""
        planner = cls(state["config"], backend=state["backend"],
                      device=device)
        planner.cells = OrderedDict(
            (n, int(c)) for n, c in state["cells"].items())
        planner.children = OrderedDict(
            (n, ShockwavePlanner.from_state(cs, device=device))
            for n, cs in state["children"].items())
        for n, child in planner.children.items():
            child.pool_label = n
        planner.num_gpus = sum(planner.cells.values())
        planner.job_cell = dict(state["job_cell"])
        planner.assignments = dict(state.get("assignments", {}))
        planner._cell_jobs = {n: {} for n in planner.cells}
        planner._load = {n: 0.0 for n in planner.cells}
        for name, child in planner.children.items():
            for j, md in child.job_metadata.items():
                if md.completed_epochs < md.total_epochs:
                    planner._cell_jobs[name][j] = float(md.nworkers)
                    planner._load[name] += float(md.nworkers)
        planner.prices = {n: float(p)
                          for n, p in state.get("prices", {}).items()}
        planner.spares = {n: int(s)
                          for n, s in state.get("spares", {}).items()}
        planner.imbalance_rounds = int(state.get("imbalance_rounds", 0))
        planner.migrations_total = int(state.get("migrations_total", 0))
        planner.sticky_cell = state.get("sticky_cell")
        stamp = state.get("cells_replay")
        if stamp is not None:
            planner._replay_stamp = {
                "stale": list(stamp.get("stale", [])),
                "individual": bool(stamp.get("individual")),
                "backends": dict(stamp.get("backends", {})),
                "fallback": dict(stamp.get("fallback", {})),
                "failed": list(stamp.get("failed", [])),
            }
            for n, warm in (stamp.get("warm_starts") or {}).items():
                child = planner.children.get(n)
                if child is not None and warm is not None:
                    child._replay_warm_start = list(warm)
        return planner
