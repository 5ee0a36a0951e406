"""Sharded level-set solve of one large EG planning problem over a mesh.

The counterpart of the JAX package's ``shockwave_tpu/solver/eg_sharded.py``:
``solve_level_sharded`` (:257), ``solve_eg_level_sharded`` (:315) and the
body of ``_build_sharded_solver.kernel`` (:89-237). The reference splits
one problem's job slots over a ``jax.sharding.Mesh`` axis with
``shard_map``, in one process, called inline from the planner's round
loop. Here the mesh is the port's one-process
:class:`~shockwave_tpu_torch.parallel.mesh.Mesh` over a ``"solve"`` axis
(:func:`~shockwave_tpu_torch.parallel.mesh.make_solve_mesh`): by default
every visible card once, and in tests and the chip smoke one device in
1, 2, 4 or 8 places. No Pallas kernel sits under the reference's XLA
loop, so, like ``solver/eg_level.py``, this is PyTorch on each place's
device.

Each shard does only local work on its own ``slots/P`` jobs: one stable
sort of its ``slots/P x R`` densities, its prefix sums and its
``searchsorted`` probes. Only these cross shards: sums and maxima of
scalars and of level vectors, and one gather of the tie weights a level.
The global prefix cutoff of the one-device fill becomes a threshold:
every cell denser than theta*, plus the affordable prefix of the cells
tied at theta*, where theta* is the least density whose strict set fits
the budget, found by 31 halvings of the float32 bit pattern (positive
floats order as their int32 bits). Ties are taken in global flat-index
order: shard i's tie budget is the remainder less the tie weight of the
shards before it.

Shards on one device are stacked along a leading shard dimension, so a
solve's launches do not grow with P; a collective is then a reduction
over that dimension, and then over the devices in shard order (one copy
to the mesh's first device and back, which a one-device mesh skips).

The counts equal the one-device solve's (``eg_level.solve_level``) in
every bit, ties included, since both take the same maximal prefix of one
(density descending, flat index ascending) order and every budget sum
adds integer gang widths, exact in float32 below 2^24. The tables use
``eg_level``'s helpers (``interp``, ``fma``, ``levels``), so every cell's
density is the one-device solve's; the objective's sum over jobs runs
shard by shard, so objectives may differ in their last bits.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.parallel import mesh as meshes
from shockwave_tpu_torch.solver.eg_level import (
    GRID_SIZE,
    _EPS,
    counts_to_schedule,
    fma,
    interp,
    levels,
    num_slots_for,
    pad_problem,
)
from shockwave_tpu_torch.solver.eg_problem import EGProblem

_F32 = torch.float32
# Bit pattern of the largest finite float32: the bisection's upper bound.
_MAX_FINITE_BITS = 0x7F7FFFFF
_BISECTION_STEPS = 31
_JOB_ROWS = ("active", "priorities", "completed", "total", "epoch_dur",
             "remaining", "nworkers")

# Sharded solves by the device type of the mesh's first place
# (chip_smoke.py reads it to show the solve ran on the card).
SOLVES: Counter = Counter()


class _Shards:
    """The shards of one mesh axis, grouped by device: each group holds
    its shards' indices in shard order, and groups are ordered by their
    first shard. A group's tensors carry a leading dimension of its
    shards; the collectives take one such tensor a group and return the
    result on each group's device."""

    def __init__(self, devices: Sequence[torch.device]):
        self.count = len(devices)
        groups: Dict[torch.device, List[int]] = {}
        for i, device in enumerate(devices):
            groups.setdefault(device, []).append(i)
        self.groups = list(groups.items())
        self.home = self.groups[0][0]

    def _across(self, parts, reduce):
        if len(parts) == 1:
            return [reduce(parts[0])]
        total = reduce(torch.stack([reduce(p).to(self.home) for p in parts]))
        return [total.to(device) for device, _ in self.groups]

    def psum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._across(parts, lambda x: x.sum(dim=0))

    def pmax(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._across(parts, lambda x: x.amax(dim=0))

    def exclusive_prefix(self, parts: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """The gather of each shard's value, then for each shard the sum
        over the shards before it."""
        if len(parts) == 1:
            return [torch.cumsum(parts[0], dim=0) - parts[0]]
        rows = [None] * self.count
        for (_, shards), part in zip(self.groups, parts):
            for k, i in enumerate(shards):
                rows[i] = part[k].to(self.home)
        every = torch.stack(rows)
        before = torch.cumsum(every, dim=0) - every
        return [before[shards].to(device) for device, shards in self.groups]


def _local_tables(g: dict, R: int, norm):
    """One group's utility and lateness tables, densities, its local
    makespan bounds and its one sort: the reference kernel's table block
    (:105-150) on ``[shards, jobs / shard]`` rows."""
    device = g["active"].device
    active, nworkers = g["active"], g["nworkers"]
    P, Jl = active.shape
    epoch_dur = torch.clamp_min(g["epoch_dur"], _EPS)
    fits = (nworkers <= g["num_gpus"]) & (active > 0)
    need_sec = torch.clamp_min(g["total"] - g["completed"], 0.0) * epoch_dur
    k_sec = torch.arange(R + 1, dtype=_F32, device=device) * g["dur"]
    planned_sec = torch.minimum(k_sec, need_sec[..., None])
    progress = (g["completed"][..., None]
                + planned_sec / epoch_dur[..., None]) / g["total"][..., None]
    U = (active[..., None] * g["priorities"][..., None]
         * interp(progress, g["log_bases"], g["log_vals"]) / norm)
    if "switch_bonus" in g:
        first = torch.arange(R + 1, device=device) >= 1
        U = U + torch.where(first, g["switch_bonus"][..., None], 0.0)
    L = active[..., None] * torch.clamp_min(
        g["remaining"][..., None] - planned_sec, 0.0)
    density = (U[..., 1:] - U[..., :-1]) / nworkers[..., None]
    is_active = active > 0
    L_best = torch.where(fits, L[..., R], L[..., 0])
    floor = torch.where(is_active, L_best, 0.0).amax(dim=1)
    M0 = torch.where(is_active, L[..., 0], 0.0).amax(dim=1)

    # The shard's own cells, sorted once: a stable sort breaks density
    # ties by local flat index, which is global flat-index order within
    # a contiguous job shard.
    usable = fits[..., None] & (density > 1e-12)
    d_flat = torch.where(usable, density, -torch.inf).reshape(P, Jl * R)
    order = torch.argsort(-d_flat, dim=1, stable=True)
    d_sorted = d_flat.gather(1, order)
    d_ok = torch.isfinite(d_sorted)
    w_cell = nworkers[..., None].expand(P, Jl, R).reshape(P, Jl * R)
    g.update(
        fits=fits, U=U, L=L, d_ok=d_ok,
        w_sorted=torch.where(d_ok, w_cell.gather(1, order), 0.0),
        k_sorted=(order % R).to(_F32), j_sorted=order // R,
        inv_order=torch.empty_like(order).scatter_(
            1, order,
            torch.arange(Jl * R, device=device).expand(P, Jl * R)),
        neg_d=(-d_sorted).contiguous(),
    )
    return floor, M0


def _eval_levels(shards: _Shards, groups: List[dict], ts: List[torch.Tensor],
                 R: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The reference's ``eval_level`` (:160-229) on the levels ``ts`` (one
    copy a group): each group's counts ``[shards, T, jobs / shard]`` and
    the objective of each level ``[T]`` on every group's device."""
    n_min, residual_parts = [], []
    for g, t in zip(groups, ts):
        t_eff = torch.maximum(t, g["floor"])
        need = torch.ceil(torch.clamp_min(
            g["remaining"][:, None, :] - t_eff[None, :, None], 0.0)
            / g["dur"])
        need = torch.where(g["fits"][:, None, :],
                           torch.clamp(need, 0.0, float(R)), 0.0)
        n_min.append(need)
        residual_parts.append((g["nworkers"][:, None, :] * need).sum(dim=2))
    used = shards.psum(residual_parts)
    residual = [g["budget"] - u for g, u in zip(groups, used)]

    opened, cum0 = [], []
    for g, need in zip(groups, n_min):
        P, T, Jl = need.shape
        cells = g["neg_d"].shape[1]
        open_sorted = g["d_ok"][:, None, :] & (
            g["k_sorted"][:, None, :]
            >= need.gather(2, g["j_sorted"][:, None, :].expand(P, T, cells)))
        w_open = torch.where(open_sorted, g["w_sorted"][:, None, :], 0.0)
        opened.append(open_sorted)
        cum0.append(torch.cat(
            [w_open.new_zeros(P, T, 1), torch.cumsum(w_open, dim=2)], dim=2))

    def strict_weight(bits):
        """Each group's open weight denser than each level's theta (the
        float32 of ``bits``), and the probe positions."""
        weights, positions = [], []
        for g, c, b in zip(groups, cum0, bits):
            P = g["neg_d"].shape[0]
            theta = b.view(_F32)
            pos = torch.searchsorted(
                g["neg_d"], (-theta).expand(P, -1).contiguous(), side="left")
            weights.append(c.gather(2, pos[..., None])[..., 0])
            positions.append(pos)
        return weights, positions

    # The least theta whose strict set fits the residual, searched over
    # its int32 bit pattern: 31 halvings cover every positive float.
    lo = [torch.zeros_like(r, dtype=torch.int32) for r in residual]
    hi = [torch.full_like(r, _MAX_FINITE_BITS, dtype=torch.int32)
          for r in residual]
    for _ in range(_BISECTION_STEPS):
        mid = [a + (b - a) // 2 for a, b in zip(lo, hi)]
        weights, _ = strict_weight(mid)
        total = shards.psum(weights)
        for i, (a, b, m, w, r) in enumerate(zip(lo, hi, mid, total,
                                                residual)):
            ok = w <= r
            done = a >= b
            lo[i] = torch.where(done, a, torch.where(ok, a, m + 1))
            hi[i] = torch.where(done, b, torch.where(ok, m, b))

    strict_w, pos_strict = strict_weight(lo)
    taken_w = shards.psum(strict_w)
    rem = [r - w for r, w in zip(residual, taken_w)]
    ties = []
    pos_incl = []
    for g, c, b, ps in zip(groups, cum0, lo, pos_strict):
        P = g["neg_d"].shape[0]
        pi = torch.searchsorted(
            g["neg_d"], (-b.view(_F32)).expand(P, -1).contiguous(),
            side="right")
        pos_incl.append(pi)
        ties.append(c.gather(2, pi[..., None])[..., 0]
                    - c.gather(2, ps[..., None])[..., 0])
    before = shards.exclusive_prefix(ties)

    counts, u_parts, l_parts = [], [], []
    for g, c, o, need, ps, pi, pre, rm in zip(
            groups, cum0, opened, n_min, pos_strict, pos_incl, before, rem):
        P, T, Jl = need.shape
        cells = g["neg_d"].shape[1]
        at_strict = c.gather(2, ps[..., None])
        tie_cum = c[..., 1:] - at_strict
        position = torch.arange(cells, device=c.device)
        take = o & ((position < ps[..., None])
                    | ((position < pi[..., None])
                       & (tie_cum <= (rm - pre)[..., None])))
        taken = take.gather(
            2, g["inv_order"][:, None, :].expand(P, T, cells)
        ).reshape(P, T, Jl, R).to(_F32).sum(dim=3)
        k = (need + taken).to(torch.int32)
        index = k.long()[..., None]
        R1 = g["U"].shape[-1]
        u_parts.append(g["U"][:, None].expand(P, T, Jl, R1).gather(
            3, index)[..., 0].sum(dim=2))
        l_parts.append(g["L"][:, None].expand(P, T, Jl, R1).gather(
            3, index)[..., 0].amax(dim=2))
        counts.append(k)
    welfare = shards.psum(u_parts)
    lateness = shards.pmax(l_parts)
    objs = [torch.where(r >= 0.0, fma(-g["reg"], lm, us), -torch.inf)
            for g, r, lm, us in zip(groups, residual, lateness, welfare)]
    return counts, objs


def solve_level_sharded(
    problem: EGProblem,
    mesh: Optional[meshes.Mesh] = None,
    axis_name: str = "solve",
    grid_size: int = GRID_SIZE,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Device head of the sharded solve: per-job round counts [num_jobs]
    (int64) and the objective. Pads the problem to a slot count that the
    mesh's places divide, copies each device its shards' rows (one copy
    a device), and fetches each device's counts (one fetch a device).
    ``mesh`` defaults to every device visible beside ``device`` (every
    card, or the CPU), each once."""
    if mesh is None:
        mesh = meshes.make_solve_mesh(meshes.visible_devices(device),
                                      axis_name)
    shards = _Shards(meshes.axis_devices(mesh, axis_name))
    P = shards.count
    slots = max(num_slots_for(problem.num_jobs), P)
    slots = -(-slots // P) * P
    Jl = slots // P
    R = int(problem.future_rounds)
    host = pad_problem(problem, slots, "cpu")
    names = [n for n in (*_JOB_ROWS, "switch_bonus") if n in host]
    rows = torch.stack([host[n] for n in names]).reshape(len(names), P, Jl)
    scalars = torch.cat([host["num_gpus"].reshape(1), host["log_bases"],
                         host["log_vals"]])
    B = host["log_bases"].shape[0]

    groups = []
    for device_g, indices in shards.groups:
        local = rows[:, indices].to(device_g)
        shared = scalars.to(device_g)
        g = {n: local[i] for i, n in enumerate(names)}
        g["num_gpus"] = shared[0]
        g["log_bases"], g["log_vals"] = shared[1:1 + B], shared[1 + B:]
        groups.append(g)

    def scalar(x, g):
        return torch.tensor(x, dtype=_F32, device=g["active"].device)

    num_active = shards.psum([g["active"].sum(dim=1) for g in groups])
    for g in groups:
        g["dur"] = scalar(float(problem.round_duration), g)
        g["reg"] = scalar(float(problem.regularizer), g)
        g["budget"] = g["num_gpus"] * R
    bounds = [_local_tables(g, R, torch.clamp_min(a, 1.0) * R)
              for g, a in zip(groups, num_active)]
    floor = shards.pmax([b[0] for b in bounds])
    M0 = shards.pmax([b[1] for b in bounds])
    for g, f in zip(groups, floor):
        g["floor"] = f

    # Two passes over the levels, as the one-device solve: the grid,
    # then between the winner's neighbours.
    span = [torch.clamp_min(m - f, 0.0) for m, f in zip(M0, floor)]
    lin = [levels(grid_size, g["active"].device) for g in groups]

    counts1, obj1 = _eval_levels(
        shards, groups, [fma(s, ln, f) for s, ln, f in zip(span, lin, floor)],
        R)
    second = []
    for s, ln, f, o, g in zip(span, lin, floor, obj1, groups):
        best1 = torch.argmax(o).reshape(1)
        step = s / scalar(grid_size - 1, g)
        lo_t = fma(s, ln.index_select(0, best1)[0], f) - step
        second.append(fma(2.0 * step, ln, lo_t))
    counts2, obj2 = _eval_levels(shards, groups, second, R)

    out = torch.empty(P, Jl, dtype=torch.int32)
    objective = None
    for (device_g, indices), c1, c2, o1, o2 in zip(
            shards.groups, counts1, counts2, obj1, obj2):
        obj = torch.cat([o1, o2])
        best = torch.argmax(obj).reshape(1)
        won = torch.cat([c1, c2], dim=1).index_select(1, best)[:, 0]
        # The objective's bits ride along with the counts: one fetch.
        fetched = torch.cat([won.reshape(-1),
                             obj.index_select(0, best).view(torch.int32)]
                            ).cpu()
        out[indices] = fetched[:-1].reshape(len(indices), Jl)
        if objective is None:
            objective = float(fetched[-1:].view(_F32)[0])
    SOLVES[shards.home.type] += 1
    return (out.reshape(-1)[:problem.num_jobs].numpy().astype(np.int64),
            objective)


def solve_eg_level_sharded(
    problem: EGProblem,
    mesh: Optional[meshes.Mesh] = None,
    axis_name: str = "solve",
    polish: bool = True,
    device="cuda",
) -> np.ndarray:
    """End-to-end sharded level-set solve; returns a feasible boolean
    schedule Y ([J, R]): the sharded device head, then the one-device
    solve's host tail (``eg_level.counts_to_schedule``, its greedy on
    ``device``)."""
    with obs.backend_phases("sharded", problem.num_jobs) as bp:
        counts, _ = solve_level_sharded(problem, mesh=mesh,
                                        axis_name=axis_name, device=device)
        bp.phase("device")
        Y = counts_to_schedule(counts, problem, device, polish=polish)
        bp.phase("host")
    return Y
