"""Cell-decomposed market: partitioned EG solves with a reconciling
coordinator, the port of the JAX package's ``shockwave_tpu/cells/``.

  * :mod:`.partition` — capacity partitioning and least-loaded cell
    assignment at admission.
  * :mod:`.batched` — every stale cell's market solved in one launch of
    kernel A, a block a cell.
  * :mod:`.coordinator` — congestion prices, the capacity-reconciliation
    step and migration planning priced through the switching cost.
  * :mod:`.planner` — :class:`CellPlanner`, the scheduler-facing
    federation behind the single-planner contract.
"""
