"""The EG planning program and its solvers: the level-set solve on a
torch device, the host rounding, and the native greedy."""

from shockwave_tpu_torch.solver.eg_problem import EGProblem

__all__ = ["EGProblem"]
