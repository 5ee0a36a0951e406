"""Masked low-rank matrix completion by alternating least squares.

The port of the JAX package's ``shockwave_tpu/ops/matrix_completion.py``
(a jitted XLA loop, not a Pallas kernel): given a partially observed
matrix X with a 0/1 mask M, find rank-k factors U, V minimizing
||M * (X - U V^T)||_F^2 + mu (||U||^2 + ||V||^2). Each of the 30 ALS
iterations solves one k x k ridge system a row on each side, here as one
batched ``torch.linalg.solve_ex`` a side, in float32 on an explicit
device.

The JAX package starts from ``jax.random.PRNGKey(0)`` normals, which the
port cannot draw: the start ``(U0, V0)`` is an argument, and its default
(:func:`default_start`) draws from a ``torch.Generator`` seeded 0 on the
CPU, so a start is the same on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def default_start(m: int, n: int, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """0.1 x standard normals of shapes (m, k) and (n, k), float32, from a
    CPU generator seeded 0."""
    gen = torch.Generator().manual_seed(0)
    U0 = torch.randn((m, k), generator=gen, dtype=torch.float32) * 0.1
    V0 = torch.randn((n, k), generator=gen, dtype=torch.float32) * 0.1
    return U0, V0


def _solve_side(F: torch.Tensor, target: torch.Tensor,
                target_mask: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """For each row r of ``target``: argmin_w ||mask_r * (target_r - F w)||^2
    + mu ||w||^2, through the normal equations
    (F^T diag(mask_r) F + mu I) w = F^T (mask_r * target_r)."""
    A = (target_mask[:, :, None] * F).transpose(1, 2) @ F + eye
    b = (target_mask * target) @ F
    # mu > 0 makes every A symmetric positive definite, so the solve
    # cannot fail: solve_ex skips the error check, which would wait for
    # the card on every call.
    return torch.linalg.solve_ex(A, b.unsqueeze(-1))[0].squeeze(-1)


def masked_als(
    X,
    mask,
    k: int = 10,
    mu: float = 1e-2,
    num_iters: int = 30,
    start: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device="cuda",
) -> torch.Tensor:
    """Complete X (m x n) from its observed entries; returns U V^T as a
    float32 tensor on ``device``."""
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
    m, n = X.shape
    if start is None:
        start = default_start(m, n, k)
    U, V = (torch.as_tensor(np.array(f, np.float32) if isinstance(
        f, np.ndarray) else f, dtype=torch.float32).to(device) for f in start)
    Xm = X * mask
    eye = mu * torch.eye(k, dtype=torch.float32, device=device)
    for _ in range(num_iters):
        U = _solve_side(V, Xm, mask, eye)
        V = _solve_side(U, Xm.T, mask.T, eye)
    return U @ V.T


def complete(X: np.ndarray, mask: np.ndarray, k: int = 10, mu: float = 1e-2,
             device="cuda", start=None) -> np.ndarray:
    """Observed entries kept, missing ones filled from the factorization
    and clipped to [0, 1] (throughput fractions)."""
    k = min(k, min(X.shape))
    est = masked_als(X, mask, k=k, mu=mu, start=start,
                     device=device).cpu().numpy()
    return np.where(mask > 0, X, np.clip(est, 0.0, 1.0))
