"""SPD inverse and solve, and the Tikhonov right pseudo-inverse (PyTorch
counterpart of `spd_inverse`, `spd_solve` and `rinv_tikh` in
`historymatching_tpu.ops.linalg`).

The JAX package inverts by Newton-Schulz because its TPU backend has no
LAPACK. Here the factorization is a batched Cholesky, under the same
conditioning: diagonal scaling s = rsqrt(diag), As = sym(A s s') + jitter I,
inverse, rescale.
"""

from __future__ import annotations

import torch


def spd_inverse(A, jitter=0.0):
    """Inverse of (a batch of) SPD matrices. Raises if a Cholesky fails."""
    n = A.shape[-1]
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d, torch.finfo(A.dtype).tiny))
    As = A * s[..., :, None] * s[..., None, :]
    As = 0.5 * (As + As.mT)
    if jitter:
        As = As + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(As)
    if bool((info != 0).any()):
        raise torch.linalg.LinAlgError(
            f"Cholesky failed for {int((info != 0).sum())} matrices")
    X = torch.cholesky_inverse(L)
    return X * s[..., :, None] * s[..., None, :]


def spd_solve(A, B, jitter=0.0):
    """Solve A X = B for SPD A (inverse, then one product, as in JAX)."""
    return spd_inverse(A, jitter=jitter) @ B


def rinv_tikh(A, reg):
    """Tikhonov-regularized right pseudo-inverse of (a batch of) A (m, n):
    with reg' = reg * sigma_max(A), A' (A A' + reg'^2 I)^-1. sigma_max is
    exact here (`matrix_norm`, an SVD); the JAX package estimates it by
    power iteration."""
    r = reg * torch.linalg.matrix_norm(A, ord=2)[..., None, None]
    m = A.shape[-2]
    G = A @ A.mT + (r * r) * torch.eye(m, dtype=A.dtype, device=A.device)
    return spd_solve(G, A).mT
