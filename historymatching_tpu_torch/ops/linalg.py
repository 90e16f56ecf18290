"""SPD inverse and solve, and the Tikhonov right pseudo-inverse (PyTorch
counterpart of `spd_inverse`, `spd_solve` and `rinv_tikh` in
`historymatching_tpu.ops.linalg`).

The JAX package inverts by Newton-Schulz because its TPU backend has no
LAPACK. Here the factorization is a batched Cholesky, under the same
conditioning: diagonal scaling s = rsqrt(diag), As = sym(A s s') + jitter I,
inverse, rescale. A matrix whose Cholesky fails (not positive definite in
the working precision) gets the JAX package's guarded Newton-Schulz
instead, on its own, so nothing raises and the other matrices of a batch
keep their Cholesky inverses.
"""

from __future__ import annotations

import torch


def _sym(A):
    return 0.5 * (A + A.mT)


def newton_schulz_inverse(As, iters=50):
    """The JAX package's guarded Newton-Schulz inverse (its `spd_inverse`
    on an already scaled, symmetrized and jittered batch As (B, n, n)),
    each matrix on its own: X_{k+1} = sym(X_k (2 I - As X_k)) from
    X_0 = I / (largest absolute row sum). Each matrix keeps its best iterate
    by max|As X - I| and stops on growth (residual over 4x the best), on
    stagnation (3 steps without a better one) or at the floor 32 eps; the
    batch runs until every matrix has stopped. Never raises: an indefinite
    matrix returns the best iterate it reached."""
    n = As.shape[-1]
    eye = torch.eye(n, dtype=As.dtype, device=As.device)
    resid = lambda AX: (AX - eye).abs().amax(dim=(-2, -1))  # noqa: E731
    X = eye / As.abs().sum(-1).amax(-1)[:, None, None]
    AX = As @ X
    best = cur = resid(AX)
    best_X = X
    n_flat = torch.zeros_like(best, dtype=torch.int32)
    floor = 32 * torch.finfo(As.dtype).eps
    for _ in range(iters):
        live = (cur <= 4.0 * best) & (n_flat < 3) & (best > floor)
        if not bool(live.any()):
            break
        X_new = _sym(X @ (2.0 * eye - AX))
        AX_new = As @ X_new
        r = resid(AX_new)
        better = live & (r < best)
        X = torch.where(live[:, None, None], X_new, X)
        AX = torch.where(live[:, None, None], AX_new, AX)
        best_X = torch.where(better[:, None, None], X_new, best_X)
        best = torch.where(better, r, best)
        n_flat = torch.where(live, torch.where(better, 0, n_flat + 1), n_flat)
        cur = torch.where(live, r, cur)
    return best_X


def spd_inverse(A, jitter=0.0):
    """Inverse of (a batch of) SPD matrices: Cholesky, and for each matrix
    whose Cholesky fails the guarded Newton-Schulz (`newton_schulz_inverse`).
    Reads the factorization's status from the device once."""
    n = A.shape[-1]
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d, torch.finfo(A.dtype).tiny))
    As = _sym(A * s[..., :, None] * s[..., None, :])
    if jitter:
        As = As + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(As)
    X = torch.cholesky_inverse(L)
    failed = (info != 0).reshape(-1)
    if bool(failed.any()):
        X = X.reshape(-1, n, n).clone()
        X[failed] = newton_schulz_inverse(As.reshape(-1, n, n)[failed])
        X = X.reshape(As.shape)
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
