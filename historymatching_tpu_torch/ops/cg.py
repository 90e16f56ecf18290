"""Restarted preconditioned CG over a batch of independent members
(PyTorch counterpart of `historymatching_tpu.ops.cg.pcg`).

The semantics are those of `jax.vmap(pcg)`, not of the lockstep
`pcg_batched`: each member's outer loop stops on its own condition, a
finished member's whole state is frozen, and the inner `restart_every`
window is masked only by that member's `rr > tol2`. Kept from `pcg`:
residual replacement at each window, the 100x divergence guard with a
steepest-descent window after it, stagnation patience, the optional
metric weight, and the return of the best iterate.

This is the plain twin of the pressure kernel (`ops/pressure.py`).
"""

from __future__ import annotations

import torch


def _vdot(a, b):
    return (a * b).sum(dim=(-2, -1))


def _f(m):
    """Per-member value -> broadcastable against (..., Nx, Ny) fields."""
    return m[..., None, None]


def pcg(matvec, b, x0=None, Minv=None, tol=1e-8, maxiter=1000, restart_every=64,
        patience_iters=96, metric_weight=None):
    """Solve A x = b for every member of the batch `b` (..., Nx, Ny).

    `matvec` and `Minv` act on the whole batch. Returns (x, iters, rel_res)
    with per-member `iters` (int32) and the best iterate's weighted
    relative residual ||w (b - A x)|| / ||w b||.
    """
    dtype = b.dtype
    tiny = torch.finfo(dtype).tiny
    x0 = torch.zeros_like(b) if x0 is None else x0
    Minv_ = (lambda r: r) if Minv is None else Minv
    if metric_weight is None:
        wdot = _vdot
    else:
        wdot = lambda u, v: _vdot(metric_weight * u, metric_weight * v)  # noqa: E731

    bb = wdot(b, b)
    tol2 = (tol * tol) * torch.clamp_min(bb, tiny)

    def resid(x):
        return b - matvec(x)

    def cg_steps(x, r, p, rz, beta_mask):
        rr = wdot(r, r)
        for _ in range(restart_every):
            live = rr > tol2
            Ap = matvec(p)
            pAp = _vdot(p, Ap)
            alpha = torch.where(live, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
            x = x + _f(alpha) * p
            r = r - _f(alpha) * Ap
            z = Minv_(r)
            rz_new = torch.where(live, _vdot(r, z), rz)
            beta = torch.where(live, beta_mask * rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
            p = torch.where(_f(live), z + _f(beta) * p, p)
            rz = rz_new
            rr = torch.where(live, wdot(r, r), rr)
        return x, p

    patience = max(4, -(-patience_iters // restart_every))
    r0 = resid(x0)
    x, p = x0, Minv_(r0)
    use_sd = torch.zeros_like(bb, dtype=torch.bool)
    x_best, rr_best = x0, wdot(r0, r0)
    n_bad = torch.zeros_like(bb, dtype=torch.int32)
    k = torch.zeros_like(bb, dtype=torch.int32)
    while True:
        active = (k < maxiter) & (rr_best > tol2) & (n_bad < patience)
        if not bool(active.any()):
            break
        r = resid(x)
        z = Minv_(r)
        beta_mask = torch.where(use_sd, 0.0, 1.0).to(dtype)
        p_start = torch.where(_f(use_sd), z, p)
        x_new, p_new = cg_steps(x, r, p_start, _vdot(r, z), beta_mask)
        r_new = resid(x_new)
        rr_new = wdot(r_new, r_new)
        finite = torch.isfinite(rr_new)
        blown = (~finite) | (rr_new > 100.0 * torch.maximum(rr_best, tol2))
        better = finite & (rr_new < rr_best)
        xb_new = torch.where(_f(better), x_new, x_best)
        # A finished member keeps its whole state (the vmap'd while_loop's
        # per-member select).
        a = _f(active)
        x = torch.where(a, torch.where(_f(blown), xb_new, x_new), x)
        p = torch.where(a, p_new, p)
        use_sd = torch.where(active, blown, use_sd)
        x_best = torch.where(a, xb_new, x_best)
        rr_best = torch.where(active & better, rr_new, rr_best)
        n_bad = torch.where(active, torch.where(better, 0, n_bad + 1), n_bad)
        k = torch.where(active, k + restart_every, k)
    rel_res = torch.sqrt(rr_best / torch.clamp_min(bb, tiny))
    return x_best, k, rel_res
