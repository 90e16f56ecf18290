"""Geometric multigrid V-cycle for the TPFA pressure system (PyTorch
counterpart of the non-Mosaic parts of `historymatching_tpu.ops.multigrid`).

Galerkin coarsening with constant 2x2 aggregates, damped-Jacobi smoothing
(omega = 0.7) or a degree-2 Chebyshev smoother, block-sum restriction,
prolongation by injection with over-correction omega_c = 1.4, and an
exact coarsest solve with a
precomputed dense inverse. All functions take a leading member axis.
This is the plain twin of the V-cycle inside the pressure kernel
(`ops/pressure.py`, `csrc/pressure_pcg.cu`).
"""

from __future__ import annotations

import torch

from historymatching_tpu_torch.ops.linalg import spd_inverse
from historymatching_tpu_torch.ops.stencil import stencil_diag, stencil_matvec


def n_levels(Nx, Ny, min_dim=4):
    """Number of multigrid levels for a grid: coarsen while both dims are
    even and > min_dim."""
    n = 1
    while Nx % 2 == 0 and Ny % 2 == 0 and Nx > min_dim and Ny > min_dim:
        Nx //= 2
        Ny //= 2
        n += 1
    return n


def _coarsen_faces(TX, TY):
    """Galerkin coarse face transmissibilities (sums across aggregate faces)."""
    *lead, Nxm1, Ny = TX.shape
    Nxc, Nyc = (Nxm1 + 1) // 2, Ny // 2
    TXc = TX[..., 1::2, :].reshape(*lead, Nxc - 1, Nyc, 2).sum(-1)
    Nx = TY.shape[-2]
    TYc = TY[..., :, 1::2].reshape(*lead, Nx // 2, 2, Nyc - 1).sum(-2)
    return TXc, TYc


def _coarsen_diag(TX, TY, diag):
    """Galerkin coarse diagonal of a general 5-point operator:
    restrict(diag) - 2 * (intra-aggregate face transmissibilities)."""
    *lead, Nx, Ny = diag.shape
    Nxc, Nyc = Nx // 2, Ny // 2
    intra_x = TX[..., 0::2, :].reshape(*lead, Nxc, Nyc, 2).sum(-1)
    intra_y = TY[..., :, 0::2].reshape(*lead, Nxc, 2, Nyc).sum(-2)
    return _restrict(diag) - 2.0 * intra_x - 2.0 * intra_y


def build_hierarchy_5pt(TX, TY, diag, levels=None):
    """Per-level (TX, TY, diag) Galerkin data, fine to coarse."""
    if levels is None:
        levels = n_levels(TX.shape[-2] + 1, TY.shape[-1] + 1)
    out = [(TX, TY, diag)]
    for _ in range(levels - 1):
        diag = _coarsen_diag(TX, TY, diag)
        TX, TY = _coarsen_faces(TX, TY)
        out.append((TX, TY, diag))
    return out


def build_hierarchy(TX, TY, pin, levels=None):
    """The hierarchy of the unscaled TPFA operator: its diagonal is the face
    sums plus `pin` (per member) at cell (0, 0), which Galerkin coarsening
    carries to every coarse (0, 0)."""
    return build_hierarchy_5pt(TX, TY, stencil_diag(TX, TY, pin=pin), levels)


def _restrict(r):
    *lead, Nx, Ny = r.shape
    return r.reshape(*lead, Nx // 2, 2, Ny // 2, 2).sum(dim=(-3, -1))


def _prolong(e, shape):
    Nx, Ny = shape[-2:]
    return e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :Nx, :Ny]


def _jacobi(TX, TY, diag, x, b, sweeps, omega=0.7):
    for _ in range(sweeps):
        x = x + omega * (b - stencil_matvec(TX, TY, diag, x)) / diag
    return x


# Chebyshev smoothing interval, as fractions of the Gershgorin bound
# lam_max(D^-1 A) <= 2 (every level is a diagonally dominant 5-point
# operator). The lower edge targets the smoothing range; the coarse-grid
# correction owns the low modes.
CHEB_BOUNDS = (0.5, 2.0)
SMOOTHERS = ("jacobi", "cheb")


def _cheb(mv, diag, x, b, sweeps, bounds=CHEB_BOUNDS):
    """`sweeps`-degree Chebyshev (first kind) smoother on D^-1 A, by the
    three-term recurrence. The coefficients are Python floats, so the
    smoother is a fixed polynomial in D^-1 A: the same polynomial before
    and after the coarse correction keeps the V-cycle SPD. `diag` is the
    level's own diagonal."""
    lmin, lmax = bounds
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - mv(x)
    d = (r / diag) * (1.0 / theta)
    x = x + d
    for _ in range(sweeps - 1):
        r = r - mv(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (r / diag)
        x = x + d
        rho = rho_new
    return x


def _smooth(TX, TY, diag, x, b, sweeps, omega, smoother):
    if smoother == "cheb":
        return _cheb(lambda v: stencil_matvec(TX, TY, diag, v), diag, x, b, sweeps)
    if smoother == "jacobi":
        return _jacobi(TX, TY, diag, x, b, sweeps, omega)
    raise ValueError(f"smoother must be one of {SMOOTHERS}, got {smoother!r}")


def _dense_coarse_matrix(TX, TY, diag):
    """The coarsest operator, materialized by applying it to the identity:
    (..., n, n) with n = Nc * Mc, row-major over the coarse grid."""
    *lead, Nc, Mc = diag.shape
    n = Nc * Mc
    eye = torch.eye(n, dtype=diag.dtype, device=diag.device).reshape(n, Nc, Mc)
    unsq = lambda a: a.unsqueeze(-3)  # noqa: E731  (member axis -> columns)
    cols = stencil_matvec(unsq(TX), unsq(TY), unsq(diag), eye).reshape(*lead, n, n)
    return cols.mT  # symmetric anyway


def coarse_inverse(hierarchy):
    """Inverse of the coarsest operator by Cholesky, with the JAX package's
    jitter on the scaled matrix: 1e-4 in float32 (bounds the scaled
    condition number), 1e-12 in float64."""
    Acoarse = _dense_coarse_matrix(*hierarchy[-1])
    eps = 1e-4 if Acoarse.dtype == torch.float32 else 1e-12
    return spd_inverse(Acoarse, jitter=eps)


def vcycle_apply(hierarchy, Ainv, b, nu=2, omega=0.7, omega_c=1.4, smoother="jacobi"):
    """One V-cycle from a zero initial guess: b -> approx A^{-1} b.
    `Ainv` is the (..., n, n) coarse inverse. `smoother`: "jacobi" (damped,
    `omega`) or "cheb" (degree-`nu` Chebyshev, `_cheb`)."""

    def cycle(b, lvl):
        TX, TY, diag = hierarchy[lvl]
        if lvl == len(hierarchy) - 1:
            return (Ainv @ b.reshape(*b.shape[:-2], -1, 1)).reshape(b.shape)
        x = _smooth(TX, TY, diag, torch.zeros_like(b), b, nu, omega, smoother)
        r = b - stencil_matvec(TX, TY, diag, x)
        ec = cycle(_restrict(r), lvl + 1)
        x = x + omega_c * _prolong(ec, b.shape)
        return _smooth(TX, TY, diag, x, b, nu, omega, smoother)

    return cycle(b, 0)


def vcycle_solver(hierarchy, nu=2, omega=0.7, omega_c=1.4, Ainv=None, smoother="jacobi"):
    """M_inv: b -> one V-cycle from a zero start (`vcycle_apply`), a fixed
    SPD preconditioner for `ops.cg.pcg`'s `Minv`. `Ainv`, where given, is
    the coarse inverse to use (e.g. one kept for a pass); else it is
    computed here once (`coarse_inverse`)."""
    if Ainv is None:
        Ainv = coarse_inverse(hierarchy)
    return lambda b: vcycle_apply(hierarchy, Ainv, b, nu, omega, omega_c=omega_c,
                                  smoother=smoother)
