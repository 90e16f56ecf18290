"""TPFA 5-point stencil (PyTorch counterpart of `historymatching_tpu.ops.stencil`).

Every function takes any leading batch dimensions; the last two axes are
the grid (Nx, Ny). The pinned-diagonal convention is the JAX package's:
`pin` is added to cell (0, 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def transmissibilities(Kx, Ky, hx, hy):
    """Harmonic-average inner-face transmissibilities.
    Returns TX (..., Nx-1, Ny) and TY (..., Nx, Ny-1)."""
    tx = 2.0 * hy / hx
    ty = 2.0 * hx / hy
    TX = tx / (1.0 / Kx[..., :-1, :] + 1.0 / Kx[..., 1:, :])
    TY = ty / (1.0 / Ky[..., :, :-1] + 1.0 / Ky[..., :, 1:])
    return TX, TY


def stencil_diag_nopin(TX, TY):
    """Unpinned diagonal: sum of adjacent face transmissibilities."""
    Nx = TX.shape[-2] + 1
    Ny = TY.shape[-1] + 1
    lead = torch.broadcast_shapes(TX.shape[:-2], TY.shape[:-2])
    diag = torch.zeros(*lead, Nx, Ny, dtype=TX.dtype, device=TX.device)
    diag[..., :-1, :] += TX
    diag[..., 1:, :] += TX
    diag[..., :, :-1] += TY
    diag[..., :, 1:] += TY
    return diag


def stencil_diag(TX, TY, pin=None):
    """Diagonal plus the `pin` anchor on cell (0, 0); the default pin is the
    mean of the unpinned diagonal (per member)."""
    diag = stencil_diag_nopin(TX, TY)
    if pin is None:
        pin = diag.mean(dim=(-2, -1))
    diag[..., 0, 0] += pin
    return diag


def stencil_matvec(TX, TY, diag, p):
    """A @ p for the 5-point TPFA operator, in the JAX package's term order."""
    out = diag * p
    out = out - F.pad(TX * p[..., 1:, :], (0, 0, 0, 1))
    out = out - F.pad(TX * p[..., :-1, :], (0, 0, 1, 0))
    out = out - F.pad(TY * p[..., :, 1:], (0, 1))
    out = out - F.pad(TY * p[..., :, :-1], (1, 0))
    return out


def _two_sum(a, b):
    """Error-free addition (Knuth 2Sum): a + b = s + err exactly."""
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


def _two_prod(a, b):
    """Error-free product (Dekker split, float32 splitter 2^12 + 1):
    a * b = p + e exactly in float32. Each eager op is its own kernel, so
    nothing contracts these products into an FMA (which would void the
    split); keep them out of `torch.compile` and fused kernels."""
    c = 4097.0 * a
    hi = c - (c - a)
    lo = a - hi
    p = a * b
    e = (hi * b - p) + lo * b
    return p, e


def stencil_residual_ds(TX, TY, diag, p, b):
    """Compensated (double-single) residual r = b - A p for the 5-point
    operator, in the JAX package's operation order: every product an
    error-free two-prod, the sum Neumaier-accumulated. The recook's
    refinement pass (`ops.pressure.pressure_solve_recook`) solves for the
    correction from it."""

    def padded_prod(T, pn, pad):
        hi, lo = _two_prod(T, pn)
        return F.pad(hi, pad), F.pad(lo, pad)

    terms = [
        padded_prod(TX, p[..., 1:, :], (0, 0, 0, 1)),
        padded_prod(TX, p[..., :-1, :], (0, 0, 1, 0)),
        padded_prod(TY, p[..., :, 1:], (0, 1)),
        padded_prod(TY, p[..., :, :-1], (1, 0)),
    ]
    dhi, dlo = _two_prod(diag, p)
    acc, comp = _two_sum(b, -dhi)
    comp = comp - dlo
    for hi, lo in terms:
        acc, e = _two_sum(acc, hi)
        comp = comp + (e + lo)
    return acc + comp


def face_fluxes(TX, TY, p):
    """Darcy face fluxes, padded with the zero-flux boundary.
    Fx (..., Nx+1, Ny), Fy (..., Nx, Ny+1); positive = flow towards +x/+y."""
    fx = TX * (p[..., :-1, :] - p[..., 1:, :])
    fy = TY * (p[..., :, :-1] - p[..., :, 1:])
    return F.pad(fx, (0, 0, 1, 1)), F.pad(fy, (1, 1))
