"""Gaussian random-field priors (PyTorch counterpart of
`historymatching_tpu.da.geostat`). Two samplers of the same law (Gaussian
variogram, squared-exponential covariance):

- `gaussian_fields_dense`: the dense covariance of a point set and its
  symmetric square root; exact, O(n^3), for small grids and irregular
  points. The JAX package takes the root by Newton-Schulz because its TPU
  backend has no eigensolver; here it is `torch.linalg.eigh`.
- `gaussian_fields_fft`: circulant embedding on a regular grid. The JAX
  package evaluates the 2D DFT as matmuls because its TPU backend has no
  FFT; here it is `torch.fft.fft2`.

`gaussian_fields` takes the FFT sampler when given a grid.
"""

from __future__ import annotations

import numpy as np
import torch

from historymatching_tpu_torch import prng
from historymatching_tpu_torch.utils import as_float


def variogram_gauss(xx, r, n=0.0, a=1.0 / 3.0):
    """Gaussian variogram with range `r`, nugget `n`, shape `a`:
    (1-n) (1 - exp(-x^2 / (r^2 a))), plus `n` where x != 0."""
    xx = as_float(xx)
    gamma = (1 - torch.exp(-(xx**2) / r**2 / a)) * (1 - n)
    return torch.where(xx != 0, gamma + n, gamma)


def cov_gauss(dists, r, n=0.0, a=1.0 / 3.0):
    """Stationary covariance C(d) = 1 - variogram(d)."""
    return 1.0 - variogram_gauss(dists, r, n=n, a=a)


def vectorize(*XYZ):
    """Mesh arrays -> (nPt, nDim) point list."""
    return torch.stack([as_float(a) for a in XYZ]).reshape(len(XYZ), -1).T


def dist_euclid(X):
    """Full pairwise distance matrix of one point set (nPt, nDim)."""
    X = as_float(X)
    return ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1).sqrt()


def funm_psd(C, fun, rk=None, rtol=1e-8):
    """Matrix function V fun(L) V' of a symmetric PSD matrix by
    eigendecomposition, eigenvalues descending: those past the `rk` largest,
    and those at or below rtol times the largest, are dropped."""
    ews, V = torch.linalg.eigh(C)
    ews, V = ews.flip(-1), V.flip(-1)
    if rk:
        ews = torch.where(torch.arange(ews.shape[-1], device=ews.device) < rk, ews, 0.0)
    ews = torch.where(ews > rtol * ews.max(), ews, 0.0)
    few = torch.where(ews > 0, fun(torch.where(ews > 0, ews, 1.0)), 0.0)
    return (V * few) @ V.T


def gaussian_fields_dense(pts, N=1, r=0.2, generator=None, Z=None, dtype=None, device="cuda"):
    """Exact dense sampler: (N, nPt) fields Z @ F with F = Cov^(1/2), the
    symmetric square root (`funm_psd`), so F F' = Cov. `pts` is a tuple of
    mesh or coordinate arrays (as `Grid2D.mesh`). The standard-normal `Z`
    (N, nPt) is drawn from `generator` unless given."""
    dtype = dtype or torch.get_default_dtype()
    pts_ = vectorize(*pts).to(dtype=dtype, device=device)
    F = funm_psd(cov_gauss(dist_euclid(pts_), r), torch.sqrt)
    if Z is None:
        Z = torch.randn((N, F.shape[0]), generator=generator, dtype=dtype, device=device)
    return torch.as_tensor(Z, dtype=dtype, device=device) @ F


def _embedding_spectrum(Nx, Ny, hx, hy, r):
    """Real FFT spectrum (NumPy, float64) of the Gaussian covariance on the
    doubled periodic grid; negative eigenvalues clipped to zero."""
    Mx, My = 2 * Nx, 2 * Ny
    ix = np.minimum(np.arange(Mx), Mx - np.arange(Mx)) * hx
    iy = np.minimum(np.arange(My), My - np.arange(My)) * hy
    d = np.sqrt(ix[:, None] ** 2 + iy[None, :] ** 2)
    a = 1.0 / 3.0
    C = np.exp(-(d**2) / r**2 / a)
    S = np.maximum(np.fft.fft2(C).real, 0.0)
    return S, (Mx, My)


def gaussian_fields_fft(grid, N=1, r=0.2, generator=None, noise=None, dtype=None,
                        device="cuda", key=None):
    """N unit-variance Gaussian fields on a regular `Grid2D`, flattened to
    (N, Nxy): Re(DFT2(sqrt(S/M) * (zr + i zi))) cropped to the grid.

    The white noise (zr, zi), each (N, 2Nx, 2Ny) standard normal, is given
    as `noise`, or drawn from a `prng` `key` as the JAX package draws it
    (split in two, one float32 normal each), or from `generator`."""
    dtype = dtype or torch.get_default_dtype()
    S, (Mx, My) = _embedding_spectrum(grid.Nx, grid.Ny, grid.hx, grid.hy, r)
    amp = torch.as_tensor(np.sqrt(S / (Mx * My)), dtype=dtype, device=device)
    if noise is None and key is not None:
        noise = tuple(prng.normal(k, (N, Mx, My)) for k in prng.split(key))
    if noise is None:
        zr = torch.randn((N, Mx, My), generator=generator, dtype=dtype, device=device)
        zi = torch.randn((N, Mx, My), generator=generator, dtype=dtype, device=device)
    else:
        zr, zi = (torch.as_tensor(z, dtype=dtype, device=device) for z in noise)
    fields = torch.fft.fft2(torch.complex(amp * zr, amp * zi)).real
    return fields[:, : grid.Nx, : grid.Ny].reshape(N, grid.Nxy)


def gaussian_fields(pts, N=1, r=0.2, generator=None, grid=None, noise=None, dtype=None,
                    device="cuda"):
    """N stationary unit-variance Gaussian fields: on a regular `grid` by
    the FFT sampler (`noise` its white noise), else on the points `pts` by
    the dense sampler (`noise` its Z)."""
    if grid is not None:
        return gaussian_fields_fft(grid, N=N, r=r, generator=generator, noise=noise,
                                   dtype=dtype, device=device)
    return gaussian_fields_dense(pts, N=N, r=r, generator=generator, Z=noise, dtype=dtype,
                                 device=device)


def sample_prior_perm(generator, model, N, r=0.8, noise=None, dtype=None, device=None):
    """Prior pre-permeability fields for a model or grid (N, Nxy), on the
    model's device, or for a grid on `device` (the card by default)."""
    grid = getattr(model, "grid", model)
    if device is None:
        device = model.K.device if hasattr(model, "K") else "cuda"
    return gaussian_fields(grid.mesh, N=N, r=r, generator=generator, grid=grid, noise=noise,
                           dtype=dtype, device=device)
