"""Gaussian random-field priors (PyTorch counterpart of the circulant-
embedding sampler in `historymatching_tpu.da.geostat`).

The JAX package evaluates the 2D DFT as matmuls because its TPU backend
has no FFT; here it is `torch.fft.fft2`.
"""

from __future__ import annotations

import numpy as np
import torch


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
                        device="cuda"):
    """N unit-variance Gaussian fields on a regular `Grid2D`, flattened to
    (N, Nxy): Re(DFT2(sqrt(S/M) * (zr + i zi))) cropped to the grid.

    The white noise (zr, zi), each (N, 2Nx, 2Ny) standard normal, is drawn
    from `generator` unless given as `noise`."""
    dtype = dtype or torch.get_default_dtype()
    S, (Mx, My) = _embedding_spectrum(grid.Nx, grid.Ny, grid.hx, grid.hy, r)
    amp = torch.as_tensor(np.sqrt(S / (Mx * My)), dtype=dtype, device=device)
    if noise is None:
        zr = torch.randn((N, Mx, My), generator=generator, dtype=dtype, device=device)
        zi = torch.randn((N, Mx, My), generator=generator, dtype=dtype, device=device)
    else:
        zr, zi = (torch.as_tensor(z, dtype=dtype, device=device) for z in noise)
    fields = torch.fft.fft2(torch.complex(amp * zr, amp * zi)).real
    return fields[:, : grid.Nx, : grid.Ny].reshape(N, grid.Nxy)


def sample_prior_perm(generator, model, N, r=0.8, noise=None, dtype=None, device=None):
    """Prior pre-permeability fields for a model or grid (N, Nxy), on the
    model's device, or for a grid on `device` (the card by default)."""
    grid = getattr(model, "grid", model)
    if device is None:
        device = model.K.device if hasattr(model, "K") else "cuda"
    return gaussian_fields_fft(grid, N=N, r=r, generator=generator, noise=noise,
                               dtype=dtype, device=device)
