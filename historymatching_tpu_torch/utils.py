"""Ensemble linear-algebra utilities (PyTorch counterpart of
`historymatching_tpu.utils`). Rows are members; random draws come from an
explicit `torch.Generator` or are handed in."""

from __future__ import annotations

import numpy as np
import torch


def center(E, dim=0):
    """Subtract the ensemble mean; return (anomalies, mean)."""
    x = E.mean(dim=dim, keepdim=True)
    return E - x, x.squeeze(dim)


def gaussian_noise(N, M, L=1.0, generator=None, Z=None, dtype=None, device="cuda"):
    """A 0-mean Gaussian ensemble (N, M): `Z @ L.T` for a Cholesky factor
    `L` (M, M), or `Z * L` for a scalar std-dev. `Z` is drawn from
    `generator` on `device` unless the standard-normal draws are given. A
    matrix factor sets the dtype and device."""
    if isinstance(L, torch.Tensor) and L.ndim == 2:
        dtype, device = L.dtype, L.device
    dtype = dtype or torch.get_default_dtype()
    if Z is None:
        Z = torch.randn((N, M), generator=generator, dtype=dtype, device=device)
    if isinstance(L, torch.Tensor) and L.ndim == 2:
        return Z @ L.T
    return Z * L


def vect(x, nTime=None, undo=False):
    """Flatten (or, with `undo`, unflatten) the last two axes (time x space)."""
    if undo:
        if nTime is None:
            raise ValueError("vect(undo=True) requires nTime")
        *N, ab = x.shape
        return x.reshape(tuple(N) + (nTime, ab // nTime))
    *N, a, b = x.shape
    return x.reshape(tuple(N) + (a * b,))


def toeplitz(c):
    """Symmetric Toeplitz matrix from first column `c`."""
    c = torch.as_tensor(c)
    n = c.shape[0]
    idx = (torch.arange(n)[:, None] - torch.arange(n)[None, :]).abs()
    return c[idx]


def temporal_R(nTime, nPrd, variance=1e-2, length_tmp=2.0, cutoff=1e-2,
               dtype=torch.float64, device="cuda"):
    """Temporally-correlated obs-error covariance R = kron(R1well, I_nPrd):
    exponential correlation exp(-t/length_tmp) cut off below `cutoff`,
    scaled by `variance`. Returns (R, R12) with R12 the lower Cholesky
    factor. Built in float64 NumPy, then cast."""
    corrs = np.exp(-np.arange(nTime) / length_tmp)
    corrs[corrs < cutoff] = 0.0
    R1 = variance * toeplitz(torch.from_numpy(corrs)).numpy()
    R = np.kron(R1, np.eye(nPrd))
    R12 = np.linalg.cholesky(R)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return as_t(R), as_t(R12)
