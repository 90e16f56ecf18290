"""Ensemble linear-algebra utilities (PyTorch counterpart of
`historymatching_tpu.utils`). Rows are members; random draws come from an
explicit `torch.Generator`, from a `prng` key (the JAX package's draws),
or are handed in."""

from __future__ import annotations

import numpy as np
import torch

from historymatching_tpu_torch import prng


def as_float(x, dtype=None, device=None):
    """A floating tensor; an existing floating dtype is kept unless `dtype`."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    if dtype is None and not t.is_floating_point():
        dtype = torch.get_default_dtype()
    return t.to(dtype=dtype or t.dtype, device=device)


def atleast_2d(t):
    return t.reshape(1, -1) if t.ndim < 2 else t


def center(E, dim=0):
    """Subtract the ensemble mean; return (anomalies, mean)."""
    x = E.mean(dim=dim, keepdim=True)
    return E - x, x.squeeze(dim)


def cov(a, b):
    """Cross-covariance of two samples sharing the leading (ensemble) axis."""
    A, _ = center(a)
    B, _ = center(b)
    return A.T @ B / (B.shape[0] - 1)


def corr(a, b):
    """Correlation (M,) of the columns of `a` (N, M) with one series `b`
    (N,), or (M, K) with each of K series (N, K), by `cov`, clipped to
    +/-999 (an inf from a nearly constant series stays plottable)."""
    C = cov(a, b)
    sa = torch.std(a.T, dim=-1, correction=1)
    sb = torch.std(b, dim=0, correction=1, keepdim=True)
    return torch.clamp(C / (sa[:, None] if C.ndim == 2 else sa) / sb, -999, 999)


def gaussian_noise(N, M, L=1.0, generator=None, Z=None, dtype=None, device="cuda", key=None):
    """A 0-mean Gaussian ensemble (N, M): `Z @ L.T` for a Cholesky factor
    `L` (M, M), or `Z * L` for a scalar std-dev. The standard normals `Z`
    are given, or drawn from a `prng` `key` as the JAX package draws them
    (float32), or from `generator` on `device`. A matrix factor sets the
    dtype and device."""
    if isinstance(L, torch.Tensor) and L.ndim == 2:
        dtype, device = L.dtype, L.device
    dtype = dtype or torch.get_default_dtype()
    if Z is None and key is not None:
        Z = prng.normal(key, (N, M)).to(dtype=dtype, device=device)
    if Z is None:
        Z = torch.randn((N, M), generator=generator, dtype=dtype, device=device)
    if isinstance(L, torch.Tensor) and L.ndim == 2:
        return Z @ L.T
    return Z * L


def rinv(A, reg, tikh=True, nMax=None):
    """Regularized or truncated SVD pseudo-inverse: the Tikhonov spectrum
    s / (s^2 + (reg s_max)^2) with `tikh`, else 1/s above reg s_max and 0
    below; `nMax` keeps only the leading singular values."""
    U, s, VT = torch.linalg.svd(A, full_matrices=False)
    reg = reg * s[..., :1]
    if tikh:
        s1 = s / (s**2 + reg**2)
    else:
        s1 = torch.where(s >= reg, 1.0 / torch.where(s == 0, 1.0, s), 0.0)
    if nMax:
        s1 = torch.where(torch.arange(s.shape[-1], device=s.device) < nMax, s1, 0.0)
    return (VT.mT * s1[..., None, :]) @ U.mT


def svals(E, center_first=True):
    """Singular values of an (anomaly) ensemble, the prior-spectrum
    diagnostic."""
    if center_first:
        E, _ = center(E)
    return torch.linalg.svdvals(E)


def mnorm(x, axis=0):
    """Mean-based L2 norm, sqrt(mean(x^2)) along `axis`."""
    return torch.sqrt(torch.mean(x * x, axis))


def rms(x):
    """RMS over the last axis of the ensemble mean (over axis 1), per
    leading index."""
    return torch.sqrt(torch.mean(torch.mean(x, 1) ** 2, -1))


def emph(text):
    """Bold terminal text."""
    return f"\033[1m{text}\033[0m"


def split(arr, step):
    """Split `arr` into segments of length `step` (one segment if 0)."""
    if not step:
        step = max(1, len(arr))
    return [arr[i : i + step] for i in range(0, len(arr), step)]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def print_RMSMs(series: dict, ref: str):
    """Print, per series, the RMS error of its mean against `series[ref]`
    and its RMS deviation from its mean; returns {name: (err, dev)}. A
    host-side diagnostic (NumPy)."""
    x = _host(series[ref])
    if x.shape[0] != 1:
        x = x[None, :]
    header = "Series    rms err  rms dev"
    print(header, "-" * len(header), sep="\n")
    rows = {}
    for k, y in series.items():
        y = _host(y)
        if y.ndim < x.ndim:
            y = y[None, :]
        err = float(np.sqrt(np.mean((x - y.mean(0)) ** 2)))
        dev = float(np.sqrt(np.mean((y - y.mean(0)) ** 2)))
        rows[k] = (err, dev)
        print(f"{k:8}: {err:6.4f}   {dev:6.4f}")
    return rows


def pCircle(degree, Lx, Ly, p=4, norm_val=0.87):
    """(x, y) at angle `degree` on the p-norm circle, centred and scaled to
    the domain: a well-placement helper (NumPy, rounded to 2 decimals)."""
    radians = 2 * np.pi * degree / 360
    c, s = np.cos(radians), np.sin(radians)
    norm = (np.abs(c) ** p + np.abs(s) ** p) ** (1 / p)
    x = Lx / 2 * (1 + norm_val / norm * c)
    y = Ly / 2 * (1 + norm_val / norm * s)
    return np.round(x, 2), np.round(y, 2)


def mesh2list(*arrs, device="cuda"):
    """Meshgrid arrays -> (nPts, nDim) list of points."""
    return torch.stack([torch.as_tensor(a, device=device) for a in arrs], -1).reshape(-1, len(arrs))


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
