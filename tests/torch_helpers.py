"""Shared inputs for the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py). Inputs are made with NumPy from a seed and
handed to both sides as arrays."""

import numpy as np
import torch

from tests.test_sim import default_model  # noqa: F401  (shared with the test modules)


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def rel_err(a, b):
    """max |a - b| / max |b|, both as NumPy arrays."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def perm_fields(seed, N, Nxy, scale=0.5):
    """Pre-permeability fields. A moderate scale keeps every member's f64
    solve well above its rounding floor, so iteration counts are exact
    (near the floor, the stagnation exit turns on rounding)."""
    return scale * np.random.default_rng(seed).normal(size=(N, Nxy))


def scaled_system(perm, m, s=None):
    """The Jacobi-scaled TPFA operator of pressure_step for fields `perm`
    (N, Nxy) on model `m`: (TXs, TYs, ones, sqrt(diag), rsqrt(diag)) as
    float64 NumPy, computed in NumPy so neither side builds the other's."""
    g = m.grid
    N = perm.shape[0]
    K = 0.1 + np.exp(np.minimum(5.0 * perm, 80.0)).reshape(N, *g.shape)
    mob = 1.0 if s is None else (s**2 + (1 - s) ** 2)
    Kx = K * mob
    TX = (2.0 * g.hy / g.hx) / (1.0 / Kx[:, :-1] + 1.0 / Kx[:, 1:])
    TY = (2.0 * g.hx / g.hy) / (1.0 / Kx[:, :, :-1] + 1.0 / Kx[:, :, 1:])
    diag = np.zeros((N, *g.shape))
    diag[:, :-1] += TX
    diag[:, 1:] += TX
    diag[:, :, :-1] += TY
    diag[:, :, 1:] += TY
    diag[:, 0, 0] += diag.mean(axis=(1, 2))
    sd = 1.0 / np.sqrt(diag)
    TXs = TX * sd[:, :-1] * sd[:, 1:]
    TYs = TY * sd[:, :, :-1] * sd[:, :, 1:]
    return TXs, TYs, np.ones_like(diag), diag * sd, sd

