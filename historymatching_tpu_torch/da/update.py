"""Ensemble analysis updates on the main path: the stochastic ES update and
ES-MDA (PyTorch counterpart of `historymatching_tpu.da.update`).

Rows are members. The Kalman term takes the observation-space form when
p <= N and the ensemble-space (Woodbury) form otherwise. Products run in
full float32 (TF32 off, see the package's `__init__`).
"""

from __future__ import annotations

import numpy as np
import torch

from historymatching_tpu_torch.ops.linalg import spd_solve
from historymatching_tpu_torch.utils import center, gaussian_noise


def decorrelator(R12):
    """Whitening operator inv(R12.T), computed on the host by NumPy in
    R12's dtype, returned on R12's device."""
    inv = np.linalg.inv(R12.detach().cpu().numpy().T)
    return torch.as_tensor(inv, dtype=R12.dtype, device=R12.device)


def _kalman_term(S, D, X):
    """D @ inv(S'S + (N-1) I) @ S' @ X."""
    N, p = S.shape
    c = N - 1.0
    if p <= N:
        C = S.T @ S + c * torch.eye(p, dtype=S.dtype, device=S.device)
        return D @ spd_solve(C, S.T @ X)
    G = S @ S.T + c * torch.eye(N, dtype=S.dtype, device=S.device)
    return (D @ S.T) @ spd_solve(G, X)


def ens_update0(prior_ens, obs_ens, obs, perturbs, decorr):
    """Stochastic ES analysis: `obs_ens` (N, p), `obs` (p,), `perturbs`
    (N, p) drawn with the obs-error law, `decorr` the whitening matrix."""
    X, _ = center(prior_ens)
    Y, _ = center(obs_ens)
    S = Y @ decorr
    D = (obs - obs_ens - perturbs) @ decorr
    return prior_ens + _kalman_term(S, D, X)


def mda_alphas(n, dtype=None, device="cuda"):
    """Constant MDA inflation: alpha_i = n, sum 1/alpha = 1."""
    return torch.full((n,), float(n), dtype=dtype or torch.get_default_dtype(), device=device)


def es_mda(prior_ens, forward_obs, obs, R12, alphas, generator=None, noise=None,
           noise_dtype=torch.float32):
    """ES-MDA: per pass i, run the forward model and apply `ens_update0`
    with R inflated by alpha_i (perturbs * sqrt(alpha_i), decorr /
    sqrt(alpha_i)).

    `forward_obs` is one callable or a per-pass sequence of them. The
    obs-error draws come from `generator` (`gaussian_noise(N, p, L=R12)` in
    `noise_dtype`), or are given per pass as `noise`: a sequence of (N, p)
    draws already multiplied by R12, e.g. exactly what the JAX package
    draws for the same key.
    """
    E = prior_ens
    dtype = E.dtype
    R12 = R12.to(dtype)
    N, p = E.shape[0], R12.shape[0]
    dec0 = decorrelator(R12)
    fwd_per_pass = (list(forward_obs) if isinstance(forward_obs, (list, tuple))
                    else [forward_obs] * len(alphas))
    if len(fwd_per_pass) != len(alphas):
        raise ValueError(f"{len(fwd_per_pass)} forward operators for {len(alphas)} MDA passes")
    if noise is not None and len(noise) != len(alphas):
        raise ValueError(f"{len(noise)} noise draws for {len(alphas)} MDA passes")
    for i, (a, fwd) in enumerate(zip(alphas, fwd_per_pass)):
        a = float(a)
        Eo = fwd(E).to(dtype)
        if noise is None:
            draw = gaussian_noise(N, p, L=R12.to(noise_dtype), generator=generator)
        else:
            draw = noise[i]
            if not isinstance(draw, torch.Tensor):
                draw = torch.from_numpy(np.array(draw))
        perturbs = np.sqrt(a) * draw.to(device=E.device, dtype=dtype)
        E = ens_update0(E, Eo, obs, perturbs, dec0 / np.sqrt(a))
    return E
