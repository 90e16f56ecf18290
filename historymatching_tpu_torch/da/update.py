"""Ensemble analysis updates (PyTorch counterpart of
`historymatching_tpu.da.update`): the stochastic ES update, its localized
forms (per cell, and batched over domains), the iterative ensemble
smoother (IES) and ES-MDA.

Rows are members. The Kalman term takes the observation-space form when
p <= N and the ensemble-space (Woodbury) form otherwise. Products run in
full float32 (TF32 off, see the package's `__init__`).
"""

from __future__ import annotations

import time

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
    X, S, D = _innovation_terms(prior_ens, obs_ens, obs, perturbs, decorr)
    return prior_ens + _kalman_term(S, D, X)


def _taper_weights(taper):
    """Squared taper with the reference's activation cutoff
    (sqrt(taper) > 1e-2, i.e. taper > 1e-4)."""
    return torch.where(taper > 1e-4, taper, 0.0)


def _innovation_terms(prior_ens, obs_ens, obs, perturbs, decorr):
    """(X, S, D): prior anomalies, whitened obs anomalies and whitened
    innovations."""
    X, _ = center(prior_ens)
    Y, _ = center(obs_ens)
    return X, Y @ decorr, (obs - obs_ens - perturbs) @ decorr


def ens_update0_loc(prior_ens, obs_ens, obs, perturbs, decorr, taper):
    """Localized ES, one analysis per state element: `taper` (M, p) weights
    obs j for element i, so every element is a domain of its own
    (`ens_update0_loc_domains`). All M systems (N x N, or p x p when
    p <= N) are held at once, so it is for small M and N; the domain form
    is the one for the flagship scale."""
    M = prior_ens.shape[1]
    return ens_update0_loc_domains(prior_ens, obs_ens, obs, perturbs, decorr, taper,
                                   torch.arange(M, device=prior_ens.device)[:, None])


def ens_update0_loc_domains(prior_ens, obs_ens, obs, perturbs, decorr, taper_dom, domains):
    """Localized ES batched over domains: the cells of a domain share one
    taper row of `taper_dom` (nDom, p), so a domain takes one solve.
    `domains` (nDom, cells a domain) holds flat cell indices covering every
    cell once (`localization.domain_partition`). All domains' systems are
    solved in one batch.

    p <= N: the observation-space form, with c_d = sqrt(w_d) and
    S_d = S diag(c_d): dE_d = (D c_d) inv(S_d'S_d + (N-1) I) S_d' X_d,
    p x p systems; otherwise the ensemble-space form of `ens_update0_loc`,
    N x N systems."""
    N = prior_ens.shape[0]
    X, S, D = _innovation_terms(prior_ens, obs_ens, obs, perturbs, decorr)
    W = _taper_weights(taper_dom).to(S.dtype)  # (nDom, p)
    p = S.shape[1]
    c = N - 1.0
    domains = torch.as_tensor(domains, dtype=torch.int64, device=S.device)
    Xd = X[:, domains].permute(1, 0, 2)  # (nDom, N, k)
    if p <= N:
        cd = W.sqrt()
        Sd = S * cd[:, None, :]  # (nDom, N, p)
        G = Sd.mT @ Sd + c * torch.eye(p, dtype=S.dtype, device=S.device)
        G = 0.5 * (G + G.mT)
        dE = (D * cd[:, None, :]) @ spd_solve(G, Sd.mT @ Xd)
    else:
        G = (S * W[:, None, :]) @ S.T + c * torch.eye(N, dtype=S.dtype, device=S.device)
        G = 0.5 * (G + G.mT)
        dE = (D * W[:, None, :]) @ (S.T @ spd_solve(G, Xd))
    E_new = prior_ens.clone()
    E_new[:, domains] = prior_ens[:, domains] + dE.permute(1, 0, 2)
    return E_new


def _gn_covw(Y0, N):
    """Gauss-Newton posterior covariance of the weights, the resolvent
    inv(Y0 Y0' + (N-1) I) (the reference's SVD with excess-N zero padding,
    over the complete eigenbasis)."""
    eye = torch.eye(N, dtype=Y0.dtype, device=Y0.device)
    G = Y0 @ Y0.T
    G = 0.5 * (G + G.T) + (N - 1.0) * eye
    return spd_solve(G, eye)


def _ies_inner(W, Eo_w, y_w, D_w, xStep):
    """One IES Gauss-Newton step in the N x N weight matrix W. The
    pseudo-inverse is `torch.linalg.pinv` (an SVD), where the JAX package
    iterates Ben-Israel-Cohen for want of LAPACK on its TPU."""
    N = W.shape[0]
    W0 = torch.eye(N, dtype=W.dtype, device=W.device)
    Y0 = center(torch.linalg.pinv(W))[0] @ Eo_w
    grad_y = (y_w - D_w - Eo_w) @ Y0.T
    grad_b = (N - 1.0) * (W0 - W)
    W_new = W + xStep * ((grad_y + grad_b) @ _gn_covw(Y0, N))
    # float32 safeguard: a step that overflowed or exploded (weights live in
    # about [-0.5, 1]) keeps the previous weights. Decided on the device.
    ok = torch.isfinite(W_new).all() & (W_new.abs().amax() < 1e3)
    return torch.where(ok, W_new, W)


def ies(prior_ens, obs_ens, obs, perturbs, decorr, xStep=1.0, iMax=4, callback=None):
    """Iterative ensemble smoother (subspace Gauss-Newton).

    `obs_ens` is one callable E -> observed ensemble, run once an
    iteration, or a sequence of `iMax` of them (e.g. a looser solver for
    the early iterations). Returns (posterior, {"E": (iMax, N, M), "Eo":
    (iMax, N, p)}), every iteration's ensemble and its observations.
    `callback`, if given, is called after each iteration with dict(iter,
    iMax, elapsed_s, E, Eo, W)."""
    fwd_per_iter = (list(obs_ens) if isinstance(obs_ens, (list, tuple))
                    else [obs_ens] * iMax)
    if len(fwd_per_iter) != iMax:
        raise ValueError(f"{len(fwd_per_iter)} forward operators for {iMax} IES iterations")
    y = obs @ decorr
    D = perturbs @ decorr
    X0, x0 = center(prior_ens)
    W = torch.eye(prior_ens.shape[0], dtype=prior_ens.dtype, device=prior_ens.device)
    stats = {"E": [], "Eo": []}
    t0 = time.perf_counter()
    for itr in range(iMax):
        E = x0 + W @ X0
        Eo = fwd_per_iter[itr](E).to(E.dtype)
        stats["E"].append(E)
        stats["Eo"].append(Eo)
        W = _ies_inner(W, Eo @ decorr, y, D, xStep)
        if callback is not None:
            if W.is_cuda:
                torch.cuda.synchronize(W.device)
            callback(dict(iter=itr + 1, iMax=iMax, elapsed_s=time.perf_counter() - t0,
                          E=E, Eo=Eo, W=W))
    return x0 + W @ X0, {k: torch.stack(v) for k, v in stats.items()}


def mda_alphas(n, dtype=None, device="cuda"):
    """Constant MDA inflation: alpha_i = n, sum 1/alpha = 1."""
    return torch.full((n,), float(n), dtype=dtype or torch.get_default_dtype(), device=device)


def es_mda(prior_ens, forward_obs, obs, R12, alphas, generator=None, noise=None,
           noise_dtype=torch.float32, taper=None, domains=None, taper_dom=None):
    """ES-MDA: per pass i, run the forward model and apply `ens_update0`
    with R inflated by alpha_i (perturbs * sqrt(alpha_i), decorr /
    sqrt(alpha_i)); with `domains` and `taper_dom`, the domain-batched
    localized update instead, with `taper`, the per-cell one.

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
        dec = dec0 / np.sqrt(a)
        if domains is not None:
            E = ens_update0_loc_domains(E, Eo, obs, perturbs, dec, taper_dom, domains)
        elif taper is not None:
            E = ens_update0_loc(E, Eo, obs, perturbs, dec, taper)
        else:
            E = ens_update0(E, Eo, obs, perturbs, dec)
    return E
