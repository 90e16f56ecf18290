"""Ensemble analysis updates (PyTorch counterpart of
`historymatching_tpu.da.update`): the stochastic ES update, its localized
forms (per cell, and batched over domains), the iterative ensemble
smoother (IES), its localized form (ILES, per cell or per domain) and
ES-MDA with resume.

Rows are members. The Kalman term takes the observation-space form when
p <= N and the ensemble-space (Woodbury) form otherwise. Products run in
full float32 (TF32 off, see the package's `__init__`).

Every function takes member-sharded ensembles (`parallel.mesh`), as the
JAX package's take sharded arrays, and returns them so: each rank keeps
its N/world members, the ensemble moments (S'S, S'X, the means) are each
rank's partial sums all-reduced over the mesh's group, and the small
matrices (p x p, N x N) are the same on every rank. The iterative
smoothers gather what their weights need: the prior anomalies once, the
observed ensemble each iteration. One code path serves both: without a
mesh the reductions are local.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from historymatching_tpu_torch import prng
from historymatching_tpu_torch.ops.linalg import spd_solve
from historymatching_tpu_torch.parallel.mesh import (
    as_members,
    gather_members,
    local_members,
    member_mean,
    member_mesh,
    member_rows,
    n_members,
    reduce_members,
    whole,
)
from historymatching_tpu_torch.utils import center, gaussian_noise


def decorrelator(R12):
    """Whitening operator inv(R12.T), computed on the host by NumPy in
    R12's dtype, returned on R12's device."""
    inv = np.linalg.inv(R12.detach().cpu().numpy().T)
    return torch.as_tensor(inv, dtype=R12.dtype, device=R12.device)


def _members(*xs):
    """(mesh, each of `xs` as this rank's members): the mesh of the first
    member-sharded one, None if none is."""
    mesh = next((m for m in map(member_mesh, xs) if m is not None), None)
    return mesh, tuple(local_members(x, mesh) for x in xs)


def _kalman_term(S, D, X, mesh=None):
    """D @ inv(S'S + (N-1) I) @ S' @ X on this rank's members of S, D, X.
    Observation space (p <= N): S'S and S'X in one all-reduced product.
    Ensemble space: S gathered, G = S S' + (N-1) I, and S' inv(G) X the
    all-reduced sum over members of inv(G) S's rows times X's."""
    N, p = n_members(S, mesh), S.shape[1]
    c = N - 1.0
    if p <= N:
        SX = reduce_members(S.T @ torch.cat([S, X], 1), mesh)
        C = SX[:, :p] + c * torch.eye(p, dtype=S.dtype, device=S.device)
        return D @ spd_solve(C, SX[:, p:])
    S_all = gather_members(S, mesh)
    G = S_all @ S_all.T + c * torch.eye(N, dtype=S.dtype, device=S.device)
    A = spd_solve(G, S_all)[member_rows(N, mesh)]
    return D @ reduce_members(A.T @ X, mesh)


def ens_update0(prior_ens, obs_ens, obs, perturbs, decorr):
    """Stochastic ES analysis: `obs_ens` (N, p), `obs` (p,), `perturbs`
    (N, p) drawn with the obs-error law, `decorr` the whitening matrix.
    Member-sharded inputs give a member-sharded posterior."""
    mesh, (E, Eo, pert) = _members(prior_ens, obs_ens, perturbs)
    X, S, D = _innovation_terms(E, Eo, whole(obs), pert, decorr, mesh)
    return as_members(E + _kalman_term(S, D, X, mesh), mesh)


def _taper_weights(taper):
    """Squared taper with the reference's activation cutoff
    (sqrt(taper) > 1e-2, i.e. taper > 1e-4)."""
    return torch.where(taper > 1e-4, taper, 0.0)


def _innovation_terms(E, Eo, obs, perturbs, decorr, mesh=None):
    """(X, S, D) of this rank's members: prior anomalies, whitened obs
    anomalies and whitened innovations."""
    Eo = Eo.to(E.dtype)
    X = E - member_mean(E, mesh)
    Y = Eo - member_mean(Eo, mesh)
    return X, Y @ decorr, (obs - Eo - perturbs) @ decorr


def ens_update0_loc(prior_ens, obs_ens, obs, perturbs, decorr, taper):
    """Localized ES, one analysis per state element: `taper` (M, p) weights
    obs j for element i, so every element is a domain of its own
    (`ens_update0_loc_domains`). All M systems (N x N, or p x p when
    p <= N) are held at once, so it is for small M and N; the domain form
    is the one for the flagship scale."""
    M = prior_ens.shape[1]
    return ens_update0_loc_domains(prior_ens, obs_ens, obs, perturbs, decorr, taper,
                                   torch.arange(M, device=taper.device)[:, None])


def ens_update0_loc_domains(prior_ens, obs_ens, obs, perturbs, decorr, taper_dom, domains):
    """Localized ES batched over domains: the cells of a domain share one
    taper row of `taper_dom` (nDom, p), so a domain takes one solve.
    `domains` (nDom, cells a domain) holds flat cell indices covering every
    cell once (`localization.domain_partition`). All domains' systems are
    solved in one batch.

    p <= N: the observation-space form, with c_d = sqrt(w_d) and
    S_d = S diag(c_d): dE_d = (D c_d) inv(S_d'S_d + (N-1) I) S_d' X_d,
    p x p systems, every domain's S_d'S_d and S_d'X_d one all-reduced
    product; otherwise the ensemble-space form of `ens_update0_loc`,
    N x N systems on the gathered S."""
    mesh, (E, Eo, pert) = _members(prior_ens, obs_ens, perturbs)
    X, S, D = _innovation_terms(E, Eo, whole(obs), pert, decorr, mesh)
    N, p = n_members(S, mesh), S.shape[1]
    W = _taper_weights(taper_dom).to(S.dtype)  # (nDom, p)
    c = N - 1.0
    domains = torch.as_tensor(domains, dtype=torch.int64, device=S.device)
    Xd = X[:, domains].permute(1, 0, 2)  # (nDom, rows, k)
    if p <= N:
        cd = W.sqrt()
        Sd = S * cd[:, None, :]  # (nDom, rows, p)
        GR = reduce_members(Sd.mT @ torch.cat([Sd, Xd], -1), mesh)
        G = GR[..., :p] + c * torch.eye(p, dtype=S.dtype, device=S.device)
        G = 0.5 * (G + G.mT)
        dE = (D * cd[:, None, :]) @ spd_solve(G, GR[..., p:])
    else:
        S_all = gather_members(S, mesh)
        G = (S_all * W[:, None, :]) @ S_all.T + c * torch.eye(N, dtype=S.dtype, device=S.device)
        G = 0.5 * (G + G.mT)
        A = spd_solve(G, S_all.expand(len(W), N, p))[:, member_rows(N, mesh)]
        dE = (D * W[:, None, :]) @ reduce_members(A.mT @ Xd, mesh)
    E_new = E.clone()
    E_new[:, domains] = E[:, domains] + dE.permute(1, 0, 2)
    return as_members(E_new, mesh)


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
    iMax, elapsed_s, E, Eo, W).

    A member-sharded prior stays so: the N x N weights W are the same on
    every rank (each computes them from the gathered observations), the
    prior anomalies are gathered once, and each rank forms its own rows of
    E = x0 + W X0 and runs its members forward; E, Eo, the stats and the
    posterior are member-sharded."""
    fwd_per_iter = (list(obs_ens) if isinstance(obs_ens, (list, tuple))
                    else [obs_ens] * iMax)
    if len(fwd_per_iter) != iMax:
        raise ValueError(f"{len(fwd_per_iter)} forward operators for {iMax} IES iterations")
    mesh = member_mesh(prior_ens)
    N = prior_ens.shape[0]
    rows = member_rows(N, mesh)
    y = whole(obs) @ decorr
    D = whole(perturbs) @ decorr
    X0, x0 = center(prior_ens)
    X0 = gather_members(local_members(X0, mesh), mesh)
    W = torch.eye(N, dtype=X0.dtype, device=X0.device)
    stats = {"E": [], "Eo": []}
    t0 = time.perf_counter()
    for itr in range(iMax):
        E = x0 + W[rows] @ X0
        Eo = local_members(fwd_per_iter[itr](as_members(E, mesh)), mesh).to(E.dtype)
        stats["E"].append(E)
        stats["Eo"].append(Eo)
        W = _ies_inner(W, gather_members(Eo, mesh) @ decorr, y, D, xStep)
        if callback is not None:
            if W.is_cuda:
                torch.cuda.synchronize(W.device)
            callback(dict(iter=itr + 1, iMax=iMax, elapsed_s=time.perf_counter() - t0,
                          E=as_members(E, mesh), Eo=as_members(Eo, mesh), W=W))
    return (as_members(x0 + W[rows] @ X0, mesh),
            {k: as_members(torch.stack(v), mesh, dim=1) for k, v in stats.items()})


# Bytes of N x N work arrays one batch of ILES weight matrices may take
# (about eight a matrix: factors, Gram matrix, gradient, step, new weights);
# the domains are processed in batches of this size.
ILES_BATCH_BYTES = 2 << 30


def _pinv_times(W, S):
    """pinv(W) @ S for a batch W (m, N, N) and S (N, p): a batched LU solve,
    since pinv(W) = inv(W) for a nonsingular W. A matrix whose factorization
    meets a zero pivot, or whose solve is not finite, goes through
    `torch.linalg.pinv` alone, on W's device. Returns (X (m, N, p), the
    number of matrices through pinv); finding them is one host sync."""
    LU, piv, info = torch.linalg.lu_factor_ex(W)
    X = torch.linalg.lu_solve(LU, piv, S.expand(W.shape[0], *S.shape))
    bad = (info != 0) | ~torch.isfinite(X).all(dim=(-2, -1))
    idx = bad.nonzero().squeeze(1)
    if idx.numel():
        X[idx] = torch.linalg.pinv(W[idx]) @ S
    return X, idx.numel()


def _iles_inner(Ws, Eo_w, obs_w_innov, xStep, weights):
    """One ILES Gauss-Newton step of every weight matrix Ws (M, N, N), with
    `obs_w_innov` = (obs - Eo - perturbs) @ decorr (N, p) and `weights` the
    squared taper with cutoff (M, p). Returns (new Ws, the number of
    matrices whose pseudo-inverse went through `torch.linalg.pinv`).

    Per matrix Wi with taper w, as in the JAX package: B = center(pinv(Wi))
    @ S, grad = (innov * w) B' + (N-1)(I - Wi), G = (B * w) B' + (N-1) I,
    Wi + xStep grad G^-1. Computed in batches of matrices, never one by
    one: centering rows commutes with the right product, so B =
    center(pinv(Wi) @ S) and no N x N pseudo-inverse is formed
    (`_pinv_times`); grad G^-1 is a batched Cholesky solve on grad', G
    being symmetric. A matrix whose new weights are not finite or reach
    1e3 keeps its old ones (the float32 safeguard), decided on the device."""
    M, N = Ws.shape[:2]
    S, _ = center(Eo_w)
    c = N - 1.0
    eye = torch.eye(N, dtype=Ws.dtype, device=Ws.device)
    out = torch.empty((M, N, N), dtype=Ws.dtype, device=Ws.device)
    per = max(1, ILES_BATCH_BYTES // (8 * N * N * Ws.element_size()))
    n_pinv = 0
    for lo in range(0, M, per):
        W, w = Ws[lo:lo + per], weights[lo:lo + per, None, :]
        B, n = _pinv_times(W, S)
        n_pinv += n
        B = B - B.mean(dim=-2, keepdim=True)
        G = (B * w) @ B.mT
        G = 0.5 * (G + G.mT) + c * eye
        grad = (obs_w_innov * w) @ B.mT + c * (eye - W)
        L, info = torch.linalg.cholesky_ex(G)
        W_new = W + xStep * torch.cholesky_solve(grad.mT, L).mT
        ok = ((info == 0) & torch.isfinite(W_new).all(dim=(-2, -1))
              & (W_new.abs().amax(dim=(-2, -1)) < 1e3))
        out[lo:lo + per] = torch.where(ok[:, None, None], W_new, W)
    return out, n_pinv


def _recompose(x0, X0, Ws, rows=slice(None)):
    """E[:, i] = x0[i] + Ws[i] @ X0[:, i], for the members `rows`."""
    return x0 + torch.einsum("mab,bm->am", Ws[:, rows], X0)


def _recompose_domains(x0, X0, Ws, domains, rows=slice(None)):
    """E[:, domains[d]] = x0[domains[d]] + Ws[d] @ X0[:, domains[d]], the
    domains covering every cell once, for the members `rows`."""
    M = X0.shape[1]
    Xd = X0[:, domains].permute(1, 0, 2)  # (nDom, N, k)
    Ed = x0[domains][:, None, :] + Ws[:, rows] @ Xd
    n = Ed.shape[1]
    E = X0.new_zeros((n, M))
    E[:, domains.reshape(-1)] = Ed.permute(1, 0, 2).reshape(n, -1)
    return E


def _iles_run(prior_ens, obs_ens, obs, perturbs, decorr, weights, recompose, xStep, iMax,
              callback):
    """The ILES iteration over one weight matrix a row of `weights`. On a
    mesh as `ies`: the weights on every rank, the prior anomalies gathered
    once, the observations each iteration, each rank's own rows of E."""
    mesh = member_mesh(prior_ens)
    N = prior_ens.shape[0]
    rows = member_rows(N, mesh)
    obs, perturbs = whole(obs), whole(perturbs)
    X0, x0 = center(prior_ens)
    X0 = gather_members(local_members(X0, mesh), mesh)
    Ws = torch.eye(N, dtype=X0.dtype, device=X0.device).expand(weights.shape[0], N, N)
    stats = {"E": [], "Eo": []}
    n_pinv = []
    t0 = time.perf_counter()
    for itr in range(iMax):
        E = recompose(x0, X0, Ws, rows)
        Eo = local_members(obs_ens(as_members(E, mesh)), mesh).to(E.dtype)
        stats["E"].append(E)
        stats["Eo"].append(Eo)
        Eo_all = gather_members(Eo, mesh)
        innov = (obs - Eo_all - perturbs) @ decorr
        Ws, n = _iles_inner(Ws, Eo_all @ decorr, innov, xStep, weights)
        n_pinv.append(n)
        if callback is not None:
            if Ws.is_cuda:
                torch.cuda.synchronize(Ws.device)
            callback(dict(iter=itr + 1, iMax=iMax, elapsed_s=time.perf_counter() - t0,
                          E=as_members(E, mesh), Eo=as_members(Eo, mesh), Ws=Ws))
    stats = {k: as_members(torch.stack(v), mesh, dim=1) for k, v in stats.items()}
    stats["pinv_domains"] = torch.tensor(n_pinv)
    return as_members(recompose(x0, X0, Ws, rows), mesh), stats


def iles(prior_ens, obs_ens, obs, perturbs, decorr, taper, xStep=1.0, iMax=4, callback=None):
    """Localized iterative ensemble smoother: one N x N weight matrix per
    state element, `taper` (M, p) weighting obs j for element i. `obs_ens`
    is one callable E -> observed ensemble, run once an iteration. It holds
    (M, N, N) weights, so it is for small M and N; `iles_domains` is the
    form for the flagship scale.

    Returns (posterior, stats): stats "E" (iMax, N, M) and "Eo" (iMax, N,
    p), every iteration's ensemble and its observations, and
    "pinv_domains" (iMax,), the weight matrices a step took through
    `torch.linalg.pinv` (`_iles_inner`). `callback`, if given, is called
    after each iteration with dict(iter, iMax, elapsed_s, E, Eo, Ws).
    Member-sharded as `ies`."""
    return _iles_run(prior_ens, obs_ens, obs, perturbs, decorr, _taper_weights(taper),
                     _recompose, xStep, iMax, callback)


def iles_domains(prior_ens, obs_ens, obs, perturbs, decorr, taper_dom, domains, xStep=1.0,
                 iMax=4, callback=None):
    """Domain-batched ILES: the cells of a domain share one weight matrix
    and one taper row of `taper_dom` (nDom, p); `domains` (nDom, cells a
    domain) covers every cell once (`localization.domain_partition`). The
    state is (nDom, N, N): at N=1000 and 256 domains about 1 GB in float32.
    With singleton domains (domains = arange(M)[:, None], taper_dom =
    taper) it is `iles`. Same return contract, callback and sharding as
    `iles`."""
    domains = torch.as_tensor(domains, dtype=torch.int64, device=taper_dom.device)
    recompose = lambda x0, X0, Ws, rows: _recompose_domains(x0, X0, Ws, domains,  # noqa: E731
                                                            rows)
    return _iles_run(prior_ens, obs_ens, obs, perturbs, decorr,
                     _taper_weights(taper_dom).to(prior_ens.dtype), recompose, xStep, iMax,
                     callback)


def mda_alphas(n, dtype=None, device="cuda"):
    """Constant MDA inflation: alpha_i = n, sum 1/alpha = 1."""
    return torch.full((n,), float(n), dtype=dtype or torch.get_default_dtype(), device=device)


def es_mda(prior_ens, forward_obs, obs, R12, alphas, generator=None, noise=None,
           noise_dtype=torch.float32, taper=None, domains=None, taper_dom=None, callback=None,
           start_pass=0, key=None):
    """ES-MDA: per pass i, run the forward model and apply `ens_update0`
    with R inflated by alpha_i (perturbs * sqrt(alpha_i), decorr /
    sqrt(alpha_i)); with `domains` and `taper_dom`, the domain-batched
    localized update instead, with `taper`, the per-cell one.

    `forward_obs` is one callable or a per-pass sequence of them. The
    obs-error draws (`gaussian_noise(N, p, L=R12)` in `noise_dtype`) come
    from a `prng` `key`, split once a pass as the JAX package splits its
    key (the JAX package's draws for the same key), or from `generator`;
    or they are given per pass as `noise`: a sequence of (N, p) draws
    already multiplied by R12.

    `callback`, if given, is called after each pass with dict(pass_,
    n_passes, alpha, elapsed_s, E, generator_state, key): `E` is the
    updated ensemble, `generator_state` `generator.get_state()` after the
    pass's draw (None unless the draws come from a generator) and `key`
    the key for the remaining passes (None without a key), which is what a
    resume needs (`checkpoint.save_checkpoint` them). `start_pass` skips
    the first passes without drawing: continuing from a pass-k callback's
    `E` with its generator state or key and start_pass=k matches the
    uninterrupted run bit for bit. Without a key, a generator or `noise`
    the draws come from `prng.PRNGKey(0)`.

    A member-sharded prior stays so through every pass (the callback's
    `E` and the posterior too): each rank draws every pass's whole (N, p)
    block and keeps its own rows, so the draws are those of the run
    without a mesh.
    """
    mesh = member_mesh(prior_ens)
    E = prior_ens
    dtype = E.dtype
    R12 = whole(R12).to(dtype)
    N, p = E.shape[0], R12.shape[0]
    dec0 = decorrelator(R12)
    fwd_per_pass = (list(forward_obs) if isinstance(forward_obs, (list, tuple))
                    else [forward_obs] * len(alphas))
    if len(fwd_per_pass) != len(alphas):
        raise ValueError(f"{len(fwd_per_pass)} forward operators for {len(alphas)} MDA passes")
    if noise is not None and len(noise) != len(alphas):
        raise ValueError(f"{len(noise)} noise draws for {len(alphas)} MDA passes")
    if key is None and generator is None and noise is None:
        key = prng.PRNGKey(0, device=R12.device)
    t0 = time.perf_counter()
    for i, (a, fwd) in enumerate(zip(alphas, fwd_per_pass)):
        if i < start_pass:
            continue
        a = float(a)
        Eo = fwd(E)
        if key is not None:
            key, sub = prng.split(key)
            draw = gaussian_noise(N, p, L=R12.to(noise_dtype), key=sub, mesh=mesh)
        elif noise is None:
            draw = gaussian_noise(N, p, L=R12.to(noise_dtype), generator=generator, mesh=mesh)
        else:
            draw = noise[i]
            if not isinstance(draw, torch.Tensor):
                draw = torch.from_numpy(np.array(draw))
        draw = local_members(draw, mesh).to(device=R12.device, dtype=dtype)
        perturbs = as_members(np.sqrt(a) * draw, mesh)
        dec = dec0 / np.sqrt(a)
        if domains is not None:
            E = ens_update0_loc_domains(E, Eo, obs, perturbs, dec, taper_dom, domains)
        elif taper is not None:
            E = ens_update0_loc(E, Eo, obs, perturbs, dec, taper)
        else:
            E = ens_update0(E, Eo, obs, perturbs, dec)
        if callback is not None:
            if R12.is_cuda:
                torch.cuda.synchronize(R12.device)
            drawn = key is None and noise is None and generator is not None
            callback(dict(pass_=i + 1, n_passes=len(fwd_per_pass), alpha=a,
                          elapsed_s=time.perf_counter() - t0, E=E, key=key,
                          generator_state=generator.get_state() if drawn else None))
    return E
