"""Ensemble forward-model runner (PyTorch counterpart of
`historymatching_tpu.parallel.runner`, single device).

The member axis is the leading tensor axis all the way down: one
`simulate` call advances every member, and each kernel launch covers the
whole ensemble (one thread block per member).
"""

from __future__ import annotations

import torch

from historymatching_tpu_torch.models.ressim import ResSim, simulate


def perm_transf(x):
    """Pre-permeability transform 0.1 + exp(5 x), exponent capped at 80 so
    float32 never overflows to inf."""
    return 0.1 + torch.exp(torch.clamp_max(5.0 * x, 80.0))


def set_perm(model: ResSim, log_perm_array, transf=perm_transf):
    """Apply (pre-)permeability fields (..., Nxy) to both K components."""
    p = transf(log_perm_array).reshape(*log_perm_array.shape[:-1], *model.shape)
    return model.replace(K=torch.stack([p, p], dim=-3))


def prod_inds(model: ResSim):
    """Producer cell indices: the observation operator's gather targets."""
    return model.xy2ind(model.prd_xy[..., 0], model.prd_xy[..., 1])


def forward_model(model, perm_ens, wsat0=None, dt=0.025, nTime=40, *, transf=perm_transf,
                  keep_wsats=True, return_sim=False, **sim_kwargs):
    """Run the ensemble forward model on the device of `perm_ens`.

    `perm_ens` (N, Nxy) pre-permeability fields; `wsat0` one shared state
    (Nxy,) or per-member states (N, Nxy). Returns (wsats (N, nTime+1, Nxy),
    or (N, 1, Nxy) final states without `keep_wsats`; prods (N, nTime, nPrd)).
    With `return_sim`, the `SimResult` (solver and substep statistics)
    follows as a third element.
    """
    perm_ens = perm_ens.reshape(1, -1) if perm_ens.ndim == 1 else perm_ens
    if wsat0 is None:
        wsat0 = torch.zeros(model.Nxy, dtype=perm_ens.dtype, device=perm_ens.device)
    res = simulate(set_perm(model, perm_ens, transf), wsat0, dt, nTime,
                   keep_wsats=keep_wsats, **sim_kwargs)
    wsats = res.wsats if keep_wsats else res.wsats[:, -1:]
    return (wsats, res.prd_sats, res) if return_sim else (wsats, res.prd_sats)


def obs_ens_fn(model, dt, nTime, wsat0=None, **sim_kwargs):
    """The `obs_ens` callable for ES-MDA: ensemble -> flattened production
    series (N, nTime * nPrd)."""

    def fn(E):
        _, prods = forward_model(model, E, wsat0, dt, nTime, keep_wsats=False, **sim_kwargs)
        return prods.reshape(prods.shape[0], -1)

    return fn
