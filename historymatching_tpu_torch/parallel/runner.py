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
                  keep_wsats=True, p_init=None, keep_pressures=False, return_sim=False,
                  **sim_kwargs):
    """Run the ensemble forward model on the device of `perm_ens`.

    `perm_ens` (N, Nxy) pre-permeability fields; `wsat0` one shared state
    (Nxy,) or per-member states (N, Nxy). Returns (wsats (N, nTime+1, Nxy),
    or (N, 1, Nxy) final states without `keep_wsats`; prods (N, nTime, nPrd)).
    `p_init` (N, nTime, Nxy) warm-starts every step's pressure solve (see
    `simulate`); with `keep_pressures` the (N, nTime, Nxy) pressure
    trajectories follow as a third element, to feed the next pass as its
    `p_init`. With `return_sim`, the `SimResult` (solver and substep
    statistics) comes last. Other keywords (`smoother`, `precond`, the
    solver settings) go to `simulate`.
    """
    perm_ens = perm_ens.reshape(1, -1) if perm_ens.ndim == 1 else perm_ens
    if wsat0 is None:
        wsat0 = torch.zeros(model.Nxy, dtype=perm_ens.dtype, device=perm_ens.device)
    res = simulate(set_perm(model, perm_ens, transf), wsat0, dt, nTime,
                   keep_wsats=keep_wsats, p_init=p_init, keep_pressures=keep_pressures,
                   **sim_kwargs)
    out = (res.wsats if keep_wsats else res.wsats[:, -1:], res.prd_sats)
    out += (res.pressures,) if keep_pressures else ()
    return out + (res,) if return_sim else out


def ensemble_simulate(model, perm_ens, wsat0=None, dt=0.025, nTime=40, **kw):
    """Alias of `forward_model`, the package's preferred name."""
    return forward_model(model, perm_ens, wsat0, dt, nTime, **kw)


def obs_ens_fn(model, dt, nTime, wsat0=None, **sim_kwargs):
    """The `obs_ens` callable for ES-MDA: ensemble -> flattened production
    series (N, nTime * nPrd)."""

    def fn(E):
        _, prods = forward_model(model, E, wsat0, dt, nTime, keep_wsats=False, **sim_kwargs)
        return prods.reshape(prods.shape[0], -1)

    return fn
