"""Ensemble forward-model runner (PyTorch counterpart of
`historymatching_tpu.parallel.runner`).

The member axis is the leading tensor axis all the way down: one
`simulate` call advances every member, and each kernel launch covers the
whole ensemble (one thread block per member). With a `mesh`
(`parallel.mesh.ens_mesh`), each rank runs its block of members on its own
device with no communication, as JAX's `shard_map` does. Members that came
in member-sharded go out member-sharded, as the JAX package keeps them;
members every rank holds whole come back all-gathered in member order.
"""

from __future__ import annotations

import torch

from historymatching_tpu_torch.models.ressim import ResSim, SimResult, simulate
from historymatching_tpu_torch.parallel.mesh import (
    as_members,
    gather_members,
    local_members,
    member_map,
    member_mesh,
    whole,
)


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
                  mesh=None, keep_wsats=True, p_init=None, keep_pressures=False,
                  return_sim=False, chunk=None, **sim_kwargs):
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

    `chunk`: run the members in batches of `chunk`, as the JAX package does
    on one device: members ordered by their field's largest pre-permeability,
    descending (a stable sort), so the hard ones share batches; the outputs
    come back in the input order. Each member's result is its own, so it
    equals the unchunked run's.

    `mesh` (`parallel.mesh.ens_mesh`): the members are split over its
    ranks (N must be divisible by the mesh size). `perm_ens`, and `wsat0`
    and `p_init` where they carry a member axis, are member-sharded
    DTensors (`shard_ens`) or tensors every rank holds whole; a shared
    `wsat0` is replicated. Each rank runs its members as above, with no
    communication. A member-sharded `perm_ens` gives member-sharded
    outputs (and `SimResult` member fields): each rank keeps its members'
    results. A `perm_ens` every rank holds whole gives outputs all-gathered
    in member order, plain tensors equal to the run without a mesh. A
    member-sharded `perm_ens` without `mesh` runs on its own mesh.
    """
    mesh = mesh if mesh is not None else member_mesh(perm_ens)
    if mesh is not None:
        return _forward_sharded(model, perm_ens, wsat0, dt, nTime, mesh, transf=transf,
                                keep_wsats=keep_wsats, p_init=p_init,
                                keep_pressures=keep_pressures, return_sim=return_sim,
                                chunk=chunk, **sim_kwargs)
    perm_ens = perm_ens.reshape(1, -1) if perm_ens.ndim == 1 else perm_ens
    if wsat0 is None:
        wsat0 = torch.zeros(model.Nxy, dtype=perm_ens.dtype, device=perm_ens.device)
    N = perm_ens.shape[0]
    if chunk is not None and chunk < N:
        order = torch.sort(perm_ens.amax(dim=1), descending=True, stable=True).indices
        inv = torch.argsort(order)
        parts = []
        for i in range(0, N, chunk):
            idx = order[i:i + chunk]
            parts.append(forward_model(
                model, perm_ens[idx], wsat0[idx] if wsat0.ndim == 2 else wsat0, dt, nTime,
                transf=transf, keep_wsats=keep_wsats,
                p_init=None if p_init is None else p_init[idx], keep_pressures=keep_pressures,
                return_sim=return_sim, **sim_kwargs))
        return tuple(_merge([part[k] for part in parts], inv)
                     for k in range(len(parts[0])))
    res = simulate(set_perm(model, perm_ens, transf), wsat0, dt, nTime,
                   keep_wsats=keep_wsats, p_init=p_init, keep_pressures=keep_pressures,
                   **sim_kwargs)
    out = (res.wsats if keep_wsats else res.wsats[:, -1:], res.prd_sats)
    out += (res.pressures,) if keep_pressures else ()
    return out + (res,) if return_sim else out


def _forward_sharded(model, perm_ens, wsat0, dt, nTime, mesh, p_init=None, **kw):
    """`forward_model` on `mesh`: this rank's members, then the outputs
    member-sharded if the members came in so, else gathered."""
    keep = member_mesh(perm_ens) is not None
    perm_ens = perm_ens.reshape(1, -1) if perm_ens.ndim == 1 else perm_ens
    N, n = perm_ens.shape[0], mesh.size()
    if N % n:
        raise ValueError(f"N={N} not divisible by mesh size {n}")
    perm = local_members(perm_ens, mesh)
    if wsat0 is not None:
        wsat0 = local_members(wsat0, mesh) if wsat0.ndim == 2 else whole(wsat0)
    if p_init is not None:
        p_init = local_members(p_init, mesh)
    out = forward_model(model, perm, wsat0, dt, nTime, p_init=p_init, **kw)

    members = (lambda t: as_members(t, mesh)) if keep else (  # noqa: E731
        lambda t: gather_members(t, mesh))

    def join(x):
        if isinstance(x, SimResult):
            return x._replace(**{k: members(getattr(x, k)) for k in _MEMBER_FIELDS
                                 if isinstance(getattr(x, k), torch.Tensor)})
        return members(x)

    return tuple(join(x) for x in out)


def _merge(parts, inv):
    """Chunks' outputs in the input order: tensors are joined on their
    member axis and reordered; a `SimResult` field by field, where the
    fields of the wells and rates, which every member shares here, come
    from the first chunk."""
    first = parts[0]
    if isinstance(first, SimResult):
        return first._replace(**{k: _merge([getattr(p, k) for p in parts], inv)
                                 for k in _MEMBER_FIELDS if isinstance(getattr(first, k),
                                                                       torch.Tensor)})
    return torch.cat(parts)[inv]


_MEMBER_FIELDS = ("wsats", "cg_ok", "cg_iters", "substeps", "pressures", "prd_sats",
                  "recooked")


def ensemble_simulate(model, perm_ens, wsat0=None, dt=0.025, nTime=40, **kw):
    """Alias of `forward_model`, the package's preferred name."""
    return forward_model(model, perm_ens, wsat0, dt, nTime, **kw)


def obs_ens_fn(model, dt, nTime, wsat0=None, mesh=None, nTime_axis_flat=True, **sim_kwargs):
    """The `obs_ens` callable for ES-MDA: ensemble -> production series,
    flattened to (N, nTime * nPrd), or (N, nTime, nPrd) without
    `nTime_axis_flat`; with `mesh`, or a member-sharded ensemble, the
    members split over its ranks (`forward_model`)."""

    def fn(E):
        _, prods = forward_model(model, E, wsat0, dt, nTime, mesh=mesh, keep_wsats=False,
                                 **sim_kwargs)
        return member_map(lambda p: p.reshape(p.shape[0], -1), prods) if nTime_axis_flat \
            else prods

    return fn
