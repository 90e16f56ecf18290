"""Exact float64 oracle forward model (PyTorch counterpart of
`historymatching_tpu.models.oracle`).

The float64 reference of the parity harness: each step's pinned TPFA
pressure system, assembled from the same `transmissibilities` and
`stencil_diag` as the matrix-free path, is solved exactly (to float64
rounding) by a banded Cholesky factorization (`ops.banded.banded_solve`:
the hand-written kernel on the card, its plain version on the CPU, where
the JAX package calls LAPACK `dpbsv` through `scipy.linalg.solveh_banded`
member by member). Everything else is the simulator's own code, batched
over members, in float64: mobilities, sources, face fluxes, the CFL count
and the plain upwind transport (`ops.transport.transport_substeps_torch`;
the JAX oracle likewise runs XLA's transport, not its Pallas kernel).

Every function follows its tensors' device. The oracle has no solver
settings: `forward_oracle` accepts and ignores the simulator's keywords,
so one keyword dict serves both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from historymatching_tpu_torch.models.ressim import (
    ResSim,
    _rates_seq,
    _source_field,
    cfl_substeps,
    relperm,
)
from historymatching_tpu_torch.ops.banded import banded_solve
from historymatching_tpu_torch.ops.stencil import face_fluxes, stencil_diag, transmissibilities
from historymatching_tpu_torch.ops.transport import transport_substeps_torch
from historymatching_tpu_torch.utils import as_float, atleast_2d


def banded_operator(TX, TY, diag):
    """LAPACK upper band storage of the pinned TPFA operator, for any
    leading member axes: (..., Ny+1, Nx*Ny) in the
    `scipy.linalg.solveh_banded` convention ab[u + i - j, j] = A[i, j]
    (u = Ny). Flat order j = ix*Ny + iy, so the y-neighbour coupling -TY
    sits at offset 1 and the x-neighbour coupling -TX at offset Ny; the
    rows between are structurally zero."""
    Nx, Ny = diag.shape[-2:]
    lead = diag.shape[:-2]
    ab = diag.new_zeros(*lead, Ny + 1, Nx * Ny)
    ab[..., Ny, :] = diag.reshape(*lead, -1)
    # A[j-1, j] = -TY[ix, iy-1] for iy >= 1 (none across the iy=0 seam)
    ab[..., Ny - 1, :] = -F.pad(TY, (1, 0)).reshape(*lead, -1)
    # A[j-Ny, j] = -TX[ix-1, iy] for ix >= 1
    ab[..., 0, :] = -F.pad(TX, (0, 0, 1, 0)).reshape(*lead, -1)
    return ab


def banded_matvec(ab, x):
    """y = A @ x from the band storage, for any leading member axes of `ab`;
    `x` holds n values a member, flat or on the grid."""
    u = ab.shape[-2] - 1
    x = x.reshape(*ab.shape[:-2], -1)
    y = ab[..., u, :] * x
    for k in range(1, u + 1):
        band = ab[..., u - k, k:]  # A[j-k, j] for j >= k
        y[..., :-k] += band * x[..., k:]
        y[..., k:] += band * x[..., :-k]
    return y


def simulate_oracle(model: ResSim, K_ens, wsat0, dt, nTime, max_substeps=4096, solve=None):
    """Run nTime steps for a batch of members with exact pressure solves.

    K_ens: (N, 2, Nx, Ny) transformed permeabilities, float64; wsat0: (Nxy,)
    shared or (N, Nxy) per-member initial saturations. Returns (wsats_last
    (N, 1, Nxy), sats (N, nTime, Nxy)) in float64 on K_ens's device.
    `solve(ab, q)`: the banded solve (default `ops.banded.banded_solve`;
    its plain version on the card holds the kernel's run to it)."""
    solve = banded_solve if solve is None else solve
    g = model.grid
    assert K_ens.dtype == torch.float64, "the oracle is a float64 reference"
    dev, f64 = K_ens.device, torch.float64
    N = K_ens.shape[0]
    wsat0 = as_float(wsat0, f64, dev)
    s = wsat0.expand(N, g.Nxy).reshape(N, g.Nx, g.Ny)
    inj_seq = _rates_seq(model.inj_rates, nTime).to(dev, f64)
    prd_seq = _rates_seq(model.prd_rates, nTime).to(dev, f64)
    fl = model.fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)

    sats = []
    for t in range(nTime):
        Mw, Mo = relperm(s, fl)
        mob = Mw + Mo
        TX, TY = transmissibilities(K_ens[:, 0] * mob, K_ens[:, 1] * mob, g.hx, g.hy)
        diag = stencil_diag(TX, TY)  # pinned at cell (0, 0) with the mean diagonal
        q = _source_field(model, inj_seq[t], prd_seq[t])
        q = q.reshape(-1, g.Nx, g.Ny)  # one field, or one a member
        p = solve(banded_operator(TX, TY, diag), q.reshape(-1, g.Nxy).expand(N, g.Nxy))
        Fx, Fy = face_fluxes(TX, TY, p.reshape(N, g.Nx, g.Ny))
        n_sub, dts_pv = cfl_substeps(model, Fx, Fy, q, dt, max_substeps)
        s = transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid)
        sats.append(s.reshape(N, -1))
    sats = torch.stack(sats, dim=1)
    return sats[:, -1:, :], sats


def forward_oracle(model: ResSim, perm_ens, wsat0=None, dt=0.025, nTime=40, *, transf=None,
                   keep_wsats=False, solve=None, **_ignored):
    """Drop-in for `parallel.runner.forward_model(keep_wsats=False)` on the
    float64 oracle path: (N, Nxy) pre-permeability fields -> (final_state
    (N, 1, Nxy), prods (N, nTime, nPrd)); with `keep_wsats`, every state
    from the initial one, (N, nTime+1, Nxy). The fields are taken in
    float64 on their device (a non-tensor on the model's).

    Extra solver keywords are accepted and ignored (the direct solve has no
    tuning knobs), so call sites can pass a common keyword dict; `solve`
    goes to `simulate_oracle`."""
    from historymatching_tpu_torch.parallel.runner import perm_transf, prod_inds

    if transf is None:
        transf = perm_transf
    dev = perm_ens.device if isinstance(perm_ens, torch.Tensor) else model.K.device
    perm_ens = atleast_2d(as_float(perm_ens, torch.float64, dev))
    N = perm_ens.shape[0]
    g = model.grid
    if wsat0 is None:
        wsat0 = torch.zeros(g.Nxy, dtype=torch.float64, device=dev)
    P = transf(perm_ens).reshape(N, g.Nx, g.Ny)
    K_ens = torch.stack([P, P], dim=1)  # (N, 2, Nx, Ny): both directions
    last, sats = simulate_oracle(model, K_ens, wsat0, dt, nTime, solve=solve)
    prods = sats[:, :, prod_inds(model).to(dev)]  # (N, nTime, nPrd)
    if keep_wsats:
        w0 = as_float(wsat0, torch.float64, dev).expand(N, g.Nxy)[:, None, :]
        return torch.cat([w0, sats], dim=1), prods
    return last, prods
