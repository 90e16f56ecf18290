"""2D two-phase incompressible reservoir simulator, TPFA (PyTorch counterpart
of `historymatching_tpu.models.ressim`).

Per time step: the Jacobi-scaled TPFA pressure system is solved by
multigrid-preconditioned CG (kernel P on the card), Darcy face fluxes
follow, then explicit upwind saturation transport with CFL substepping
(kernel K on the card). Quadratic Corey relative permeabilities.

Members are a leading axis: a model whose `K` is (N, 2, Nx, Ny) simulates N
members at once, sharing grid and fluid. Wells and rates share that axis
or carry their own (N, nWell, ...), so each member may place and drive its
wells differently, as an EnOpt batch does. The time loop is a Python
loop. The `scale_system=True` path of the JAX package is ported, with the
multigrid preconditioner (Jacobi or Chebyshev smoothing, kernel P on the
card) or the plain Jacobi one (`precond="jacobi"`, torch ops). Of its
solver strategy keys `simulate` takes the straggler recook's (`two_pass`,
`twopass_j1`, `twopass_div`, `refine`), with the reference's rule for
where it engages (`ops.pressure.recook_plan`), and the pressure warm
starts `p_init` and `keep_pressures`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from historymatching_tpu_torch.grid import Grid2D
from historymatching_tpu_torch.ops.cg import pcg
from historymatching_tpu_torch.ops.multigrid import (
    SMOOTHERS,
    build_hierarchy_5pt,
    coarse_inverse,
    n_levels,
)
from historymatching_tpu_torch.ops.pressure import pressure_solve_recook
from historymatching_tpu_torch.ops.stencil import (
    face_fluxes,
    stencil_diag_nopin,
    stencil_matvec,
    transmissibilities,
)
from historymatching_tpu_torch.ops.transport import transport_substeps
from historymatching_tpu_torch.utils import as_float, atleast_2d


@dataclasses.dataclass(frozen=True)
class Fluid:
    """Two-phase fluid: viscosities and irreducible saturations."""

    vw: float = 1.0
    vo: float = 1.0
    swc: float = 0.0
    sor: float = 0.0


@dataclasses.dataclass(frozen=True)
class ResSim:
    """Immutable reservoir model. Tensors: K (..., 2, Nx, Ny) direction
    permeabilities; well coordinates (..., nWell, 2); well rates
    (..., nWell, nT), nT == 1 meaning constant in time. Each may carry a
    leading member axis or share one set among the members."""

    K: torch.Tensor
    inj_xy: torch.Tensor
    prd_xy: torch.Tensor
    inj_rates: torch.Tensor
    prd_rates: torch.Tensor
    grid: Grid2D
    fluid: Fluid
    name: str = ""

    @classmethod
    def build(cls, Nx=32, Ny=32, Lx=1.0, Ly=1.0, K=None, inj_xy=None, prd_xy=None,
              inj_rates=None, prd_rates=None, fluid=None, name="", dtype=None,
              device="cuda"):
        """Wells default to a centre injector and a far-corner producer with
        balanced unit rates. The tensors land on `device`, the card unless
        the caller names another."""
        grid = Grid2D(Nx=Nx, Ny=Ny, Lx=Lx, Ly=Ly)
        if K is None:
            K = np.ones((2, Nx, Ny))
        if inj_xy is None:
            inj_xy = [[Lx / 2, Ly / 2]]
        if prd_xy is None:
            prd_xy = [[Lx - grid.hx / 2, Ly - grid.hy / 2]]
        if inj_rates is None:
            inj_rates = np.ones((len(np.atleast_2d(inj_xy)), 1))
        if prd_rates is None:
            n = len(np.atleast_2d(prd_xy))
            prd_rates = np.ones((n, 1)) / n
        cv = lambda x: as_float(x, dtype, device)  # noqa: E731
        return cls(K=cv(K), inj_xy=atleast_2d(cv(inj_xy)), prd_xy=atleast_2d(cv(prd_xy)),
                   inj_rates=atleast_2d(cv(inj_rates)),
                   prd_rates=atleast_2d(cv(prd_rates)), grid=grid,
                   fluid=fluid or Fluid(), name=name)

    def replace(self, **kw):
        """Functional reconfiguration; arrays become tensors on K's device.
        A leading member axis of a well array is kept."""
        for k in ("K", "inj_xy", "prd_xy", "inj_rates", "prd_rates"):
            if k in kw:
                v = as_float(kw[k], device=self.K.device)
                kw[k] = v if k == "K" else atleast_2d(v)
        return dataclasses.replace(self, **kw)

    @property
    def Nx(self):
        return self.grid.Nx

    @property
    def Ny(self):
        return self.grid.Ny

    @property
    def Lx(self):
        return self.grid.Lx

    @property
    def Ly(self):
        return self.grid.Ly

    @property
    def Nxy(self):
        return self.grid.Nxy

    @property
    def shape(self):
        return self.grid.shape

    @property
    def mesh(self):
        return self.grid.mesh

    @property
    def domain(self):
        return self.grid.domain

    @property
    def nInj(self):
        return self.inj_xy.shape[-2]

    @property
    def nPrd(self):
        return self.prd_xy.shape[-2]

    def sub2ind(self, ix, iy):
        return self.grid.sub2ind(ix, iy)

    def xy2ind(self, x, y):
        return self.grid.xy2ind(x, y)

    def sim(self, dt, nTime, wsat0, **kw):
        """Saturations (nTime+1, Nxy), including the initial state."""
        return simulate(self, wsat0, dt, nTime, **kw).wsats

    def validate(self):
        """Raise on unbalanced rates or out-of-domain wells, naming the
        first failing member where the wells carry a member axis."""
        def where(bad):
            i = tuple(int(v) for v in np.argwhere(bad)[0])
            return i, (f" of member {i if len(i) > 1 else i[0]}" if i else "")

        inj, prd = (np.atleast_2d(r.cpu().numpy()) for r in (self.inj_rates, self.prd_rates))
        ti, tp = np.broadcast_arrays(inj.sum(-2), prd.sum(-2))
        bad = ~np.isclose(ti, tp).all(-1)
        if bad.any():
            i, at = where(bad)
            raise ValueError(f"Unbalanced rates{at}: inj {ti[i]} != prd {tp[i]}")
        for xy, lbl in ((self.inj_xy, "inj"), (self.prd_xy, "prd")):
            xy = xy.cpu().numpy()
            ok = (xy[..., 0] >= 0) & (xy[..., 0] <= self.Lx) & (xy[..., 1] >= 0) & (xy[..., 1] <= self.Ly)
            if not ok.all():
                i, at = where(~ok.all(-1))
                raise ValueError(f"{lbl}_xy outside domain{at}: {xy[i][~ok[i]]}")
        return self


class SimResult(NamedTuple):
    """Outputs of `simulate`. Per-member fields carry the run's leading
    member axis; the rate and validity fields carry the wells' and rates'
    own (none where every member shares them). The fields the JAX
    package's `SimResult` has come in its order, so a checkpoint of one
    loads as the other."""

    wsats: torch.Tensor  # (..., nTime+1, Nxy), or (..., 2, Nxy) without keep_wsats
    actual_inj_rates: torch.Tensor  # (..., nInj, nTime)
    actual_prd_rates: torch.Tensor  # (..., nPrd, nTime)
    valid: torch.Tensor  # (...,) bool: rates balanced at every step, wells in domain
    cg_ok: torch.Tensor  # (...,) bool: every pressure solve accepted
    cg_iters: torch.Tensor  # (..., nTime) int32
    substeps: torch.Tensor  # (..., nTime) int32
    # (..., nTime, Nxy) pressure trajectory with keep_pressures, else ()
    pressures: torch.Tensor | tuple = ()
    prd_sats: torch.Tensor | tuple = ()  # (..., nTime, nPrd) producer-cell saturations
    recooked: torch.Tensor | tuple = ()  # (..., nTime) bool: the member's solve was recooked


def relperm(s, fluid: Fluid):
    """Quadratic (Corey) mobilities (Mw, Mo)."""
    S = (s - fluid.swc) / (1.0 - fluid.swc - fluid.sor)
    return S**2 / fluid.vw, (1.0 - S) ** 2 / fluid.vo


def frac_flow(s, fluid: Fluid):
    Mw, Mo = relperm(s, fluid)
    return Mw / (Mw + Mo)


def _rates_seq(rates, nTime):
    """(..., nWell, nT) -> (nTime, ..., nWell); nT == 1 broadcasts."""
    rates = atleast_2d(rates)
    nT = rates.shape[-1]
    if nT == 1:
        return rates[..., 0].expand(nTime, *rates.shape[:-1])
    if nT != nTime:
        raise ValueError(f"rates have {nT} steps; expected 1 or {nTime}")
    return rates.movedim(-1, 0)


def _well_inds(g: Grid2D, xy):
    """Cell indices (..., nWell) of well coordinates (..., nWell, 2)."""
    return g.xy2ind(xy[..., 0], xy[..., 1])


def _source_field(model: ResSim, inj_t, prd_t):
    """(..., Nx, Ny) source field for one step, from rates (..., nWell) and
    the model's wells, either with a member axis: one `index_add_` a side
    into the flattened members' fields. Wells in one cell add up."""
    g = model.grid
    inj_ind, prd_ind = (_well_inds(g, xy).to(inj_t.device) for xy in (model.inj_xy, model.prd_xy))
    lead = torch.broadcast_shapes(inj_t.shape[:-1], prd_t.shape[:-1], inj_ind.shape[:-1],
                                  prd_ind.shape[:-1])
    B = int(np.prod(lead))
    base = torch.arange(B, device=inj_t.device).reshape(*lead, 1) * g.Nxy
    q = torch.zeros(B * g.Nxy, dtype=inj_t.dtype, device=inj_t.device)
    for ind, rate in ((inj_ind, inj_t), (prd_ind, -prd_t)):
        n = ind.shape[-1]
        q.index_add_(0, (base + ind).expand(*lead, n).reshape(-1),
                     rate.expand(*lead, n).reshape(-1))
    return q.reshape(*lead, *g.shape)


PRECONDS = ("mg", "jacobi")


def _check_solver(precond, smoother):
    if precond not in PRECONDS:
        raise ValueError(f"precond must be one of {PRECONDS}, got {precond!r}")
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother must be one of {SMOOTHERS}, got {smoother!r}")


def scaled_system(model: ResSim, s, precond="mg"):
    """The Jacobi-scaled TPFA system of saturations `s` (..., Nx, Ny): the
    pinned operator's faces TX, TY and diagonal, sd = rsqrt(diag), and the
    scaled operator's multigrid hierarchy with its coarse inverse. The pin
    is the mean of the unpinned diagonal, at cell (0, 0). With
    `precond="jacobi"` the hierarchy is the fine level alone and the
    coarse inverse None.

    Contract: the scaled operator's diagonal is 1, so the hierarchy's fine
    diagonal is a broadcast view of ones. Kernel P (`ops/pressure.py`)
    relies on this and does not read that diagonal. A grid without a
    multigrid hierarchy is refused with either preconditioner: kernel K is
    instantiated only for grids that have one."""
    g = model.grid
    if n_levels(g.Nx, g.Ny) < 2:
        raise NotImplementedError(f"grid {g.Nx}x{g.Ny} has no multigrid hierarchy")
    Mw, Mo = relperm(s, model.fluid)
    mob = Mw + Mo
    TX, TY = transmissibilities(model.K[..., 0, :, :] * mob, model.K[..., 1, :, :] * mob,
                                g.hx, g.hy)
    diag = stencil_diag_nopin(TX, TY)
    diag[..., 0, 0] += diag.mean(dim=(-2, -1))
    sd = torch.rsqrt(diag)
    TXs = TX * sd[..., :-1, :] * sd[..., 1:, :]
    TYs = TY * sd[..., :, :-1] * sd[..., :, 1:]
    ones = diag.new_ones(()).expand_as(diag)
    if precond == "jacobi":
        return TX, TY, diag, sd, [(TXs, TYs, ones)], None
    hier = build_hierarchy_5pt(TXs, TYs, ones)
    return TX, TY, diag, sd, hier, coarse_inverse(hier)


def pressure_step(model: ResSim, s, q, p0, tol, maxiter, tol_accept=None,
                  patience_iters=96, two_pass=True, twopass_j1=64, twopass_div=4,
                  refine=True, precond="mg", smoother="jacobi"):
    """Scaled TPFA pressure solve for saturations `s` (..., Nx, Ny).
    Returns (p, Fx, Fy, iters, accepted, recooked).

    Solves D^-1/2 A D^-1/2 y = D^-1/2 q, p = D^-1/2 y, stopping on the
    physical residual norm (metric weight sqrt(diag)); the fluxes use the
    unscaled operator. With `precond="mg"` the solve is the reference's
    straggler recook (`ops.pressure.pressure_solve_recook`, kernel P on the
    card) where its rule engages, else one pass, with the V-cycle smoother
    `smoother` ("jacobi" or "cheb"); `recooked` marks the members it solved
    again. With `precond="jacobi"`, the plain `pcg` preconditioned by the
    scaled diagonal (which is 1) restarting every 64 iterations, in torch
    ops on either device, as the JAX package computes it in XLA on every
    backend; it never recooks."""
    _check_solver(precond, smoother)
    TX, TY, diag, sd, hier, Ainv = scaled_system(model, s, precond)
    mweight = diag * sd
    lead = diag.shape[:-2]
    flat = lambda t: t.expand(*lead, *t.shape[-2:]).reshape(-1, *t.shape[-2:])  # noqa: E731
    hier_b = [tuple(flat(t) for t in lvl) for lvl in hier]
    if precond == "jacobi":
        TXs, TYs, ones = hier_b[0]
        y, iters, rel = pcg(lambda x: stencil_matvec(TXs, TYs, ones, x), flat(q * sd),
                            x0=flat(p0 * mweight), tol=tol, maxiter=maxiter, restart_every=64,
                            patience_iters=patience_iters, metric_weight=flat(mweight))
        recooked = torch.zeros_like(rel, dtype=torch.bool)
    else:
        y, iters, rel, recooked = pressure_solve_recook(
            hier_b, flat(Ainv), flat(q * sd), flat(p0 * mweight), flat(mweight), tol, maxiter,
            patience_iters, two_pass, twopass_j1, twopass_div, refine, smoother=smoother)
    p = y.reshape(diag.shape) * sd
    Fx, Fy = face_fluxes(TX, TY, p)
    accepted = rel.reshape(lead) <= (tol if tol_accept is None else tol_accept)
    return p, Fx, Fy, iters.reshape(lead), accepted, recooked.reshape(lead)


def cfl_substeps(model: ResSim, Fx, Fy, q, dt, max_substeps=4096):
    """Per-member CFL substep counts n_sub = clip(ceil(dt / cfl), 1,
    max_substeps), cfl = (1-swc-sor)/3 * min(pv / influx), and the substep
    length over pore volume. Returns (n_sub int32, dts / pv)."""
    g = model.grid
    fl = model.fluid
    pv = g.h2
    fi = q.clamp_min(0.0)
    XP, XN = Fx.clamp_min(0.0), Fx.clamp_max(0.0)
    YP, YN = Fy.clamp_min(0.0), Fy.clamp_max(0.0)
    Vi = XP[..., :-1, :] + YP[..., :, :-1] - XN[..., 1:, :] - YN[..., :, 1:]
    inflow = Vi + fi
    pos = inflow > 0
    pm = torch.where(pos, pv / torch.where(pos, inflow, 1.0), torch.inf).amin(dim=(-2, -1))
    cfl = (1.0 - fl.swc - fl.sor) / 3.0 * pm
    n_sub = torch.clamp(torch.ceil(dt / cfl), 1, max_substeps).to(torch.int32)
    dts = dt / n_sub.to(Fx.dtype)
    return n_sub, dts / pv


def transport_step(model: ResSim, s, Fx, Fy, q, dt, max_substeps=4096):
    """Explicit upwind transport over one outer step `dt` with per-member
    CFL substepping (`cfl_substeps`). Returns (s, n_sub)."""
    fl = model.fluid
    n_sub, dts_pv = cfl_substeps(model, Fx, Fy, q, dt, max_substeps)
    s = transport_substeps(s, Fx, Fy, q, dts_pv, n_sub, (fl.vw, fl.vo, fl.swc, fl.sor))
    return s, n_sub


def simulate(model: ResSim, wsat0, dt, nTime, *, tol=None, tol_accept=None, maxiter=None,
             max_substeps=4096, patience_iters=96, two_pass=True, twopass_j1=64,
             twopass_div=4, refine=True, keep_wsats=True, precond="mg", smoother="jacobi",
             p_init=None, keep_pressures=False):
    """Run `nTime` steps of size `dt` from saturation `wsat0` (..., Nxy).
    The members are the broadcast of the leading axes of `wsat0`, `K`, the
    wells and the rates.

    Restartable: pass a previous run's last `wsats` row as `wsat0`. Solver
    defaults follow the dtype: tol 2e-3 / tol_accept 5e-2 / maxiter
    4 max(Nx, Ny) in float32; 1e-10 / 1e-6 / Nxy in float64. `two_pass`,
    `twopass_j1`, `twopass_div` and `refine` set the straggler recook
    (`pressure_step`), with the JAX package's defaults. With
    `keep_wsats=False`, `wsats` holds only [initial, final]; `prd_sats`
    always holds the producer-cell series.

    `precond`: "mg" (the multigrid V-cycle, kernel P on the card) or
    "jacobi" (the scaled diagonal, torch ops; `pressure_step`); a grid
    without a multigrid hierarchy is refused either way. `smoother`: the
    V-cycle's, "jacobi" (damped, omega 0.7) or "cheb" (degree-2
    Chebyshev); any other value of either raises.

    `p_init` (..., nTime, Nxy): per-step pressure warm starts, e.g. a
    previous pass's `pressures`, in place of the previous step's pressure.
    With `keep_pressures`, `SimResult.pressures` holds the (..., nTime,
    Nxy) pressure trajectory; otherwise it is ().
    """
    g = model.grid
    dev = model.K.device
    wsat0 = as_float(wsat0, device=dev)
    dtype = wsat0.dtype
    f64 = dtype == torch.float64
    tol = (1e-10 if f64 else 2e-3) if tol is None else tol
    tol_accept = (1e-6 if f64 else 5e-2) if tol_accept is None else tol_accept
    maxiter = (g.Nxy if f64 else 4 * max(g.Nx, g.Ny)) if maxiter is None else maxiter

    model = model.replace(K=model.K.to(dtype))
    inj_seq = _rates_seq(model.inj_rates, nTime).to(dtype)  # (nTime, ..., nInj)
    prd_seq = _rates_seq(model.prd_rates, nTime).to(dtype)
    wlead = torch.broadcast_shapes(inj_seq.shape[1:-1], prd_seq.shape[1:-1],
                                   model.inj_xy.shape[:-2], model.prd_xy.shape[:-2])
    lead = torch.broadcast_shapes(model.K.shape[:-3], wsat0.shape[:-1], wlead)
    s0 = wsat0.reshape(*wsat0.shape[:-1], *g.shape).expand(*lead, *g.shape)

    # Validity per member of the wells' axis: balanced at every step, every
    # well in the domain.
    tot_i, tot_p = (r.sum(-1).movedim(0, -1) for r in (inj_seq, prd_seq))  # (..., nTime)
    scale = torch.clamp_min(tot_i.abs() + tot_p.abs(), 1e-30)
    balanced = ((tot_i - tot_p).abs() <= 1e-6 * scale).all(-1)
    wells_ok = (g.in_domain(model.inj_xy[..., 0], model.inj_xy[..., 1]).all(-1)
                & g.in_domain(model.prd_xy[..., 0], model.prd_xy[..., 1]).all(-1))
    prd_idx = _well_inds(g, model.prd_xy).to(dev)
    prd_idx = prd_idx.expand(*lead, prd_idx.shape[-1])

    if p_init is not None:
        p_init = as_float(p_init, dtype, dev)
        p_init = p_init.reshape(*p_init.shape[:-2], nTime, *g.shape)
    s, p = s0, torch.zeros_like(s0)
    sats, sobs, iters, conv, subs, recs, press = [], [], [], [], [], [], []
    for t in range(nTime):
        q = _source_field(model, inj_seq[t], prd_seq[t])
        if q.ndim > 2:  # wells of their own: one source field a member
            q = q.expand(*lead, *g.shape)
        # Warm start: the previous step's pressure, or the given one.
        p0 = p if p_init is None else p_init[..., t, :, :].expand(*lead, *g.shape)
        p, Fx, Fy, it, ok, rec = pressure_step(model, s, q, p0, tol, maxiter, tol_accept,
                                               patience_iters, two_pass, twopass_j1,
                                               twopass_div, refine, precond, smoother)
        s, n_sub = transport_step(model, s, Fx, Fy, q, dt, max_substeps)
        flat_s = s.reshape(*lead, -1)
        sobs.append(torch.gather(flat_s, -1, prd_idx))
        iters.append(it)
        conv.append(ok)
        subs.append(n_sub)
        recs.append(rec)
        if keep_wsats:
            sats.append(flat_s)
        if keep_pressures:
            press.append(p.reshape(*lead, -1))
    first = s0.reshape(*lead, -1)
    wsats = torch.stack([first] + (sats if keep_wsats else [s.reshape(*lead, -1)]), dim=-2)
    return SimResult(
        wsats=wsats,
        actual_inj_rates=inj_seq.movedim(0, -1),
        actual_prd_rates=prd_seq.movedim(0, -1),
        valid=balanced & wells_ok.to(balanced.device),
        cg_ok=torch.stack(conv, -1).all(-1),
        cg_iters=torch.stack(iters, -1),
        substeps=torch.stack(subs, -1),
        pressures=torch.stack(press, dim=-2) if keep_pressures else (),
        prd_sats=torch.stack(sobs, dim=-2),
        recooked=torch.stack(recs, -1),
    )
