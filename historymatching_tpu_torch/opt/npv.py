"""Net-present-value objective and its ledger (PyTorch counterpart of
`historymatching_tpu.opt.npv`).

A batch of controls is one `simulate` call: the keyword parameters of
`npv` may carry a leading member axis (well positions (B, nWell, 2), rates
(B, nWell, nT), permeabilities (B, 2, Nx, Ny)), and every ledger entry and
the value come out (B,). Invalid configurations (unbalanced rates,
out-of-domain wells) and unconverged pressure solves zero the member's
value instead of raising.
"""

from __future__ import annotations

import dataclasses

import torch

from historymatching_tpu_torch.models.ressim import ResSim, SimResult, _well_inds, simulate


@dataclasses.dataclass(frozen=True)
class NPVConfig:
    """Prices and schedule."""

    dt: float = 0.025
    nTime: int = 40
    OneYear: float = 0.1
    rate0: float = 1.5  # suggested total production rate
    discount_rate: float = 0.96
    price_inj: float = 20.0
    price_oil: float = 100.0
    price_turbo: float = 1.0
    price_wat: float = 6.0
    price_diffs: float = 1.0
    price_fixed_base: float = 0.8  # price["fixed"] = base * dt / OneYear
    price_well_base: float = 0.3  # price["/well"] = base * dt / OneYear

    @property
    def price_well(self):
        return self.price_well_base * self.dt / self.OneYear

    @property
    def price_fixed(self):
        return self.price_fixed_base * self.dt / self.OneYear

    def discounts(self, dtype=torch.float64, device="cuda"):
        """Discount factor of each step (nTime,), computed in float64."""
        t = torch.arange(self.nTime, dtype=torch.float64)
        return (self.discount_rate ** (self.dt / self.OneYear * t)).to(dtype=dtype, device=device)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def prd_sats(model: ResSim, wsats):
    """Saturations at each member's producers per time interval
    (trapezoidal rule): wsats (..., nTime+1, Nxy) -> (..., nTime, nPrd)."""
    inds = _well_inds(model.grid, model.prd_xy).to(wsats.device)
    inds = inds[..., None, :].expand(*wsats.shape[:-1], inds.shape[-1])
    s = torch.gather(wsats, -1, inds)
    return (s[..., :-1, :] + s[..., 1:, :]) / 2


def accounting(cfg: NPVConfig, model: ResSim, res: SimResult):
    """Ledger of discounted values, each entry (...,) over the members."""
    dt = cfg.dt
    discounts = cfg.discounts(res.wsats.dtype, res.wsats.device)
    prd_ws = prd_sats(model, res.wsats).mT  # (..., nPrd, nTime)
    inj_rates = res.actual_inj_rates  # (..., nInj, nTime)
    prd_rates = res.actual_prd_rates

    inj_volumes = dt * inj_rates
    oil_volumes = dt * prd_rates * (1.0 - prd_ws)
    wat_volumes = dt * prd_rates * prd_ws

    values = {}
    values["oil"] = +cfg.price_oil * (oil_volumes.sum(-2) @ discounts)
    values["inj"] = -cfg.price_inj * (inj_volumes.sum(-2) @ discounts)
    values["wat"] = -cfg.price_wat * (wat_volumes.sum(-2) @ discounts)

    excess = torch.clamp_min(prd_rates.sum(-2) - cfg.rate0, 0.0)
    diffs = torch.diff(inj_rates, dim=-1)
    count = lambda r: (r != 0).sum((-2, -1)).to(r.dtype)  # noqa: E731
    values["pwell"] = -cfg.price_well * count(prd_rates)
    values["iwell"] = -cfg.price_well * count(inj_rates)
    values["turbo"] = -cfg.price_turbo * excess.sum(-1) ** 2 * dt
    values["diffs"] = -cfg.price_diffs * (diffs.abs() ** 0.1).sum((-2, -1))
    lead = torch.broadcast_shapes(*(v.shape for v in values.values()))
    return {k: v.expand(lead) for k, v in values.items()}


def npv(model: ResSim, cfg: NPVConfig = NPVConfig(), wsat0=None, **params):
    """NPV of `model` reconfigured with keyword `params`, whose leading
    member axis makes the whole batch one `simulate` call. Returns
    (value, other) with `other` the reconfigured model, saturations,
    ledger and `SimResult`. `wsat0` defaults to zeros on the model's device.

    The value is 0 where the configuration is invalid, and also where a
    pressure solve was not accepted: an unconverged float32 solve's fluxes
    can inflate the value, an ascent direction the optimizer must not see."""
    m = model.replace(**params) if params else model
    if wsat0 is None:
        wsat0 = torch.zeros(m.Nxy, dtype=m.K.dtype, device=m.K.device)
    res = simulate(m, wsat0, cfg.dt, cfg.nTime)
    ledgr = accounting(cfg, m, res)
    value = sum(ledgr.values())
    value = torch.where(res.valid & res.cg_ok, value, 0.0)
    return value, dict(model=m, wsats=res.wsats, ledgr=ledgr, result=res)


def npv_value(model: ResSim, cfg: NPVConfig = NPVConfig(), wsat0=None, **params):
    """The value of `npv` alone: a scalar, or (B,) for a batch."""
    return npv(model, cfg, wsat0, **params)[0]
