"""Control-variable transforms and constraints for EnOpt (PyTorch
counterpart of `historymatching_tpu.opt.transforms`).

Pure functions of tensors that follow their inputs' device. Each takes an
optional leading batch axis, so a whole perturbation ensemble goes through
in one call.
"""

from __future__ import annotations

import torch

from historymatching_tpu_torch.utils import as_float, atleast_2d


def sigmoid(x, height, width=1.0):
    """Centred sigmoid: S(0) = height/2, S(width) ~ 0.73 height."""
    return height / (1.0 + torch.exp(-as_float(x) / width))


def coordinate_transform(xys, Lx, Ly):
    """Map R -> (0, L) per dimension, the origin to the domain's centre, on
    flat (..., 2k) xy vectors."""
    xys = as_float(xys)
    xy2d = xys.reshape(-1, 2)
    return torch.stack([sigmoid(xy2d[:, 0], Lx), sigmoid(xy2d[:, 1], Ly)], dim=1).reshape(xys.shape)


def rate_transform(pre_rates, nWell, nInterval, nTime, rate_min=0.1):
    """Map R -> [0, inf): exp, rates below `rate_min` snapped to 0, and the
    `nInterval` piecewise-constant intervals expanded to `nTime` steps.
    (..., nWell * nInterval) -> (..., nWell, nTime)."""
    pre_rates = as_float(pre_rates)
    duration = -(-nTime // nInterval)  # ceil
    rates = torch.exp(pre_rates)
    rates = torch.where(rates < rate_min, 0.0, rates)
    rates = rates.reshape(*pre_rates.shape[:-1], nWell, nInterval)
    return rates.repeat_interleave(duration, dim=-1)[..., :nTime]


def equalize(rates, nWell):
    """Share the total rate (..., nW, nT) equally among `nWell` wells."""
    rates = atleast_2d(as_float(rates))
    total = rates.sum(-2, keepdim=True) / nWell
    return total.expand(*rates.shape[:-2], nWell, rates.shape[-1])


def balance_rates(inj, prd, eps=1e-30):
    """Balance the totals (..., nWell, nT) at each step by scaling the
    larger side down. Returns (inj, prd)."""
    inj, prd = atleast_2d(as_float(inj)), atleast_2d(as_float(prd))
    I = inj.sum(-2, keepdim=True)  # noqa: E741
    Pt = prd.sum(-2, keepdim=True)
    inj_b = torch.where(Pt < I, inj * Pt / torch.clamp_min(I, eps), inj)
    prd_b = torch.where(I < Pt, prd * I / torch.clamp_min(Pt, eps), prd)
    return inj_b, prd_b
