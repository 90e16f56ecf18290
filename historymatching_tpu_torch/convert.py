"""Carry state from the JAX package into the port.

The system has no trained weights; what crosses over is a model
configuration (its arrays and its grid and fluid scalars), an NPV
configuration, ensembles, controls, the random draws of a run and the
localization of an analysis. Arrays arrive as anything `numpy.asarray`
reads, which includes JAX arrays, so this module needs no JAX itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from historymatching_tpu_torch.models.ressim import Fluid, ResSim
from historymatching_tpu_torch.opt.npv import NPVConfig


def tensor(x, device="cuda", dtype=None):
    """An ensemble, a field, controls or a batch of draws as a tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def ressim_from_reference(model, device="cuda", dtype=None):
    """The port's `ResSim` from a JAX-package `ResSim`: its arrays (K, well
    coordinates, well rates) read with NumPy, its grid and fluid scalars
    read by attribute."""
    g, fl = model.grid, model.fluid
    a = np.asarray
    return ResSim.build(Nx=g.Nx, Ny=g.Ny, Lx=g.Lx, Ly=g.Ly, K=a(model.K),
                        inj_xy=a(model.inj_xy), prd_xy=a(model.prd_xy),
                        inj_rates=a(model.inj_rates), prd_rates=a(model.prd_rates),
                        fluid=Fluid(vw=fl.vw, vo=fl.vo, swc=fl.swc, sor=fl.sor),
                        name=model.name, dtype=dtype, device=device)


def npv_config(cfg):
    """The port's `NPVConfig` from a JAX-package one, field by field."""
    return NPVConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(NPVConfig)})


def localization(domains=None, taper_dom=None, taper=None, device="cuda", dtype=None):
    """The localization keywords of `es_mda` from the JAX package's:
    `domains` (int64) and `taper_dom` of `localization.domain_partition`,
    or a per-cell `taper`. Only those given are returned."""
    out = {}
    if domains is not None:
        out["domains"] = tensor(domains, device=device, dtype=torch.int64)
    for name, x in (("taper_dom", taper_dom), ("taper", taper)):
        if x is not None:
            out[name] = tensor(x, device=device, dtype=dtype)
    return out
