"""The EnOpt case of the reference bench (`bench._enopt_fields` of the JAX
package): optimise the injector's position on the 20x20 "Optimise" model,
four starts of `gd_scan_multi`, checked against the exhaustive landscape
of the 400 cell-centre positions.

The card's host has no JAX, so the JAX package's random draws for this
case travel in `data/enopt_20x20.npz` (written by
`python -m tests.test_torch_enopt --write-fixture`):
- `perm` (400,) float32: the permeability field of
  `gaussian_fields_fft(k_perm, grid, N=1, r=0.8)`, drawn with x64 on, so
  its spectrum's square root is taken in float64 before the cast: it
  differs from the bench's field (drawn without x64) by at most one
  float32 ulp, 2.4e-7, in 187 of its 400 cells (`python -m
  tests.test_torch_enopt --perm-gap`); `U0` and `Z` are the bench's bits;
- `U0` (4, 2) float32: the starts, uniform over the domain;
- `Z` (4, 30, 10, 2) float32: each start's standard-normal draws for 30
  iterations of 10 perturbations;
- `landscape` (400,) float64: the JAX package's float64 NPV at the cell
  centres `cells`, on the perm cast to float64.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from historymatching_tpu_torch.models.ressim import ResSim
from historymatching_tpu_torch.opt.npv import NPVConfig

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                       "enopt_20x20.npz")
NX = NY = 20
LX, LY, RATE0 = 2.0, 1.0, 1.5


class EnOptCase(NamedTuple):
    model: ResSim
    cfg: NPVConfig
    U0: torch.Tensor  # (4, 2) starts
    Z: torch.Tensor  # (4, 30, 10, 2) draws of gd_scan_multi
    cells: torch.Tensor  # (400, 2) cell centres, y outer, x inner
    landscape: np.ndarray  # (400,) the JAX package's float64 NPV at `cells`


def cell_centres(dtype=torch.float32, device="cuda"):
    """The 400 cell-centre injector positions in the bench's order."""
    xs = (np.arange(NX) + 0.5) * (LX / NX)
    ys = (np.arange(NY) + 0.5) * (LY / NY)
    return torch.as_tensor([[x, y] for y in ys for x in xs], dtype=dtype, device=device)


def enopt_case(dtype=torch.float32, device="cuda"):
    """The bench's model, with K = 0.1 + exp(5 perm) in `dtype`, a centre
    injector, four producers at (0.12, 0.87) x (Lx, Ly), balanced rates
    of 1.5; NPVConfig(dt=0.025, nTime=40, rate0=1.5); the fixture's
    draws."""
    f = np.load(FIXTURE)
    perm = torch.as_tensor(f["perm"], device=device).to(dtype)
    K = (0.1 + torch.exp(5 * perm)).reshape(NX, NY)
    near01 = np.array([0.12, 0.87])
    model = ResSim.build(
        Nx=NX, Ny=NY, Lx=LX, Ly=LY, K=torch.stack([K, K]), inj_xy=[[LX / 2, LY / 2]],
        prd_xy=[[x, y] for y in LY * near01 for x in LX * near01],
        inj_rates=RATE0 * np.ones((1, 1)), prd_rates=RATE0 * np.ones((4, 1)) / 4,
        dtype=dtype, device=device).validate()
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return EnOptCase(model=model, cfg=NPVConfig(dt=0.025, nTime=40, rate0=RATE0),
                     U0=as_t(f["U0"]), Z=as_t(f["Z"]), cells=cell_centres(dtype, device),
                     landscape=f["landscape"])
