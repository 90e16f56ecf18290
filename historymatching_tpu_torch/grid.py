"""Static 2D grid geometry (PyTorch counterpart of `historymatching_tpu.grid`).

A frozen, hashable dataclass of Python scalars. Index maps accept Python
numbers, NumPy arrays or tensors and return tensors; coordinates are
C-order over `(Nx, Ny)`: `ind = ix * Ny + iy`. Wells collocate to cell
centres.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Uniform 2D grid on the domain [0, Lx] x [0, Ly] with Nx x Ny cells."""

    Nx: int = 32
    Ny: int = 32
    Lx: float = 1.0
    Ly: float = 1.0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.Nx, self.Ny)

    @property
    def Nxy(self) -> int:
        return self.Nx * self.Ny

    @property
    def hx(self) -> float:
        return self.Lx / self.Nx

    @property
    def hy(self) -> float:
        return self.Ly / self.Ny

    @property
    def h2(self) -> float:
        """Cell area (hz = 1)."""
        return self.hx * self.hy

    @property
    def domain(self) -> tuple[tuple[float, float], tuple[float, float]]:
        return ((0.0, 0.0), (self.Lx, self.Ly))

    @cached_property
    def xc(self) -> np.ndarray:
        return (np.arange(self.Nx) + 0.5) * self.hx

    @cached_property
    def yc(self) -> np.ndarray:
        return (np.arange(self.Ny) + 0.5) * self.hy

    @cached_property
    def mesh(self) -> tuple[np.ndarray, np.ndarray]:
        return tuple(np.meshgrid(self.xc, self.yc, indexing="ij"))

    def sub2ind(self, ix, iy):
        """(ix, iy) subscripts -> flat index (C-order over (Nx, Ny))."""
        return _t(ix) * self.Ny + _t(iy)

    def ind2sub(self, ind):
        """Flat index -> (ix, iy)."""
        ind = _t(ind)
        return ind // self.Ny, ind % self.Ny

    def ind2xy(self, ind):
        """Flat index -> cell-centre (x, y) in float64, stacked on the first
        axis."""
        ix, iy = (i.to(torch.float64) for i in self.ind2sub(ind))
        return torch.stack([(ix + 0.5) * self.hx, (iy + 0.5) * self.hy], dim=0)

    def xy2sub(self, x, y):
        """Coordinates -> subscripts of the containing cell: floor, then clip
        to the grid, as integers."""
        ix = torch.clamp(torch.floor(_t(x) / self.hx).long(), 0, self.Nx - 1)
        iy = torch.clamp(torch.floor(_t(y) / self.hy).long(), 0, self.Ny - 1)
        return ix, iy

    def xy2ind(self, x, y):
        ix, iy = self.xy2sub(x, y)
        return self.sub2ind(ix, iy)

    def in_domain(self, x, y):
        """Coordinates inside [0, Lx] x [0, Ly]."""
        x, y = _t(x), _t(y)
        return (x >= 0) & (x <= self.Lx) & (y >= 0) & (y <= self.Ly)
