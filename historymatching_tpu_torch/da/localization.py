"""Distance-based localization: distances, the bump taper, domain
partitioning (PyTorch counterpart of the analysis-side parts of
`historymatching_tpu.da.localization`).

Distances and tapers are torch ops; the partitioning is static index sets
built on the host with NumPy, as in the JAX package. Functions that build
tensors from host data put them on the card unless the caller names
another device; the distances are float64 unless a dtype is named.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _points(A, dtype=None, device=None):
    """Points as a 2-D floating tensor: a tensor keeps its device (and a
    floating dtype), host data goes to `device`, by default the card."""
    if isinstance(A, torch.Tensor):
        keep = A.dtype if A.is_floating_point() else torch.float64
        A = A.to(dtype=dtype or keep, device=device or A.device)
    else:
        A = torch.as_tensor(np.asarray(A), dtype=dtype or torch.float64,
                            device=device or "cuda")
    return A.reshape(1, -1) if A.ndim < 2 else A


def pairwise_distances(A, B=None, domain=None, dtype=None, device=None):
    """Euclidean distances (nA, nB) between point sets A (nA, nDims) and B
    (nB, nDims), B defaulting to A; a 1-D input is one point. `domain`, a
    tuple of periods, makes each axis periodic: min(|d|, L - |d|). Host
    data lands on `device` (the card by default) in `dtype` (float64 by
    default); a tensor A keeps its own, and B follows A."""
    A = _points(A, dtype, device)
    B = A if B is None else _points(B, A.dtype, A.device)
    if A.shape[-1] != B.shape[-1]:
        raise ValueError("The last axis of A and B must have equal length.")
    d = A[:, None, :] - B[None, :, :]
    if domain is not None:
        L = torch.as_tensor(domain, dtype=d.dtype, device=d.device).reshape(1, 1, -1)
        d = d.abs()
        d = torch.minimum(d, L - d)
    return (d * d).sum(-1).sqrt()


def bump(distances, sharpness=1):
    """Compact-support bump taper exp(1 - 1/(1 - x^2))^sharpness for
    |x| < 1, else 0; the singular denominator is masked outside."""
    x = distances
    inside = x.abs() < 1
    denom = torch.where(inside, 1 - x * x, 1.0)
    return torch.where(inside, torch.exp(1 - 1 / denom) ** sharpness, 0.0)


def _cell_xy(grid, inds):
    """Cell-centre coordinates (n, 2), float64 NumPy."""
    return grid.ind2xy(torch.as_tensor(np.array(inds))).T.numpy()


def dist_to_obs(grid, obs_inds, nTime=1, domain=None, dtype=torch.float64, device="cuda"):
    """Distances (Nxy, nObs * nTime) from every cell centre to each
    observation location, the block of locations repeated once a time step
    (flat obs index t * nObs + well, as `vect` flattens the series)."""
    xy_prm = _cell_xy(grid, np.arange(grid.Nxy))
    xy_obs = np.tile(_cell_xy(grid, obs_inds), (nTime, 1))
    return pairwise_distances(xy_prm, xy_obs, domain=domain, dtype=dtype, device=device)


def domain_partition(grid, obs_inds, nTime=1, steps=(8, 8), radius=1.2, sharpness=1,
                     dtype=torch.float64, device="cuda"):
    """Domains and their tapers for `da.update.ens_update0_loc_domains`:
    rectangular domains of `steps` cells (which must divide the grid) and
    the bump taper of each domain centre's distance to the observations
    (tiled over `nTime` as in `dist_to_obs`). Returns (domains (nDom,
    cells a domain) int64, taper_dom (nDom, nObs * nTime))."""
    obs_inds = obs_inds.cpu() if isinstance(obs_inds, torch.Tensor) else obs_inds
    if grid.Nx % steps[0] or grid.Ny % steps[1]:
        raise ValueError(f"steps {steps} must divide the grid {grid.shape}")
    batches = rectangular_partitioning(grid.shape, list(steps))
    xy_obs = np.tile(_cell_xy(grid, obs_inds), (nTime, 1))
    centres = np.stack([_cell_xy(grid, b).mean(0) for b in batches])
    dists = pairwise_distances(centres, xy_obs, dtype=dtype, device=device)
    domains = torch.as_tensor(np.stack(batches), dtype=torch.int64, device=device)
    return domains, bump(dists / radius, sharpness)


def rectangular_partitioning(shape, steps, do_ind=True):
    """Tile an N-D grid into rectangular domains of about `steps` cells an
    axis (round(n / step) near-equal blocks an axis), on the host. Returns
    a list of flat-index arrays, one a domain, covering every cell once;
    with `do_ind=False`, per-axis coordinate arrays instead. A domain's flat
    indices are the broadcast sum of its per-axis `block * stride`
    offsets."""
    assert len(shape) == len(steps)
    axis_blocks = [np.array_split(np.arange(n), max(1, round(n / s)))
                   for n, s in zip(shape, steps)]
    strides = np.concatenate([np.cumprod(shape[:0:-1])[::-1], [1]])
    domains = []
    for blocks in itertools.product(*axis_blocks):
        flat = np.zeros(1, dtype=np.intp)
        for blk, stride in zip(blocks, strides):
            flat = (flat[:, None] + blk[None, :] * stride).reshape(-1)
        domains.append(flat if do_ind else np.unravel_index(flat, shape))
    return domains
