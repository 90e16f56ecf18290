"""Distance-based localization: distances, the bump taper, domain
partitioning and the taper-tuning dashboards (PyTorch counterpart of
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


def dist_to_moving_obs(grid, xy_paths, domain=None, dtype=torch.float64, device=None):
    """Distances (Nxy, nTime * nPrd) from every cell centre to observation
    locations that move in time, `xy_paths` (nPrd, nTime, 2) as
    `xy_max_corr` gives them, in `dist_to_obs`'s flat order (t * nPrd +
    well). A tensor of paths keeps its device; host data goes to `device`,
    by default the card. `bump(result / radius)` is a taper for
    `da.update.ens_update0_loc`."""
    xy_paths = _points(xy_paths, dtype, device)
    nPrd, nTime, _ = xy_paths.shape
    xy_prm = _points(_cell_xy(grid, np.arange(grid.Nxy)), xy_paths.dtype, xy_paths.device)
    return pairwise_distances(xy_prm, xy_paths.transpose(0, 1).reshape(nTime * nPrd, 2),
                              domain=domain)


def xy_max_corr(grid, param_ens, prod_ens, t_min=6):
    """Paths (nPrd, nTime, 2) of the correlation maxima: per producer and
    time, the (x, y) of the cell whose parameter/production correlation
    (`utils.corr`) is largest. Times before `t_min` take the `t_min`
    location. `param_ens` (N, Nxy), `prod_ens` (N, nTime, nPrd); every
    (time, well) field comes from one product over all the series. Float64
    on the ensembles' device."""
    from historymatching_tpu_torch.utils import corr

    N, nTime, nPrd = prod_ens.shape
    series = prod_ens[:, t_min:].reshape(N, -1)  # flat index (t - t_min) * nPrd + well
    C = corr(param_ens, series)  # (Nxy, series)
    xy = grid.ind2xy(C.argmax(0).cpu()).T.to(param_ens.device)
    paths = xy.reshape(nTime - t_min, nPrd, 2).transpose(0, 1)
    return torch.cat([paths[:, :1].expand(-1, t_min, -1), paths], dim=1)


def corr_wells(prior, prod_prior, dists_to_obs, t, well, nPrd, N=None, radius=None,
               sharpness=1.0, nan_mask=True):
    """The tapered parameter/production correlation field (Nxy,), the
    taper-tuning probe: corr(prior[:N], prod[:N, t, well]), times the bump
    taper of `radius` and `sharpness` if a radius is given, with cells
    below taper 1e-3 set to NaN under `nan_mask`. `dists_to_obs` as
    `dist_to_obs` gives it."""
    from historymatching_tpu_torch.utils import corr

    C = corr(prior[:N], prod_prior[:N, t, well])
    if radius is not None:
        c = bump(dists_to_obs[:, well + nPrd * t] / radius, sharpness)
        C = C * c
        if nan_mask:
            C = torch.where(c < 1e-3, torch.nan, C)
    return C


def suggest_taper_radius(prior, prod_prior, dists_to_obs, nPrd, n_small=20,
                         radii=(0.4, 0.6, 0.8, 1.0, 1.2, 1.6, 2.0), sharps=(0.1, 1.0, 10.0),
                         times=None, wells=None):
    """The (radius, sharpness) whose tapered correlation fields of the first
    `n_small` members come closest (mean RMS difference over probe (time,
    well) pairs) to the whole ensemble's untapered fields. Returns
    (best_radius, best_sharpness, scores {(radius, sharpness): float}).
    Fields of a constant series (0/0) count as 0."""
    nTime = prod_prior.shape[1]
    if times is None:
        times = range(max(1, nTime // 4), nTime, max(1, nTime // 4))
    if wells is None:
        wells = range(nPrd)
    probes = [(t, w) for t in times for w in wells]
    finite = lambda C: torch.nan_to_num(C, nan=0.0, posinf=0.0, neginf=0.0)  # noqa: E731
    full = {tw: finite(corr_wells(prior, prod_prior, dists_to_obs, *tw, nPrd)) for tw in probes}
    scores = {}
    for radius in radii:
        for sharp in sharps:
            errs = [float(torch.sqrt(torch.mean((finite(corr_wells(
                prior, prod_prior, dists_to_obs, *tw, nPrd, N=n_small, radius=radius,
                sharpness=sharp, nan_mask=False)) - full[tw]) ** 2))) for tw in probes]
            scores[(radius, sharp)] = float(np.mean(errs))
    best = min(scores, key=scores.get)
    return best[0], best[1], scores


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
