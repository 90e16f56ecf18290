"""Port vs JAX: the ensemble utilities (utils.py `cov`, `corr`, `svals`,
`mnorm`, `rms`, `emph`, `split`, `print_RMSMs`) and the localization
dashboards (da/localization.py `dist_to_moving_obs`, `xy_max_corr`,
`corr_wells`, `suggest_taper_radius`), float64 on the CPU, 1e-12
relative (the same sums in another order); the correlation maxima's cells
and the suggested taper are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu import utils as uj
from historymatching_tpu.da import localization as lj
from historymatching_tpu_torch import utils as ut
from historymatching_tpu_torch.da import localization as lt
from historymatching_tpu_torch.grid import Grid2D
from tests.torch_helpers import default_model, rel_err, t64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_ensemble_utils_match_jax(capsys):
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(12, 7)), rng.normal(size=(12, 3))
    b1 = b[:, 0]
    for x, y in ((a, b), (a, b1)):
        assert rel_err(ut.cov(t64(x), t64(y)), uj.cov(x, y)) < 1e-12
    assert rel_err(ut.corr(t64(a), t64(b1)), uj.corr(a, b1)) < 1e-12
    # several series at once: column k is the correlation with b[:, k]
    C = ut.corr(t64(a), t64(b))
    assert C.shape == (7, 3)
    for k in range(3):
        assert rel_err(C[:, k], uj.corr(a, b[:, k])) < 1e-12
    # a constant series: 0/0 on both sides
    assert np.array_equal(ut.corr(t64(a), t64(np.ones(12))).numpy(),
                          np.asarray(uj.corr(a, np.ones(12))), equal_nan=True)
    for cf in (True, False):
        assert rel_err(ut.svals(t64(a), cf), np.linalg.svd(
            a - a.mean(0) if cf else a, compute_uv=False)) < 1e-12
    x3 = rng.normal(size=(4, 6, 5))
    for axis in (0, 1, -1):
        assert rel_err(ut.mnorm(t64(x3), axis), uj.mnorm(x3, axis)) < 1e-12
    assert rel_err(ut.rms(t64(x3)), uj.rms(x3)) < 1e-12
    assert ut.emph("x") == uj.emph("x")
    for step in (0, 2, 5):
        assert ut.split(list(range(5)), step) == uj.split(list(range(5)), step)
    series = {"truth": a[:1], "prior": a, "post": torch.as_tensor(a[:6] * 0.5)}
    rows_t = ut.print_RMSMs(series, "truth")
    out_t = capsys.readouterr().out
    rows_j = uj.print_RMSMs({k: np.asarray(v) for k, v in series.items()}, "truth")
    assert out_t == capsys.readouterr().out and rows_t == rows_j


def _ensembles(N=30, nTime=12):
    m = default_model(Nx=16, Ny=16)
    rng = np.random.default_rng(6)
    param = rng.normal(size=(N, m.Nxy))
    inds = np.asarray(m.xy2ind(m.prd_xy[:, 0], m.prd_xy[:, 1]))
    # production series correlated with the parameters near each producer
    prod = np.stack([np.outer(np.linspace(0, 1, nTime), param[:, i]).T for i in inds], -1)
    prod = prod + 0.3 * rng.normal(size=prod.shape)
    prod[:, :2] = 0.0  # pre-breakthrough: constant series
    return m, inds, param, prod


def test_dashboards_match_jax():
    m, inds, param, prod = _ensembles()
    g = Grid2D(Nx=16, Ny=16, Lx=m.Lx, Ly=m.Ly)
    paths_t = lt.xy_max_corr(g, t64(param), t64(prod), t_min=3)
    paths_j = lj.xy_max_corr(m.grid, param, prod, t_min=3)
    assert paths_t.shape == (4, 12, 2) and np.array_equal(paths_t.numpy(), paths_j)
    ref = lj.dist_to_moving_obs(m.grid, paths_j)
    assert rel_err(lt.dist_to_moving_obs(g, paths_t), ref) < 1e-14
    assert rel_err(lt.dist_to_moving_obs(g, paths_j, device="cpu"), ref) < 1e-14
    dists = lj.dist_to_obs(m.grid, inds, nTime=12)
    for kw in (dict(), dict(N=20, radius=0.8), dict(N=20, radius=0.8, nan_mask=False)):
        out = lt.corr_wells(t64(param), t64(prod), t64(dists), 5, 2, 4, **kw)
        ref = np.asarray(lj.corr_wells(param, prod, dists, 5, 2, 4, **kw))
        assert np.array_equal(np.isnan(out.numpy()), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert rel_err(out.numpy()[ok], ref[ok]) < 1e-12
    kw = dict(radii=(0.4, 0.8, 1.2), sharps=(1.0, 10.0))
    r_t, s_t, sc_t = lt.suggest_taper_radius(t64(param), t64(prod), t64(dists), 4, **kw)
    r_j, s_j, sc_j = lj.suggest_taper_radius(param, prod, jnp.asarray(dists), 4, **kw)
    assert (r_t, s_t) == (r_j, s_j) and sc_t.keys() == sc_j.keys()
    assert max(abs(sc_t[k] - sc_j[k]) / sc_j[k] for k in sc_j) < 1e-12
