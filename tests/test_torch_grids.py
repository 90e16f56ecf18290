"""Port vs JAX on grids the port used to refuse, and the rest of the runner
and model surface, float64 on the CPU.

- `simulate` on grids without a multigrid hierarchy (15x15, 12x9: the
  plain Jacobi-PCG fallback) and with one that no kernel used to be built
  for (10x10, 12x12);
- the unscaled system (`scale_system=False`), with either preconditioner;
- `forward_model(chunk=)`, `obs_ens_fn(nTime_axis_flat=False)`,
  `ind2xy`/`sub2xy`, `sim(pbar=)` and `geostat` at the package top.

Tolerance 1e-8 relative on saturations and productions: each pressure
solve stops at the f64 tol 1e-10 and the two sides' coarse inverses
differ (Cholesky against Newton-Schulz), far below it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import historymatching_tpu_torch as ht
from historymatching_tpu.models.ressim import simulate as simulate_j
from historymatching_tpu.parallel.runner import forward_model as forward_model_j
from historymatching_tpu.parallel.runner import obs_ens_fn as obs_ens_fn_j
from historymatching_tpu.parallel.runner import set_perm as set_perm_j
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.models.ressim import simulate
from historymatching_tpu_torch.parallel.runner import forward_model, obs_ens_fn, set_perm
from tests.torch_helpers import default_model, perm_fields, rel_err

F64 = torch.float64
TOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(Nx, Ny):
    m = default_model(Nx=Nx, Ny=Ny)
    return m, convert.ressim_from_reference(m, dtype=F64, device="cpu")


def _simulate_both(Nx, Ny, seed, nTime=3, **kw):
    m, mt = _pair(Nx, Ny)
    perm = perm_fields(seed, 4, m.Nxy)
    res_j = jax.vmap(lambda p: simulate_j(set_perm_j(m, p), jnp.zeros(m.Nxy), 0.025, nTime,
                                          **kw))(jnp.asarray(perm))
    res_t = simulate(set_perm(mt, torch.as_tensor(perm)), torch.zeros(mt.Nxy, dtype=F64), 0.025,
                     nTime, **kw)
    return res_j, res_t


@pytest.mark.parametrize("Nx,Ny", [(15, 15), (12, 9), (10, 10), (12, 12)])
def test_simulate_any_grid_matches_jax(Nx, Ny):
    res_j, res_t = _simulate_both(Nx, Ny, seed=Nx + Ny)
    assert res_t.wsats.shape == res_j.wsats.shape == (4, 4, Nx * Ny)
    assert rel_err(res_t.wsats, res_j.wsats) < TOL
    assert rel_err(res_t.prd_sats, res_j.prd_sats) < TOL
    assert np.array_equal(res_t.cg_iters.numpy(), np.asarray(res_j.cg_iters))
    assert np.array_equal(res_t.cg_ok.numpy(), np.asarray(res_j.cg_ok))
    assert bool(res_t.cg_ok.all())


@pytest.mark.parametrize("precond", ["mg", "jacobi"])
@pytest.mark.parametrize("Nx,Ny", [(12, 12), (15, 15)])
def test_unscaled_system_matches_jax(Nx, Ny, precond):
    res_j, res_t = _simulate_both(Nx, Ny, seed=3, scale_system=False, precond=precond)
    assert rel_err(res_t.wsats, res_j.wsats) < TOL
    assert rel_err(res_t.prd_sats, res_j.prd_sats) < TOL
    assert np.array_equal(res_t.cg_iters.numpy(), np.asarray(res_j.cg_iters))
    assert np.array_equal(res_t.cg_ok.numpy(), np.asarray(res_j.cg_ok))


def test_forward_model_chunked_matches_jax():
    """Chunks of 2 of 5 members (a ragged last chunk), with per-member
    restart states: equal to the port's unchunked run, and to JAX's
    chunked and unchunked runs."""
    m, mt = _pair(12, 12)
    perm = perm_fields(11, 5, m.Nxy)
    w0 = np.random.default_rng(5).uniform(0.0, 0.3, size=(5, m.Nxy))
    wj, pj = forward_model_j(m, jnp.asarray(perm), jnp.asarray(w0), dt=0.025, nTime=3)
    wj2, pj2 = forward_model_j(m, jnp.asarray(perm), jnp.asarray(w0), dt=0.025, nTime=3,
                               chunk=2)
    args = (mt, torch.as_tensor(perm), torch.as_tensor(w0))
    wt, pt = forward_model(*args, dt=0.025, nTime=3)
    wt2, pt2, res2 = forward_model(*args, dt=0.025, nTime=3, chunk=2, return_sim=True)
    assert torch.equal(wt2, wt) and torch.equal(pt2, pt)
    for a, b in ((wt2, wj), (wt2, wj2), (pt2, pj), (pt2, pj2)):
        assert rel_err(a, b) < TOL
    assert res2.cg_iters.shape == (5, 3) and torch.equal(res2.wsats, wt2)


def test_obs_ens_fn_time_axis():
    m, mt = _pair(12, 12)
    perm = perm_fields(13, 3, m.Nxy)
    flat_j = obs_ens_fn_j(m, 0.025, 3)(jnp.asarray(perm))
    axis_j = obs_ens_fn_j(m, 0.025, 3, nTime_axis_flat=False)(jnp.asarray(perm))
    flat_t = obs_ens_fn(mt, 0.025, 3)(torch.as_tensor(perm))
    axis_t = obs_ens_fn(mt, 0.025, 3, nTime_axis_flat=False)(torch.as_tensor(perm))
    assert axis_t.shape == axis_j.shape == (3, 3, 4) and flat_t.shape == (3, 12)
    assert rel_err(axis_t, axis_j) < TOL and rel_err(flat_t, flat_j) < TOL
    assert torch.equal(axis_t.reshape(3, -1), flat_t)


def test_ind2xy_and_sub2xy_match_jax():
    m, mt = _pair(12, 9)
    ind = np.array([0, 5, 17, 107])
    ix, iy = ind // 9, ind % 9
    assert np.allclose(mt.ind2xy(ind).numpy(), np.asarray(m.ind2xy(ind)), rtol=0, atol=1e-15)
    assert mt.ind2xy(ind).shape == (2, 4)  # stacked on the first axis
    assert np.allclose(mt.sub2xy(ix, iy).numpy(), np.asarray(m.sub2xy(ix, iy)), atol=1e-15)
    assert mt.sub2xy(ix, iy).shape == (4, 2)
    assert np.allclose(mt.grid.sub2xy(3, 4).numpy(), np.asarray(m.grid.sub2xy(3, 4)))
    assert np.allclose(mt.ind2xy(17).numpy(), np.asarray(m.ind2xy(17)))


def test_sim_takes_pbar():
    m, mt = _pair(10, 10)
    ws_j = m.sim(0.025, 3, jnp.zeros(m.Nxy), pbar=object())
    ws_t = mt.sim(0.025, 3, torch.zeros(mt.Nxy, dtype=F64), pbar=object())
    assert ws_t.shape == ws_j.shape == (4, 100)
    assert rel_err(ws_t, ws_j) < TOL


def test_geostat_at_package_top():
    from historymatching_tpu_torch.da import geostat

    assert ht.geostat is geostat and "geostat" in ht.__all__
    assert callable(ht.geostat.gaussian_fields_fft)
