"""Port vs JAX on grids the port used to refuse, and the rest of the runner
and model surface, float64 on the CPU.

- `simulate` on grids without a multigrid hierarchy (15x15, 12x9: the
  plain Jacobi-PCG fallback), with one that no kernel used to be built
  for (10x10, 12x12), and with one whose kernel P layout exceeds one
  block's shared memory (60x60; 60x220, one layer of the SPE10 model 2
  grid, with its 15x55 = 825-cell coarse Cholesky);
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


# Solver settings of a grid's case. At 60x220 (cells 7.3 times longer
# than wide) the V-cycle's point smoother leaves a residual plateau of more
# than 96 iterations: with the default patience both packages stop there
# (rel ~8e-3, cg_ok False) on iterates that rounding decides, so the case
# gives both the patience to reach the f64 tol of 1e-10 (~700 iterations);
# test_default_patience_60x220_within_rounding_spread holds the default.
GRID_KW = {(60, 220): dict(patience_iters=960)}


def _simulate_both(Nx, Ny, seed, nTime=3, N=4, **kw):
    m, mt = _pair(Nx, Ny)
    perm = perm_fields(seed, N, m.Nxy)
    res_j = jax.vmap(lambda p: simulate_j(set_perm_j(m, p), jnp.zeros(m.Nxy), 0.025, nTime,
                                          **kw))(jnp.asarray(perm))
    res_t = simulate(set_perm(mt, torch.as_tensor(perm)), torch.zeros(mt.Nxy, dtype=F64), 0.025,
                     nTime, **kw)
    return res_j, res_t


@pytest.mark.parametrize("Nx,Ny", [(15, 15), (12, 9), (10, 10), (12, 12), (60, 60), (60, 220)])
def test_simulate_any_grid_matches_jax(Nx, Ny):
    N = 2 if Nx * Ny > 1000 else 4
    res_j, res_t = _simulate_both(Nx, Ny, seed=Nx + Ny, N=N, **GRID_KW.get((Nx, Ny), {}))
    assert res_t.wsats.shape == res_j.wsats.shape == (N, 4, Nx * Ny)
    assert rel_err(res_t.wsats, res_j.wsats) < TOL
    assert rel_err(res_t.prd_sats, res_j.prd_sats) < TOL
    assert np.array_equal(res_t.cg_iters.numpy(), np.asarray(res_j.cg_iters))
    assert np.array_equal(res_t.cg_ok.numpy(), np.asarray(res_j.cg_ok))
    assert bool(res_t.cg_ok.all())


def rounding_spread(Nx=60, Ny=220, N=2, nTime=3):
    """At the default patience, where the 60x220 solves stop on their
    residual plateau: the port (on one thread) against JAX, each package
    against itself with the prior scaled by 1 + 1e-15 ("*"), and the port
    against itself on four threads (another reduction order, "4t").
    Returns the relative errors on wsats and prd_sats by comparison, and
    every run's cg_ok."""
    m, mt = _pair(Nx, Ny)
    perm = perm_fields(Nx + Ny, N, m.Nxy)
    port = lambda p: simulate(set_perm(mt, torch.as_tensor(p)),  # noqa: E731
                              torch.zeros(mt.Nxy, dtype=F64), 0.025, nTime)
    threads, runs = torch.get_num_threads(), {}
    try:
        torch.set_num_threads(1)
        for tag, p in (("", perm), ("*", perm * (1 + 1e-15))):
            runs["jax" + tag] = jax.vmap(lambda q: simulate_j(set_perm_j(m, q), jnp.zeros(m.Nxy),
                                                              0.025, nTime))(jnp.asarray(p))
            runs["port" + tag] = port(p)
        torch.set_num_threads(4)
        runs["port 4t"] = port(perm)
    finally:
        torch.set_num_threads(threads)
    errs = {f"{a} vs {b}": (rel_err(runs[a].wsats, runs[b].wsats),
                            rel_err(runs[a].prd_sats, runs[b].prd_sats))
            for a, b in (("port", "jax"), ("jax*", "jax"), ("port*", "port"),
                         ("port 4t", "port"), ("port 4t", "jax"))}
    return errs, {k: np.asarray(r.cg_ok) for k, r in runs.items()}


def test_default_patience_60x220_within_rounding_spread():
    """The 60x220 case at the default settings: every solve stops on the
    plateau (cg_ok False) in both packages, and the port lies no farther
    from JAX than twice the largest spread that rounding alone gives a
    package against itself (the prior scaled by 1 + 1e-15, or the port on
    four threads)."""
    errs, ok = rounding_spread()
    assert not any(v.any() for v in ok.values()), ok
    spread = max(errs[k][0] for k in ("jax* vs jax", "port* vs port", "port 4t vs port"))
    assert errs["port vs jax"][0] <= 2 * spread, errs
    assert errs["port vs jax"][1] < TOL, errs


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


if __name__ == "__main__":
    # The spread at 60x220 and the default patience:
    # python -m tests.test_torch_grids
    import tests.conftest  # noqa: F401  (JAX on the CPU in float64)

    for k, (w, p) in rounding_spread()[0].items():
        print(f"{k}: wsats rel {w!r}, prd_sats rel {p!r}")
