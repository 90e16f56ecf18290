"""Port vs JAX: the circulant-embedding prior sampler (da/geostat.py),
float64 on the CPU, fed JAX's own white noise. Tolerance 1e-10 relative:
an FFT against the JAX package's matmul DFT, both exact to rounding."""

import jax
import numpy as np
import pytest
import torch

from historymatching_tpu.da.geostat import gaussian_fields_fft as fields_j
from historymatching_tpu.grid import Grid2D as Grid2D_j
from historymatching_tpu_torch.da.geostat import gaussian_fields_fft, sample_prior_perm
from historymatching_tpu_torch.grid import Grid2D
from tests.torch_helpers import default_model, rel_err


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("Nx,Ny,r", [(16, 16, 0.8), (12, 10, 0.3)])
def test_fields_match_jax_with_its_noise(Nx, Ny, r):
    gj, gt = Grid2D_j(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0), Grid2D(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0)
    key = jax.random.PRNGKey(3)
    N = 5
    ref = fields_j(key, gj, N=N, r=r, dtype=np.float64)
    k1, k2 = jax.random.split(key)  # the draws gaussian_fields_fft makes
    zr = np.array(jax.random.normal(k1, (N, 2 * Nx, 2 * Ny), dtype=np.float64))
    zi = np.array(jax.random.normal(k2, (N, 2 * Nx, 2 * Ny), dtype=np.float64))
    out = gaussian_fields_fft(gt, N=N, r=r, noise=(zr, zi), dtype=torch.float64, device="cpu")
    assert out.shape == (N, Nx * Ny)
    assert rel_err(out, ref) < 1e-10


def test_sample_prior_perm_generator():
    m = default_model(Nx=16, Ny=16)
    g = torch.Generator().manual_seed(0)
    E = sample_prior_perm(g, Grid2D(16, 16, 2.0, 1.0), N=64, dtype=torch.float64, device="cpu")
    assert E.shape == (64, m.Nxy) and torch.isfinite(E).all()
    # unit marginal variance, up to sampling error at N=64 over correlated cells
    assert 0.5 < float(E.var(0).mean()) < 1.5


def test_variogram_doctest_and_covariance():
    from historymatching_tpu.da.geostat import cov_gauss as cov_j
    from historymatching_tpu_torch.da.geostat import cov_gauss, variogram_gauss

    v = variogram_gauss(torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64), 1, n=0.1, a=1)
    assert np.allclose(v.numpy(), [0, 0.6689085, 0.98351593])
    d = np.random.default_rng(0).uniform(0, 2, size=(5, 5))
    assert rel_err(cov_gauss(torch.as_tensor(d), 0.5), cov_j(d, 0.5)) < 1e-15


@pytest.mark.parametrize("Nx,Ny,r,tol", [(12, 10, 0.3, 1e-12), (8, 8, 0.8, 1e-3)])
def test_dense_sampler_against_jax_with_the_same_noise(Nx, Ny, r, tol):
    """`gaussian_fields_dense`: F F' reproduces the covariance (1e-6), and
    with JAX's Z the fields are JAX's. The two symmetric square roots
    differ only in the covariance's numerical null space: the port drops
    eigenvalues at or below 1e-8 of the largest, JAX's Newton-Schulz stops
    at its best residual. With no eigenvalue that small (12x10, r=0.3)
    they agree to 1e-12 (measured 6e-15); on the smooth 8x8, r=0.8
    covariance to 1e-3 of the fields' max (measured 5e-5)."""
    from historymatching_tpu.da.geostat import gaussian_fields_dense as dense_j
    from historymatching_tpu_torch.da.geostat import (
        cov_gauss,
        dist_euclid,
        funm_psd,
        gaussian_fields,
        gaussian_fields_dense,
        vectorize,
    )

    g = Grid2D(Nx, Ny, 2.0, 1.0)
    Cov = cov_gauss(dist_euclid(vectorize(*g.mesh)), r)
    F = funm_psd(Cov, torch.sqrt)
    assert torch.allclose(F, F.T) and float((F @ F - Cov).abs().max()) < 1e-6
    key = jax.random.PRNGKey(5)
    ref = dense_j(key, Grid2D_j(Nx, Ny, 2.0, 1.0).mesh, N=4, r=r)
    Z = np.array(jax.random.normal(key, (4, g.Nxy), dtype=np.float64))
    out = gaussian_fields_dense(g.mesh, N=4, r=r, Z=Z, dtype=torch.float64, device="cpu")
    assert out.shape == (4, g.Nxy) and rel_err(out, ref) < tol
    same = gaussian_fields(g.mesh, N=4, r=r, noise=Z, dtype=torch.float64, device="cpu")
    assert torch.equal(same, out)
    gen = torch.Generator().manual_seed(1)
    E = gaussian_fields(g.mesh, N=200, r=r, generator=gen, dtype=torch.float64, device="cpu")
    assert 0.6 < float(E.var(0).mean()) < 1.4


def test_sample_prior_perm_goes_through_the_dispatcher():
    from historymatching_tpu_torch.da.geostat import gaussian_fields

    g = Grid2D(16, 16, 2.0, 1.0)
    a = sample_prior_perm(torch.Generator().manual_seed(3), g, N=3, dtype=torch.float64,
                          device="cpu")
    b = gaussian_fields(g.mesh, N=3, r=0.8, generator=torch.Generator().manual_seed(3), grid=g,
                        dtype=torch.float64, device="cpu")
    assert torch.equal(a, b)
