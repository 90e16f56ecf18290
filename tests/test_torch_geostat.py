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
