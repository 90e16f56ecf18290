"""Port vs JAX: the multigrid hierarchy, coarse inverse and V-cycle
(ops/multigrid.py), float64 on the CPU.

Tolerances: hierarchy and V-cycle 1e-12 relative (same arithmetic, sums of
2 or 4 terms in possibly another order). Coarse inverse 1e-8 relative: the
port factors by Cholesky, the JAX package iterates Newton-Schulz, which
stops at 32 eps on the scaled matrix, so its forward error is that residual
times the scaled condition number."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops import multigrid as mj
from historymatching_tpu_torch.ops import multigrid as mt
from tests.torch_helpers import default_model, perm_fields, rel_err, scaled_system, t64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("Nx,Ny", [(16, 16), (20, 20), (16, 8)])
def test_n_levels(Nx, Ny):
    assert mt.n_levels(Nx, Ny) == mj.n_levels(Nx, Ny)


@pytest.mark.parametrize("Nx,Ny", [(16, 16), (20, 20)])
def test_hierarchy_coarse_inverse_vcycle(Nx, Ny):
    m = default_model(Nx=Nx, Ny=Ny)
    N = 3
    TXs, TYs, ones, _, _ = scaled_system(perm_fields(2, N, m.Nxy, scale=0.8), m)
    hier_t = mt.build_hierarchy_5pt(t64(TXs), t64(TYs), t64(ones))
    Ainv_t = mt.coarse_inverse(hier_t)
    b = np.random.default_rng(3).normal(size=(N, Nx, Ny))
    z_t = mt.vcycle_apply(hier_t, Ainv_t, t64(b))
    for k in range(N):
        hier_j = mj.build_hierarchy_5pt(jnp.asarray(TXs[k]), jnp.asarray(TYs[k]),
                                        jnp.asarray(ones[k]))
        assert len(hier_j) == len(hier_t)
        for lj, lt in zip(hier_j, hier_t):
            for aj, at in zip(lj, lt):
                assert aj.shape == at[k].shape
                assert rel_err(at[k], aj) < 1e-12
        Ainv_j = mj.coarse_inverse(hier_j)
        assert rel_err(Ainv_t[k], Ainv_j) < 1e-8
        # The V-cycle on the same coarse inverse.
        z_j = mj.vcycle_apply(hier_j, jnp.asarray(Ainv_t[k].numpy()), jnp.asarray(b[k]))
        assert rel_err(z_t[k], z_j) < 1e-12
