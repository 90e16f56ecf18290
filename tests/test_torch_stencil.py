"""Port vs JAX: the TPFA stencil (ops/stencil.py), float64 on the CPU.

Tolerance 1e-12 relative: the same elementwise arithmetic in the same
order; only the summation order of the pinned-diagonal mean may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops import stencil as sj
from historymatching_tpu_torch.ops import stencil as st
from tests.torch_helpers import rel_err, t64

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fields(seed, shape=(3, 12, 10)):
    rng = np.random.default_rng(seed)
    Kx = np.exp(2.0 * rng.normal(size=shape))
    Ky = np.exp(2.0 * rng.normal(size=shape))
    return Kx, Ky, rng.normal(size=shape)


def test_transmissibilities_and_diagonals():
    Kx, Ky, _ = _fields(0)
    TXt, TYt = st.transmissibilities(t64(Kx), t64(Ky), 0.1, 0.05)
    for b in range(Kx.shape[0]):
        TXj, TYj = sj.transmissibilities(jnp.asarray(Kx[b]), jnp.asarray(Ky[b]), 0.1, 0.05)
        assert rel_err(TXt[b], TXj) < TOL and rel_err(TYt[b], TYj) < TOL
        assert rel_err(st.stencil_diag_nopin(TXt, TYt)[b],
                       sj.stencil_diag_nopin(TXj, TYj)) < TOL
        assert rel_err(st.stencil_diag(TXt, TYt)[b], sj.stencil_diag(TXj, TYj)) < TOL


@pytest.mark.parametrize("batched", [False, True])
def test_matvec_and_fluxes(batched):
    Kx, Ky, p = _fields(1)
    TXt, TYt = st.transmissibilities(t64(Kx), t64(Ky), 0.1, 0.05)
    diag_t = st.stencil_diag(TXt, TYt)
    for b in range(Kx.shape[0]):
        TXj, TYj = sj.transmissibilities(jnp.asarray(Kx[b]), jnp.asarray(Ky[b]), 0.1, 0.05)
        diag_j = sj.stencil_diag(TXj, TYj)
        ref = sj.stencil_matvec(TXj, TYj, diag_j, jnp.asarray(p[b]))
        if batched:
            out = st.stencil_matvec(TXt, TYt, diag_t, t64(p))[b]
            Fx, Fy = (F[b] for F in st.face_fluxes(TXt, TYt, t64(p)))
        else:
            out = st.stencil_matvec(TXt[b], TYt[b], diag_t[b], t64(p[b]))
            Fx, Fy = st.face_fluxes(TXt[b], TYt[b], t64(p[b]))
        assert rel_err(out, ref) < TOL
        Fxj, Fyj = sj.face_fluxes(TXj, TYj, jnp.asarray(p[b]))
        assert Fx.shape == Fxj.shape and Fy.shape == Fyj.shape
        assert rel_err(Fx, Fxj) < TOL and rel_err(Fy, Fyj) < TOL
