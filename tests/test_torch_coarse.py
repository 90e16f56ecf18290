"""The coarse inverse decided per member (ops/linalg.py `spd_inverse`), float64
on the CPU: a matrix whose Cholesky fails gets the JAX package's guarded
Newton-Schulz on its own, the others keep their Cholesky inverses, and
nothing raises.

Tolerance 1e-10 relative against JAX's `spd_inverse`: both run the same
iteration in float64, and it stops on the same residual tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops.linalg import spd_inverse as spd_inverse_j
from historymatching_tpu.ops.multigrid import build_hierarchy_5pt as build_hierarchy_5pt_j
from historymatching_tpu.ops.multigrid import coarse_inverse as coarse_inverse_j
from historymatching_tpu_torch.ops.linalg import newton_schulz_inverse, spd_inverse
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, coarse_inverse
from historymatching_tpu_torch.ops.pressure import pressure_solve
from tests.torch_helpers import default_model, perm_fields, rel_err, scaled_system, t64

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spd(rng, n):
    G = rng.normal(size=(n, n))
    return G @ G.T + n * np.eye(n)


def _indefinite(rng, n):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.linspace(1.0, 4.0, n)
    lam[1] = -0.5
    return (Q * lam) @ Q.T  # symmetric, one negative eigenvalue


@pytest.mark.parametrize("jitter", [0.0, 1e-12])
def test_newton_schulz_matches_jax_on_indefinite(jitter):
    A = _indefinite(np.random.default_rng(0), 6)
    ref = np.asarray(spd_inverse_j(jnp.asarray(A), jitter=jitter))
    out = spd_inverse(torch.as_tensor(A), jitter=jitter)
    assert torch.isfinite(out).all()
    assert rel_err(out, ref) < 1e-10


def test_newton_schulz_matches_jax_on_spd():
    """The iteration itself, on matrices it converges on, batched."""
    rng = np.random.default_rng(1)
    A = np.stack([_spd(rng, 5) for _ in range(3)])
    d = np.sqrt(np.einsum("bii->bi", A))
    As = A / d[:, :, None] / d[:, None, :]
    out = newton_schulz_inverse(torch.as_tensor(As))
    for b in range(3):
        assert rel_err(out[b], spd_inverse_j(jnp.asarray(As[b]))) < 1e-10
        assert np.allclose(out[b].numpy() @ As[b], np.eye(5), atol=1e-9)


def test_failed_member_does_not_touch_the_others():
    rng = np.random.default_rng(2)
    A = np.stack([_spd(rng, 6) for _ in range(5)])
    forced = A.copy()
    forced[2] = _indefinite(rng, 6)
    X0 = spd_inverse(torch.as_tensor(A))
    X1 = spd_inverse(torch.as_tensor(forced))
    keep = [0, 1, 3, 4]
    assert torch.equal(X1[keep], X0[keep])
    assert torch.isfinite(X1).all()
    assert rel_err(X1[2], spd_inverse_j(jnp.asarray(forced[2]))) < 1e-10


def test_nan_member_does_not_raise():
    rng = np.random.default_rng(3)
    A = np.stack([_spd(rng, 4) for _ in range(3)])
    A[1] = np.nan
    X = spd_inverse(torch.as_tensor(A))
    assert torch.isfinite(X[[0, 2]]).all() and torch.isnan(X[1]).all()


def test_pressure_solve_with_a_failed_coarse_member():
    """Member 1's coarsest operator made indefinite (its coarse diagonal
    halved): `coarse_inverse` returns JAX's Newton-Schulz answer for it, the
    other members' inverses and solves are those of the unforced run, and
    every solve completes."""
    m = default_model(Nx=16, Ny=16)
    TXs, TYs, ones, w, sd = scaled_system(perm_fields(4, 4, m.Nxy), m)
    hier = build_hierarchy_5pt(t64(TXs), t64(TYs), t64(ones))
    TXc, TYc, Dc = hier[-1]
    Dc_forced = Dc.clone()
    Dc_forced[1] = 0.5 * Dc_forced[1]
    hier_f = hier[:-1] + [(TXc, TYc, Dc_forced)]
    Ainv, Ainv_f = coarse_inverse(hier), coarse_inverse(hier_f)
    keep = [0, 2, 3]
    assert torch.equal(Ainv_f[keep], Ainv[keep]) and torch.isfinite(Ainv_f).all()
    hier_j = build_hierarchy_5pt_j(jnp.asarray(TXs[1]), jnp.asarray(TYs[1]),
                                   jnp.asarray(ones[1]))
    lc = hier_j[-1]
    ref = coarse_inverse_j(hier_j[:-1] + [(lc[0], lc[1], 0.5 * lc[2])])
    assert rel_err(Ainv_f[1], ref) < 1e-10
    q = np.zeros((4, *m.shape))
    q[:, 8, 8], q[:, 1, 1] = 1.0, -1.0
    q = t64(q * sd)
    kw = dict(tol=1e-10, maxiter=64)
    p0, it0, rel0 = pressure_solve(hier, Ainv, q, torch.zeros_like(q), t64(w), **kw)
    p1, it1, rel1 = pressure_solve(hier_f, Ainv_f, q, torch.zeros_like(q), t64(w), **kw)
    assert torch.equal(p1[keep], p0[keep]) and torch.equal(it1[keep], it0[keep])
    assert torch.isfinite(p1).all() and torch.isfinite(rel1).all()
