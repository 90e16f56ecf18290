"""Port vs JAX: the straggler recook and its compensated refinement
(ops/stencil.stencil_residual_ds, ops/pressure.recook_plan and
pressure_solve_recook), on the CPU.

- `stencil_residual_ds` against the JAX package's in float64: 1e-14
  relative (the same operations in the same order).
- The engage rule and K against the reference's formula
  (pressure_pallas.py:303-311, 351, 359), restated here in its own terms.
- The recook against the JAX package's `pressure_solve_vmappable` under
  `jax.vmap`, its lane-packed Pallas kernel in interpret mode, in float64
  (interpret mode takes it), at 16x16 and N=300: the batch pads to 384,
  so K=128 picks include padded copies. Tracing the kernel's three calls
  takes ~40 s here, so the solve is kept short: twopass_j1=8, maxiter=16
  and tol 1e-3, so that pass 3 ends early of its 96 iterations. Required:
  the same recooked members, p to 1e-12 and rel to 1e-10 relative. The
  Pallas kernel counts iterations per program, a program running to its
  slowest member; the port counts per member. So a member outside the
  recook has the same count (every one runs the pass-1 cap), and the
  recooked members, all in one program there, read the port's largest
  count among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops.multigrid import build_hierarchy_5pt as build_j
from historymatching_tpu.ops.pressure_pallas import pressure_solve_vmappable
from historymatching_tpu.ops.stencil import stencil_residual_ds as residual_ds_j
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, coarse_inverse
from historymatching_tpu_torch.ops.pressure import pressure_solve_recook, recook_plan
from historymatching_tpu_torch.ops.stencil import stencil_residual_ds
from tests.torch_helpers import default_model, perm_fields, rel_err, scaled_system, t64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_stencil_residual_ds_matches_jax_f64():
    rng = np.random.default_rng(3)
    B, Nx, Ny = 3, 12, 10
    K = np.exp(3.0 * rng.normal(size=(B, Nx, Ny)))
    TX = 1.0 / (1.0 / K[:, :-1] + 1.0 / K[:, 1:])
    TY = 1.0 / (1.0 / K[:, :, :-1] + 1.0 / K[:, :, 1:])
    diag = rng.uniform(1.0, 2.0, size=(B, Nx, Ny)) * K
    p, b = rng.normal(size=(2, B, Nx, Ny))
    ref = residual_ds_j(*map(jnp.asarray, (TX, TY, diag, p, b)))
    out = stencil_residual_ds(*map(t64, (TX, TY, diag, p, b)))
    assert out.dtype == torch.float64
    assert rel_err(out, ref) < 1e-14


def _reference_plan(N, Ny, maxiter, two_pass, j1, div):
    """pressure_pallas.py:303-311, 351, 359 with packed=True."""
    P = 128 // Ny if (Ny <= 64 and 128 % Ny == 0) else 1
    if P == 1:
        return None
    group = P * 16
    Nb = N + (-N) % group
    if not (two_pass and maxiter > j1 and Nb >= 2 * group):
        return None
    return Nb, max(group, (Nb // div // group) * group)


@pytest.mark.parametrize("Ny", [16, 20, 32, 64])
@pytest.mark.parametrize("N", [8, 64, 256, 300, 1000])
def test_recook_plan_is_the_reference_rule(N, Ny):
    for maxiter, two_pass, j1, div in ((128, True, 8, 8), (768, True, 64, 4),
                                       (64, True, 64, 4), (256, False, 8, 8)):
        assert recook_plan(N, Ny, maxiter, two_pass, j1, div) == \
            _reference_plan(N, Ny, maxiter, two_pass, j1, div)
    assert recook_plan(1000, 64, 128, True, 8, 8) == (1024, 128)
    assert recook_plan(300, 16, 16, True, 8, 4) == (384, 128)
    assert recook_plan(N, 20, 768) is None  # the 20x20 EnOpt grid never recooks


def test_recook_matches_pallas_vmappable_interpret_f64():
    N, n, j1, maxiter, tol = 300, 16, 8, 16, 1e-3
    m = default_model(Nx=n, Ny=n)
    TXs, TYs, ones, w, sd = scaled_system(perm_fields(3, N, m.Nxy, scale=0.3), m)
    q = np.zeros((n, n))
    q[8, 8], q[2, 2], q[13, 3] = 1.0, -0.5, -0.5
    qs = q * sd

    hier = build_hierarchy_5pt(t64(TXs), t64(TYs), t64(ones))
    Ainv = coarse_inverse(hier)
    p_t, it_t, rel_t, rec_t = pressure_solve_recook(
        hier, Ainv, t64(qs), torch.zeros(N, n, n, dtype=torch.float64), t64(w), tol, maxiter,
        twopass_j1=j1, twopass_div=4)

    # The JAX side, on the same coarse inverse (the port's is a Cholesky
    # inverse, the JAX package's a Newton-Schulz one), row-unflattened as
    # its kernels take it.
    def flat_hier(TX, TY):
        return tuple(x for lvl in build_j(TX, TY, jnp.ones((n, n))) for x in lvl)

    hier_j = jax.vmap(flat_hier)(jnp.asarray(TXs), jnp.asarray(TYs))
    nc = hier[-1][2].shape[-1]
    Ainv_j = jnp.asarray(Ainv.numpy()).reshape(N, -1, nc, nc)

    def solve(h, A, qq, ww):
        return pressure_solve_vmappable(h, A, qq, jnp.zeros_like(qq), ww, tol=tol,
                                        maxiter=maxiter, twopass_j1=j1, twopass_div=4,
                                        interpret=True)

    p_j, it_j, rel_j = jax.jit(jax.vmap(solve))(hier_j, Ainv_j, jnp.asarray(qs), jnp.asarray(w))
    it_j = np.asarray(it_j)

    rec = rec_t.numpy()
    assert np.array_equal(rec, it_j > j1)  # pass 1 caps every count at j1
    assert 0 < rec.sum() < recook_plan(N, n, maxiter, True, j1, 4)[1]  # padded picks dropped
    assert rel_err(p_t, p_j) < 1e-12 and rel_err(rel_t, rel_j) < 1e-10
    it_t = it_t.numpy()
    assert np.array_equal(it_t[~rec], it_j[~rec])
    assert (it_t[rec] <= it_j[rec]).all() and (it_j[rec] == it_t[rec].max()).all()
