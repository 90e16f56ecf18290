"""Port vs JAX: the pressure solve and kernel P's plain version
(ops/cg.py, ops/pressure.py, models/ressim.pressure_step), on the CPU.

- The port's batched `pcg` keeps `jax.vmap(pcg)`'s per-member semantics:
  through `pressure_step` in float64 at 16x16, N=4, the iteration counts
  are equal and p, Fx, Fy agree to 1e-9 relative. Both sides use the same
  coarse inverse, so the only differences are summation order.
- Kernel P's plain twin against the Pallas kernel `pressure_solve_pallas`
  in interpret mode, float32, held as tests/test_pallas_kernels.py holds
  the Pallas kernel: relative residual < 1e-3 and p within 2e-3 max|p|
  (float32 sums in another order change the iterate path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.models.ressim import pressure_step as pressure_step_j
from historymatching_tpu.ops.multigrid import build_hierarchy_5pt as build_j
from historymatching_tpu.ops.pressure_pallas import pressure_solve_pallas
from historymatching_tpu.ops.stencil import stencil_matvec as matvec_j
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.models.ressim import pressure_step
from historymatching_tpu_torch.models.ressim import scaled_system as scaled_system_t
from historymatching_tpu_torch.ops._build import GRIDS
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, coarse_inverse, n_levels
from historymatching_tpu_torch.ops.pressure import pressure_solve, smem_bytes
from historymatching_tpu_torch.parallel.runner import set_perm
from tests.torch_helpers import default_model, perm_fields, rel_err, scaled_system


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_pcg_matches_vmapped_pcg_f64():
    from historymatching_tpu.parallel.runner import set_perm as set_perm_j

    m = default_model(Nx=16, Ny=16)
    N = 4
    perm = perm_fields(4, N, m.Nxy)
    rng = np.random.default_rng(5)
    s = np.clip(0.3 + 0.2 * rng.normal(size=(N, 16, 16)), 0, 1)
    p0 = rng.normal(size=(N, 16, 16))
    q = np.zeros((16, 16))
    q[8, 8], q[2, 2], q[13, 3] = 1.0, -0.5, -0.5
    tol, maxiter = 1e-10, 256

    mt = set_perm(convert.ressim_from_reference(m, dtype=torch.float64, device="cpu"),
                  torch.as_tensor(perm))
    st, qt, p0t = map(torch.as_tensor, (s, q, p0))
    p_t, Fx_t, Fy_t, it_t, ok_t, rec_t = pressure_step(mt, st, qt, p0t, tol, maxiter, 1e-6)
    assert not bool(rec_t.any())  # N=4 is below the recook's engage size

    # The same coarse inverse on the JAX side (the port's is a Cholesky
    # inverse, the JAX package's a Newton-Schulz one).
    TXs, TYs, ones, _, _ = scaled_system(perm, m, s)
    Ainv = coarse_inverse(build_hierarchy_5pt(*map(torch.as_tensor, (TXs, TYs, ones)))).numpy()

    def one(pm, s1, p01, A):
        return pressure_step_j(set_perm_j(m, pm), s1, jnp.asarray(q), p01, tol, maxiter, 1e-6,
                               coarse_Ainv=A)

    p_j, Fx_j, Fy_j, it_j, ok_j = jax.vmap(one)(*map(jnp.asarray, (perm, s, p0, Ainv)))
    assert np.array_equal(it_t.numpy(), np.asarray(it_j))
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j)) and bool(ok_t.all())
    for a, b in ((p_t, p_j), (Fx_t, Fx_j), (Fy_t, Fy_j)):
        assert rel_err(a, b) < 1e-9


def test_plain_kernel_twin_matches_pallas_interpret_f32():
    m = default_model(Nx=16, Ny=16)
    N = 2
    perm = perm_fields(6, N, m.Nxy, scale=0.6)
    TXs, TYs, ones, w, _ = scaled_system(perm, m)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    hier = build_hierarchy_5pt(f32(TXs), f32(TYs), f32(ones))
    Ainv = coarse_inverse(hier)
    q = np.zeros((N, 16, 16), np.float32)
    q[:, 8, 8], q[:, 2, 2] = 1.0, -1.0
    q_s = q * (1.0 / w).astype(np.float32)
    p_t, it_t, rel_t = pressure_solve(hier, Ainv, f32(q_s), torch.zeros(N, 16, 16), f32(w),
                                      tol=1e-4, maxiter=256)
    assert p_t.dtype == torch.float32 and it_t.dtype == torch.int32
    Nc, Mc = hier[-1][2].shape[-2:]
    for k in range(N):
        hier_j = build_j(jnp.asarray(TXs[k], jnp.float32), jnp.asarray(TYs[k], jnp.float32),
                         jnp.ones((16, 16), jnp.float32))
        hier_flat = tuple(x for lvl in hier_j for x in lvl)
        Ainv3 = jnp.asarray(Ainv[k].numpy()).reshape(-1, Nc, Mc)
        qk = jnp.asarray(q_s[k])
        p_j, _, rel_j = pressure_solve_pallas(hier_flat, Ainv3, qk, jnp.zeros_like(qk),
                                              jnp.asarray(w[k], jnp.float32), tol=1e-4,
                                              maxiter=256, interpret=True)
        mv = lambda x: np.asarray(matvec_j(*hier_j[0], jnp.asarray(x)))  # noqa: E731
        nq = np.linalg.norm(q_s[k])
        for p_sol in (p_t[k].numpy(), np.asarray(p_j)):
            assert np.linalg.norm(q_s[k] - mv(p_sol)) / nq < 1e-3
        assert float(rel_t[k]) < 1e-3 and float(rel_j) < 1e-3
        scale = np.abs(np.asarray(p_j)).max()
        assert np.allclose(p_t[k].numpy(), np.asarray(p_j), atol=2e-3 * scale), k


def test_scaled_system_has_unit_fine_diagonal():
    """The contract kernel P relies on without reading it: the scaled
    operator's diagonal sd^2 diag is 1, and the hierarchy's fine diagonal
    is ones."""
    m = default_model(Nx=16, Ny=16)
    mt = set_perm(convert.ressim_from_reference(m, dtype=torch.float64, device="cpu"),
                  torch.as_tensor(perm_fields(7, 3, m.Nxy)))
    s = torch.as_tensor(np.random.default_rng(7).uniform(0.2, 0.8, size=(3, 16, 16)))
    _, _, diag, sd, hier, _ = scaled_system_t(mt, s)
    assert torch.allclose(diag * sd * sd, torch.ones_like(diag), rtol=1e-12, atol=0)
    assert hier[0][2].shape == diag.shape and bool((hier[0][2] == 1).all())


def test_kernel_shared_memory_budget():
    """The kernel's footprint (csrc/pressure_pcg.cu source note) lets two
    blocks share an H100 SM at 64x64 (<= 113 KB each of the SM's 228 KB),
    and every instantiated grid fits a block."""
    assert smem_bytes(64, 64, 5) == 114976 <= 113 * 1024
    for Nx, Ny in GRIDS:
        assert 0 < smem_bytes(Nx, Ny, n_levels(Nx, Ny)) <= 113 * 1024
