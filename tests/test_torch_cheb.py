"""Port vs JAX: the Chebyshev smoother and simulate's remaining knobs
(ops/multigrid.py `_cheb`, `vcycle_apply(smoother=)`; models/ressim.py
`simulate(smoother=, precond=, p_init=, keep_pressures=)`;
parallel/runner.py `forward_model`), on the CPU.

- `_cheb` and a Chebyshev V-cycle: 1e-12 relative in float64, on the same
  coarse inverse.
- Kernel P's plain version with `smoother="cheb"` against the Pallas
  kernel `pressure_solve_pallas(smoother="cheb")` in interpret mode,
  float32, held as tests/test_torch_pressure.py holds the Jacobi one:
  relative residual < 1e-3, p within 2e-3 max|p|.
- 10-step `simulate` with the Chebyshev smoother, and with
  `precond="jacobi"`, against JAX's float64 trajectories at 1e-9 (the
  tolerance of tests/test_torch_sim.py: solves to 1e-10 with other coarse
  inverses), with equal iteration counts.
- `p_init` and `keep_pressures` through `forward_model`: trajectories and
  pressures at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.models.ressim import simulate as simulate_j
from historymatching_tpu.ops import multigrid as mgj
from historymatching_tpu.ops.pressure_pallas import pressure_solve_pallas
from historymatching_tpu.ops.stencil import stencil_matvec as matvec_j
from historymatching_tpu.parallel.runner import forward_model as forward_model_j
from historymatching_tpu.parallel.runner import set_perm as set_perm_j
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.models.ressim import simulate
from historymatching_tpu_torch.ops import multigrid as mgt
from historymatching_tpu_torch.ops.pressure import pressure_solve
from historymatching_tpu_torch.ops.stencil import stencil_matvec
from historymatching_tpu_torch.parallel.runner import ensemble_simulate, forward_model, set_perm
from tests.torch_helpers import default_model, perm_fields, rel_err, scaled_system, t64

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _hierarchies(seed=2):
    """One member's scaled 16x16 hierarchy on both sides, with the port's
    coarse inverse handed to JAX."""
    m = default_model(Nx=16, Ny=16)
    TXs, TYs, ones, _, _ = scaled_system(perm_fields(seed, 1, m.Nxy), m)
    hier_t = mgt.build_hierarchy_5pt(t64(TXs[0]), t64(TYs[0]), t64(ones[0]))
    hier_j = mgj.build_hierarchy_5pt(*map(jnp.asarray, (TXs[0], TYs[0], ones[0])))
    Ainv = mgt.coarse_inverse(hier_t)
    return hier_t, hier_j, Ainv


def test_cheb_smoother_and_vcycle_match_jax():
    hier_t, hier_j, Ainv = _hierarchies()
    rng = np.random.default_rng(3)
    for lvl in range(len(hier_t) - 1):
        TX, TY, diag = hier_t[lvl]
        x, b = rng.normal(size=(2, *diag.shape))
        for sweeps in (1, 2, 3):
            out = mgt._cheb(lambda v: stencil_matvec(TX, TY, diag, v), diag, t64(x), t64(b),
                            sweeps)
            ref = mgj._cheb(lambda v: matvec_j(*hier_j[lvl], v), hier_j[lvl][2],
                            jnp.asarray(x), jnp.asarray(b), sweeps)
            assert rel_err(out, ref) < 1e-12
    b = rng.normal(size=(16, 16))
    for sm in ("jacobi", "cheb"):
        out = mgt.vcycle_apply(hier_t, Ainv, t64(b), smoother=sm)
        ref = mgj.vcycle_apply(hier_j, jnp.asarray(Ainv.numpy()), jnp.asarray(b), smoother=sm)
        assert rel_err(out, ref) < 1e-12
    assert rel_err(mgt.vcycle_apply(hier_t, Ainv, t64(b), smoother="cheb"),
                   mgt.vcycle_apply(hier_t, Ainv, t64(b))) > 1e-3  # a different smoother
    with pytest.raises(ValueError, match="smoother"):
        mgt.vcycle_apply(hier_t, Ainv, t64(b), smoother="sor")


def test_plain_cheb_twin_matches_pallas_interpret_f32():
    m = default_model(Nx=16, Ny=16)
    N = 2
    perm = perm_fields(6, N, m.Nxy, scale=0.6)
    TXs, TYs, ones, w, _ = scaled_system(perm, m)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    hier = mgt.build_hierarchy_5pt(f32(TXs), f32(TYs), f32(ones))
    Ainv = mgt.coarse_inverse(hier)
    q = np.zeros((N, 16, 16), np.float32)
    q[:, 8, 8], q[:, 2, 2] = 1.0, -1.0
    q_s = q * (1.0 / w).astype(np.float32)
    p_t, it_t, rel_t = pressure_solve(hier, Ainv, f32(q_s), torch.zeros(N, 16, 16), f32(w),
                                      tol=1e-4, maxiter=256, smoother="cheb")
    Nc, Mc = hier[-1][2].shape[-2:]
    for k in range(N):
        hier_j = mgj.build_hierarchy_5pt(jnp.asarray(TXs[k], jnp.float32),
                                         jnp.asarray(TYs[k], jnp.float32),
                                         jnp.ones((16, 16), jnp.float32))
        hier_flat = tuple(x for lvl in hier_j for x in lvl)
        Ainv3 = jnp.asarray(Ainv[k].numpy()).reshape(-1, Nc, Mc)
        qk = jnp.asarray(q_s[k])
        p_j, _, rel_j = pressure_solve_pallas(hier_flat, Ainv3, qk, jnp.zeros_like(qk),
                                              jnp.asarray(w[k], jnp.float32), tol=1e-4,
                                              maxiter=256, interpret=True, smoother="cheb")
        mv = lambda x: np.asarray(matvec_j(*hier_j[0], jnp.asarray(x)))  # noqa: E731
        nq = np.linalg.norm(q_s[k])
        for p_sol in (p_t[k].numpy(), np.asarray(p_j)):
            assert np.linalg.norm(q_s[k] - mv(p_sol)) / nq < 1e-3
        assert float(rel_t[k]) < 1e-3 and float(rel_j) < 1e-3
        scale = np.abs(np.asarray(p_j)).max()
        assert np.allclose(p_t[k].numpy(), np.asarray(p_j), atol=2e-3 * scale), k


@pytest.mark.parametrize("kw", [dict(smoother="cheb"), dict(precond="jacobi")],
                         ids=["cheb", "jacobi_precond"])
def test_simulate_solver_variants_match_jax_f64(kw):
    m = default_model(Nx=16, Ny=16)
    perm = perm_fields(7, 3, m.Nxy)
    res_j = jax.vmap(lambda p: simulate_j(set_perm_j(m, p), jnp.zeros(m.Nxy), 0.025, 10, **kw))(
        jnp.asarray(perm))
    mt = convert.ressim_from_reference(m, dtype=F64, device="cpu")
    res_t = simulate(set_perm(mt, torch.as_tensor(perm)), torch.zeros(m.Nxy, dtype=F64), 0.025,
                     10, **kw)
    assert rel_err(res_t.wsats, res_j.wsats) < 1e-9
    assert rel_err(res_t.prd_sats, res_j.prd_sats) < 1e-9
    assert np.array_equal(res_t.cg_iters.numpy(), np.asarray(res_j.cg_iters))
    assert np.array_equal(res_t.substeps.numpy(), np.asarray(res_j.substeps))
    assert bool(res_t.cg_ok.all()) and not bool(res_t.recooked.any())
    base = simulate(set_perm(mt, torch.as_tensor(perm)), torch.zeros(m.Nxy, dtype=F64), 0.025, 10)
    assert not torch.equal(res_t.cg_iters, base.cg_iters)  # the variant took another path


def test_solver_knobs_refuse_unknown_values():
    mt = convert.ressim_from_reference(default_model(Nx=8, Ny=8), dtype=F64, device="cpu")
    for kw in (dict(smoother="sor"), dict(precond="ilu")):
        with pytest.raises(ValueError):
            simulate(mt, torch.zeros(mt.Nxy, dtype=F64), 0.01, 1, **kw)


def test_p_init_and_keep_pressures_match_jax():
    m = default_model(Nx=16, Ny=16)
    perm = perm_fields(9, 3, m.Nxy)
    kw = dict(dt=0.025, nTime=6)
    _, _, press_j = forward_model_j(m, jnp.asarray(perm), keep_pressures=True, **kw)
    mt = convert.ressim_from_reference(m, dtype=F64, device="cpu")
    wsats, prods, press, res = forward_model(mt, torch.as_tensor(perm), keep_pressures=True,
                                             return_sim=True, **kw)
    assert press.shape == (3, 6, m.Nxy) and torch.equal(res.pressures, press)
    assert rel_err(press, press_j) < 1e-9
    assert len(forward_model(mt, torch.as_tensor(perm), **kw)) == 2
    # The next pass: nearby fields warm-started from this pass's pressures.
    perm2 = perm + 0.05 * np.random.default_rng(10).normal(size=perm.shape)
    out_j = forward_model_j(m, jnp.asarray(perm2), p_init=press_j, keep_pressures=True, **kw)
    out_t = ensemble_simulate(mt, torch.as_tensor(perm2), p_init=press, keep_pressures=True,
                              **kw)
    for a, b in zip(out_t, out_j):
        assert rel_err(a, b) < 1e-9
    cold = forward_model(mt, torch.as_tensor(perm2), return_sim=True, **kw)[-1]
    warm = forward_model(mt, torch.as_tensor(perm2), p_init=press, return_sim=True, **kw)[-1]
    assert int(warm.cg_iters.sum()) < int(cold.cg_iters.sum())
    assert cold.pressures == ()
