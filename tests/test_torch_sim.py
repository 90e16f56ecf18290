"""Port vs JAX: `simulate` (models/ressim.py), float64 on the CPU, plus the
physics oracles of tests/test_sim.py run on the port.

Trajectory tolerance 1e-9: each pressure solve stops at the f64 default
tol 1e-10, the two sides use different (Cholesky vs Newton-Schulz) coarse
inverses, so their iterates differ far below the tolerance; iteration and
substep counts are equal on these moderate-contrast fields."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.models.ressim import simulate as simulate_j
from historymatching_tpu.parallel.runner import set_perm as set_perm_j
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.models.ressim import ResSim, simulate
from historymatching_tpu_torch.parallel.runner import prod_inds, set_perm
from tests.torch_helpers import default_model, perm_fields, rel_err

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model(Nx=16, Ny=16):
    return convert.ressim_from_reference(default_model(Nx=Nx, Ny=Ny), dtype=F64, device="cpu")


def _zeros(m):
    return torch.zeros(m.Nxy, dtype=F64)


def test_simulate_matches_jax_f64():
    m = default_model(Nx=16, Ny=16)
    perm = perm_fields(7, 4, m.Nxy)
    res_j = jax.vmap(lambda p: simulate_j(set_perm_j(m, p), jnp.zeros(m.Nxy), 0.025, 5))(
        jnp.asarray(perm))
    mt = _model()
    res_t = simulate(set_perm(mt, torch.as_tensor(perm)), _zeros(mt), 0.025, 5)
    assert res_t.wsats.shape == res_j.wsats.shape == (4, 6, m.Nxy)
    assert rel_err(res_t.wsats, res_j.wsats) < 1e-9
    assert rel_err(res_t.prd_sats, res_j.prd_sats) < 1e-9
    assert np.array_equal(res_t.cg_iters.numpy(), np.asarray(res_j.cg_iters))
    assert np.array_equal(res_t.substeps.numpy(), np.asarray(res_j.substeps))
    assert np.array_equal(res_t.cg_ok.numpy(), np.asarray(res_j.cg_ok))
    assert bool(res_t.valid) and bool(np.all(np.asarray(res_j.valid)))


def test_shapes_bounds_and_prd_sats():
    m = _model(12, 12)
    res = simulate(m, _zeros(m), dt=0.025, nTime=8)
    assert res.wsats.shape == (9, m.Nxy)
    assert res.actual_inj_rates.shape == (1, 8) and res.actual_prd_rates.shape == (4, 8)
    s = res.wsats.numpy()
    assert s.min() >= -1e-9 and s.max() <= 1 + 1e-9
    assert torch.equal(res.prd_sats, res.wsats[1:][:, prod_inds(m)])
    slim = simulate(m, _zeros(m), dt=0.025, nTime=8, keep_wsats=False)
    assert slim.wsats.shape == (2, m.Nxy)
    assert torch.equal(slim.wsats[-1], res.wsats[-1])


def test_mass_balance_before_breakthrough():
    """Producers make pure oil until breakthrough, so the water volume grows
    by exactly dt * total injection per step."""
    m = _model(12, 12)
    res = simulate(m, _zeros(m), dt=0.025, nTime=5)
    w = res.wsats.numpy().sum(1) * m.grid.h2
    assert np.allclose(np.diff(w), 0.025, rtol=1e-6)


def test_restart_equivalence():
    m = _model(10, 10)
    full = simulate(m, _zeros(m), dt=0.025, nTime=8)
    first = simulate(m, _zeros(m), dt=0.025, nTime=4)
    second = simulate(m, first.wsats[-1], dt=0.025, nTime=4)
    assert torch.allclose(second.wsats[-1], full.wsats[-1], atol=1e-7)


def test_symmetry_uniform_K():
    """Uniform K, four injectors on the centre cells and four producers in
    mirrored corner cells: the field is symmetric under x-, y-reflection and
    transposition, to solver tolerance."""
    N = 16
    h = 1.0 / N
    c = lambda i: (i + 0.5) * h  # noqa: E731
    inj = [[c(7), c(7)], [c(8), c(7)], [c(7), c(8)], [c(8), c(8)]]
    prd = [[c(2), c(2)], [c(13), c(2)], [c(2), c(13)], [c(13), c(13)]]
    m = ResSim.build(Nx=N, Ny=N, inj_xy=inj, prd_xy=prd, inj_rates=np.ones((4, 1)) / 4,
                     prd_rates=np.ones((4, 1)) / 4, dtype=F64, device="cpu")
    s = simulate(m, _zeros(m), dt=0.02, nTime=6).wsats[-1].reshape(N, N).numpy()
    assert s.max() > 0.1
    assert np.allclose(s, s[::-1, :], atol=1e-8)
    assert np.allclose(s, s[:, ::-1], atol=1e-8)
    assert np.allclose(s, s.T, atol=1e-8)


def test_grid_index_maps():
    from historymatching_tpu.grid import Grid2D as Grid2D_j
    from historymatching_tpu_torch.grid import Grid2D

    gj, gt = Grid2D_j(Nx=10, Ny=7, Lx=2.0, Ly=1.0), Grid2D(Nx=10, Ny=7, Lx=2.0, Ly=1.0)
    x = np.array([-0.3, 0.0, 0.2, 0.999, 1.0, 1.99, 2.0, 2.5])
    y = np.array([0.5, 0.0, 0.14, 0.3, 1.0, 0.99, -0.1, 1.2])
    for a, b in zip(gt.xy2sub(x, y), gj.xy2sub(x, y)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(gt.xy2ind(x, y).numpy(), np.asarray(gj.xy2ind(x, y)))
    assert np.array_equal(gt.in_domain(x, y).numpy(), np.asarray(gj.in_domain(x, y)))
    assert np.array_equal(gt.sub2ind(3, 4).numpy(), np.asarray(gj.sub2ind(3, 4)))
    assert (gt.shape, gt.Nxy, gt.hx, gt.hy, gt.h2, gt.domain) == (
        gj.shape, gj.Nxy, gj.hx, gj.hy, gj.h2, gj.domain)
    assert all(np.array_equal(a, b) for a, b in zip(gt.mesh, gj.mesh))


def test_validate_and_validity_flag():
    m = _model(8, 8)
    with pytest.raises(ValueError, match="Unbalanced"):
        m.replace(inj_rates=[[2.0]]).validate()
    with pytest.raises(ValueError, match="outside domain"):
        m.replace(inj_xy=[[5.0, 0.5]]).validate()
    assert not bool(simulate(m.replace(inj_rates=[[2.0]]), _zeros(m), 0.01, 2).valid)
    assert not bool(simulate(m.replace(inj_xy=[[9.0, 0.5]]), _zeros(m), 0.01, 2).valid)


def test_identical_wells_per_member_give_the_shared_result_bitwise():
    mt = _model(12, 12)
    mm = set_perm(mt, torch.as_tensor(perm_fields(3, 3, mt.Nxy)))
    shared = simulate(mm, _zeros(mt), 0.025, 4)
    per = mm.replace(inj_xy=mt.inj_xy.expand(3, -1, -1), prd_xy=mt.prd_xy.expand(3, -1, -1),
                     inj_rates=mt.inj_rates.expand(3, -1, -1),
                     prd_rates=mt.prd_rates.expand(3, -1, -1))
    res = simulate(per, _zeros(mt), 0.025, 4)
    for name in ("wsats", "prd_sats", "cg_iters", "substeps", "cg_ok"):
        assert torch.equal(getattr(res, name), getattr(shared, name)), name
    assert shared.valid.shape == () and shared.actual_inj_rates.shape == (1, 4)
    assert res.valid.shape == (3,) and bool(res.valid.all())
    assert torch.equal(res.actual_prd_rates, shared.actual_prd_rates.expand(3, -1, -1))


def test_distinct_wells_per_member_match_single_runs_and_jax():
    """Each member its own K, injector, producers and time-varying rates:
    the batch equals each member run alone (1e-12) and JAX's vmap over the
    members (1e-9, as test_simulate_matches_jax_f64)."""
    mj = default_model(Nx=12, Ny=12)
    perm = perm_fields(4, 3, mj.Nxy)
    inj_xy = np.array([[[1.0, 0.5]], [[0.4, 0.3]], [[1.5, 0.7]]])
    prd_xy = np.array(mj.prd_xy)[None].repeat(3, 0)
    prd_xy[1, 2] = [0.9, 0.1]
    rates = (1.0 + 0.3 * np.cos(np.arange(5)[None, :] + np.arange(3)[:, None]))[:, None, :]
    prd_rates = np.repeat(rates / 4, 4, axis=1)
    mt = set_perm(_model(12, 12), torch.as_tensor(perm)).replace(
        inj_xy=inj_xy, prd_xy=prd_xy, inj_rates=rates, prd_rates=prd_rates)
    res = simulate(mt, _zeros(mt), 0.025, 5)
    assert res.actual_inj_rates.shape == (3, 1, 5) and res.prd_sats.shape == (3, 5, 4)
    for b in range(3):
        one = simulate(set_perm(_model(12, 12), torch.as_tensor(perm[b])).replace(
            inj_xy=inj_xy[b], prd_xy=prd_xy[b], inj_rates=rates[b], prd_rates=prd_rates[b]),
            _zeros(mt), 0.025, 5)
        assert rel_err(res.wsats[b], one.wsats) < 1e-12
        assert torch.equal(res.prd_sats[b], one.prd_sats)
        assert torch.equal(res.cg_iters[b], one.cg_iters)
    sim_j = jax.vmap(lambda p, a, b, r, q: simulate_j(
        set_perm_j(mj, p).replace(inj_xy=a, prd_xy=b, inj_rates=r, prd_rates=q),
        jnp.zeros(mj.Nxy), 0.025, 5))
    res_j = sim_j(*(jnp.asarray(a) for a in (perm, inj_xy, prd_xy, rates, prd_rates)))
    assert rel_err(res.wsats, res_j.wsats) < 1e-9
    assert rel_err(res.prd_sats, res_j.prd_sats) < 1e-9
    assert np.array_equal(res.cg_iters.numpy(), np.asarray(res_j.cg_iters))


def test_validity_and_validate_per_member():
    m = _model(8, 8)
    bad_rate = m.replace(inj_rates=[[[1.0]], [[2.0]], [[1.0]]])
    with pytest.raises(ValueError, match="Unbalanced rates of member 1"):
        bad_rate.validate()
    bad_xy = m.replace(inj_xy=[[[1.0, 0.5]], [[0.2, 0.2]], [[1.0, 1.5]]])
    with pytest.raises(ValueError, match="inj_xy outside domain of member 2"):
        bad_xy.validate()
    assert simulate(bad_rate, _zeros(m), 0.01, 2).valid.tolist() == [True, False, True]
    assert simulate(bad_xy, _zeros(m), 0.01, 2).valid.tolist() == [True, True, False]
