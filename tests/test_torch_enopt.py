"""Port vs JAX: EnOpt (opt/enopt.py), float64 on the CPU, the port fed the
JAX package's own draws.

Tolerances: the port's `rinv_tikh` takes sigma_max exactly (an SVD) where
the JAX package runs 24 power iterations, and solves by Cholesky where the
JAX package runs Newton-Schulz. Where the power iteration has converged
the two agree to 1e-9 relative, so LLS gradients are held to 1e-9 and
paths and objectives of the toys to 1e-8. Where the two largest singular
values are close it has not: a sigma_max short by d (relative) moves
each Tikhonov factor s / (s^2 + r^2) by up to 2 d r^2 / (s^2 + r^2), and
`lls_tol` holds the gradient to that (in max norm, times sqrt(M)).

`python -m tests.test_torch_enopt --write-fixture` writes the port's
`data/enopt_20x20.npz` (see `historymatching_tpu_torch/opt/cases.py`).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu import utils as utils_j
from historymatching_tpu.grid import Grid2D as Grid2D_j
from historymatching_tpu.models.ressim import ResSim as ResSim_j
from historymatching_tpu.ops.linalg import rinv_tikh as rinv_tikh_j
from historymatching_tpu.opt import enopt as enopt_j
from historymatching_tpu.opt.npv import NPVConfig as NPVConfig_j
from historymatching_tpu.opt.npv import npv_value as npv_value_j
from historymatching_tpu_torch import convert, utils
from historymatching_tpu_torch.ops.linalg import rinv_tikh
from historymatching_tpu_torch.opt import enopt
from historymatching_tpu_torch.opt.cases import enopt_case
from historymatching_tpu_torch.opt.npv import NPVConfig, npv_value
from tests.torch_helpers import default_model, rel_err, t64

NS, NITER, NENS = 4, 30, 10  # the bench's gd_scan_multi
F64 = torch.float64


def jax_gd_draws(key, nIter, nEns, M, dtype):
    """The standard-normal draws of `GD` / `gd_scan` from `key`: each
    iteration splits the key and draws (nEns, M). (nIter, nEns, M)."""
    out = []
    for _ in range(nIter):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (nEns, M), dtype=dtype)))
    return np.stack(out)


def jax_bench_draws():
    """The JAX bench's draws for its EnOpt case (bench._enopt_fields):
    perm, U0 and each start's per-iteration draws of `gd_scan_multi`. The
    bench runs without x64, so everything is drawn with an explicit
    float32 dtype (under x64 the default dtype would change the bits a key
    gives). Under x64 the FFT sampler takes the spectrum's square root in
    float64 before the cast, so `perm` differs from a run without x64 by
    up to one float32 ulp (2.4e-7 in 187 of 400 cells); `U0` and `Z` are
    the same bits."""
    from historymatching_tpu.da.geostat import gaussian_fields_fft

    k_perm, k_u0, k_gd = jax.random.split(jax.random.PRNGKey(0), 3)
    grid = Grid2D_j(Nx=20, Ny=20, Lx=2.0, Ly=1.0)
    perm = gaussian_fields_fft(k_perm, grid, N=1, r=0.8, dtype=jnp.float32)[0]
    U0 = jax.random.uniform(k_u0, (NS, 2), dtype=jnp.float32) * jnp.array([2.0, 1.0],
                                                                          jnp.float32)
    Z = np.stack([jax_gd_draws(k, NITER, NENS, 2, jnp.float32)
                  for k in jax.random.split(k_gd, NS)])
    return np.asarray(perm), np.asarray(U0), Z


def jax_bench_model(perm):
    """The bench's EnOpt model in JAX, float64, K from `perm` cast to
    float64, and its NPVConfig."""
    Lx, Ly, rate0 = 2.0, 1.0, 1.5
    near01 = np.array([0.12, 0.87])
    K = (0.1 + jnp.exp(5 * jnp.asarray(perm, jnp.float64))).reshape(20, 20)
    model = ResSim_j.build(
        Nx=20, Ny=20, Lx=Lx, Ly=Ly, K=jnp.stack([K, K]), inj_xy=[[Lx / 2, Ly / 2]],
        prd_xy=[[x, y] for y in Ly * near01 for x in Lx * near01],
        inj_rates=rate0 * np.ones((1, 1)), prd_rates=rate0 * np.ones((4, 1)) / 4)
    return model, NPVConfig_j(dt=0.025, nTime=40, rate0=rate0)


def jax_landscape(perm, cells):
    """The JAX package's float64 NPV with the injector at each of `cells`."""
    model, cfg = jax_bench_model(perm)
    f = jax.jit(jax.vmap(lambda u: npv_value_j(model, cfg, inj_xy=u.reshape(1, 2))))
    return np.asarray(f(jnp.asarray(cells, jnp.float64)))


def write_fixture():
    from historymatching_tpu_torch.opt.cases import FIXTURE, cell_centres

    perm, U0, Z = jax_bench_draws()
    cells = cell_centres(torch.float64, "cpu").numpy()
    land = jax_landscape(perm, cells)
    np.savez_compressed(FIXTURE, perm=perm, U0=U0, Z=Z, landscape=land)
    print(f"wrote {FIXTURE}: max {land.max():.6f} at cell {int(land.argmax())}, "
          f"{int((land == 0).sum())} zeroed")


def perm_gap():
    """Print how far the fixture's draws lie from the bench's own, drawn as
    the bench draws them, without x64."""
    from historymatching_tpu_torch.opt.cases import FIXTURE

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    f = np.load(FIXTURE)
    perm, U0, Z = jax_bench_draws()
    d = np.abs(perm.astype(np.float64) - f["perm"])
    print(f"perm: max |d| {d.max():.3e} in {int((d > 0).sum())} of {d.size} cells; "
          f"U0 equal {np.array_equal(U0, f['U0'])}, Z equal {np.array_equal(Z, f['Z'])}")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- toys, on both sides ------------------------------------------------------


def quadratic_j(u):
    return jnp.mean(u * u, axis=-1)


def quadratic_t(U):
    return (U * U).mean(-1)


def rosenbrock_j(u):
    u = u * 3.0
    t1, t2 = u[..., 1:] - u[..., :-1] ** 2, u[..., :-1] - 1
    return jnp.sum(100 * t1 * t1 + t2 * t2, axis=-1)


def rosenbrock_t(U):
    U = U * 3.0
    t1, t2 = U[..., 1:] - U[..., :-1] ** 2, U[..., :-1] - 1
    return (100 * t1 * t1 + t2 * t2).sum(-1)


def peak_j(u):
    return -jnp.sum((u - 0.3) ** 2, axis=-1)


def peak_t(U):
    return -((U - 0.3) ** 2).sum(-1)


def _same_run(port, ref, tol=1e-8):
    """Paths and objectives to `tol`, and nIter, of a port run and a JAX
    run."""
    (p_t, o_t, i_t), (p_j, o_j, i_j) = port, ref
    assert p_t.shape == np.asarray(p_j).shape, (p_t.shape, np.asarray(p_j).shape)
    assert rel_err(p_t, p_j) <= tol and rel_err(o_t, o_j) <= tol
    assert np.array_equal(np.asarray(i_t["nIter"]), np.asarray(i_j["nIter"]))


def lls_tol(dU, reg=0.1):
    """The tolerance of an LLS gradient on perturbations `dU` against
    JAX's, from the short fall of its power-iteration sigma_max."""
    from historymatching_tpu.ops.linalg import sigma_max

    s = np.linalg.svd(dU, compute_uv=False)
    d = abs(1 - float(sigma_max(jnp.asarray(dU))) / s[0])
    r2 = (reg * s[0]) ** 2
    return 1e-9 + np.sqrt(dU.shape[1]) * 2 * d * np.max(r2 / (s**2 + r2))


# -- the fixture ---------------------------------------------------------------


def test_fixture_matches_a_fresh_jax_draw_and_landscape():
    """The committed draws equal a fresh draw, and the committed float64
    landscape equals JAX's at three cells (1e-10): its argmax, the corner
    cell and the centre cell. The port's loader builds the bench's model."""
    f = np.load(enopt_case.__globals__["FIXTURE"])
    perm, U0, Z = jax_bench_draws()
    for name, fresh in (("perm", perm), ("U0", U0), ("Z", Z)):
        assert f[name].dtype == np.float32 and np.array_equal(f[name], fresh), name
    land = f["landscape"]
    cells = [int(np.argmax(land)), 0, 10 * 20 + 10]
    case = enopt_case(F64, "cpu")
    assert case.cells.shape == (400, 2) and case.Z.shape == (NS, NITER, NENS, 2)
    ref = jax_landscape(perm, case.cells[cells].numpy())
    assert np.max(np.abs(ref - land[cells]) / np.abs(land[cells])) < 1e-10
    mj, _ = jax_bench_model(perm)
    assert rel_err(case.model.K, mj.K) < 1e-15  # two exp implementations, ulps apart
    assert np.array_equal(case.model.prd_xy.numpy(), np.asarray(mj.prd_xy))
    assert case.cfg == convert.npv_config(jax_bench_model(perm)[1])


# -- linear algebra ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(10, 2), (20, 3), (31, 2)])
def test_rinv_tikh_and_rinv_match_jax(shape):
    A = np.random.default_rng(shape[0]).normal(size=shape)
    A -= A.mean(0)
    assert rel_err(rinv_tikh(t64(A), 0.1), rinv_tikh_j(jnp.asarray(A), 0.1)) < 1e-9
    for kw in (dict(), dict(tikh=False), dict(tikh=False, nMax=1)):
        assert rel_err(utils.rinv(t64(A), 0.1, **kw), utils_j.rinv(jnp.asarray(A), 0.1, **kw)) < 1e-10
    # batched: each matrix of a stack as alone
    B = t64(np.stack([A, 2 * A]))
    assert rel_err(rinv_tikh(B, 0.1)[1], rinv_tikh(B[1], 0.1)) < 1e-12


def test_pcircle_and_mesh2list_match_jax():
    for deg in (0, 45, 135, -90, 200):
        assert utils.pCircle(deg, 2.0, 1.0) == utils_j.pCircle(deg, 2.0, 1.0)
    mesh = np.meshgrid(np.arange(3.0), np.arange(4.0), indexing="ij")
    assert np.array_equal(utils.mesh2list(*mesh, device="cpu").numpy(),
                          np.asarray(utils_j.mesh2list(*mesh)))


# -- gradient and line search --------------------------------------------------


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("matrix_chol", [False, True])
def test_engrad_matches_jax_with_its_draws(precond, matrix_chol):
    key = jax.random.PRNGKey(7)
    u = np.array([0.4, -0.2, 0.7])
    chol = np.array([[0.1, 0, 0], [0.02, 0.08, 0], [0, 0.03, 0.12]]) if matrix_chol else 0.1
    g_j = enopt_j.EnGrad(chol=chol, nEns=12, precond=precond)(rosenbrock_j, jnp.asarray(u), key)
    Z = np.array(jax.random.normal(key, (12, 3), dtype=jnp.float64))
    g_t = enopt.EnGrad(chol=t64(chol), nEns=12, precond=precond)(rosenbrock_t, t64(u), Z=Z)
    assert rel_err(g_t, g_j) < 1e-9


def test_robust_strategies_match_jax():
    """Each robust strategy on a toy obj_ux against JAX with its draws;
    StoSAG's two halves are one call of 2 nEns rows."""
    kX, kg = jax.random.split(jax.random.PRNGKey(4))
    nEns = 16
    X = np.asarray(0.1 * jax.random.normal(kX, (nEns, 2)) + jnp.array([1.0, 0.0]))

    def obj_ux_j(u, x):
        return -jnp.sum((u - x) ** 2) + 0.3 * jnp.sin(u[0] * x[0])

    calls = []

    def obj_ux_t(U, Xb):
        calls.append(len(U))
        return -((U - Xb) ** 2).sum(-1) + 0.3 * torch.sin(U[:, 0] * Xb[:, 0])

    def obj_j(u):
        return jnp.mean(jax.vmap(lambda x: obj_ux_j(u, x))(jnp.asarray(X)))

    def obj_t(U):
        n = len(U)
        return obj_ux_t(U.repeat_interleave(nEns, 0), t64(X).repeat(n, 1)).reshape(n, nEns).mean(1)

    u = np.array([0.1, 0.2])
    Z = np.array(jax.random.normal(kg, (nEns, 2), dtype=jnp.float64))
    tol = lls_tol(0.1 * (Z - Z.mean(0)))  # here sigma_2 / sigma_1 = 0.96: tol ~ 1.3e-3
    for strategy in [None, "Paired", "StoSAG", "Mean-model"]:
        ng_j = enopt_j.EnGrad(chol=0.1, nEns=nEns, robustly=strategy, obj_ux=obj_ux_j,
                              X=jnp.asarray(X))
        ng_t = enopt.EnGrad(chol=0.1, nEns=nEns, robustly=strategy, obj_ux=obj_ux_t, X=t64(X))
        calls.clear()
        g_t = ng_t(obj_t, t64(u), Z=Z)
        assert rel_err(g_t, ng_j(obj_j, jnp.asarray(u), kg)) < tol, strategy
        if strategy == "StoSAG":
            assert calls == [2 * nEns]
    with pytest.raises(ValueError, match="pairs members"):
        enopt.EnGrad(nEns=4, robustly="Paired", obj_ux=obj_ux_t, X=t64(X))(obj_t, t64(u), Z=Z[:4])
    with pytest.raises(ValueError, match="Unknown robust"):
        enopt.EnGrad(nEns=4, robustly="bogus", X=t64(X))(obj_t, t64(u), Z=Z[:4])


def test_backtracker_accept_first_matches_jax():
    """Maximise -u^2 from u0 = 0.2 along -1: the first step (0.5)
    overshoots, the second (0.25) is taken: nDeclined 1, as in JAX."""
    bt_t, bt_j = enopt.Backtracker(sign=+1), enopt_j.Backtracker(sign=+1)
    obj_j = lambda u: -jnp.sum(u * u, axis=-1)  # noqa: E731
    obj_t = lambda U: -(U * U).sum(-1)  # noqa: E731
    u1, J1, info = bt_t(obj_t, t64([0.2]), -0.04, t64([-1.0]))
    u1_j, J1_j, info_j = bt_j(obj_j, jnp.array([0.2]), -0.04, jnp.array([-1.0]))
    assert info == info_j == dict(nDeclined=1)
    assert np.isclose(float(u1[0]), -0.05) and rel_err(u1, u1_j) < 1e-15 and J1 == J1_j
    assert bt_t(obj_t, t64([0.0]), 0.0, t64([1.0])) is None


# -- optimisers ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["quadratic", "quadratic-precond", "rosenbrock"])
def test_gd_matches_jax_with_its_draws(case):
    obj_j, obj_t, u0, nEns, chol, nIter = dict(
        quadratic=(quadratic_j, quadratic_t, [0.8, -0.6], 20, 0.1, 50),
        **{"quadratic-precond": (quadratic_j, quadratic_t, [0.5, 0.5], 20, 0.1, 50)},
        rosenbrock=(rosenbrock_j, rosenbrock_t, [-0.7, 0.9], 30, 0.05, 25))[case]
    precond = case.endswith("precond")
    key = jax.random.PRNGKey(42)
    ref = enopt_j.GD(obj_j, jnp.asarray(u0), nabla=enopt_j.EnGrad(chol=chol, nEns=nEns,
                                                                  precond=precond),
                     line_search=enopt_j.Backtracker(sign=-1), nIter=nIter, key=key)
    seen = []
    run = enopt.GD(obj_t, t64(u0), nabla=enopt.EnGrad(chol=chol, nEns=nEns, precond=precond),
                   line_search=enopt.Backtracker(sign=-1), nIter=nIter,
                   Z=jax_gd_draws(key, nIter, nEns, 2, jnp.float64), callback=seen.append)
    _same_run(run, ref)
    assert run[2]["cause"] == ref[2]["cause"] and run[2]["nEvals"] == ref[2]["nEvals"]
    assert len(seen) == len(run[0]) - 1 + (run[2]["cause"] == "GD converged")
    assert bool((torch.diff(run[1]) <= 0).all())


def test_gd_scan_and_gd_scan_multi_match_jax():
    """gd_scan_multi against JAX's full trip count, with starts that stop
    at different iterations: done starts leave the batch (the calls
    shrink) and the arrays still equal JAX's, rows frozen past each
    start's nIter. gd_scan is its one-start case."""
    key = jax.random.PRNGKey(3)
    U0 = np.array([[0.9, -0.5], [-1.2, 0.8], [0.35, 0.25]])
    nIter = 30
    paths_j, objs_j, info_j = enopt_j.gd_scan_multi(peak_j, jnp.asarray(U0), chol=0.1, nIter=nIter,
                                                    key=key)
    Z = np.stack([jax_gd_draws(k, nIter, 10, 2, jnp.float64) for k in jax.random.split(key, 3)])
    sizes = []
    obj = lambda U: (sizes.append(len(U)), peak_t(U))[1]  # noqa: E731
    paths, objs, info = enopt.gd_scan_multi(obj, t64(U0), chol=0.1, nIter=nIter, Z=Z)
    assert paths.shape == (3, nIter + 1, 2) and objs.shape == (3, nIter + 1)
    _same_run((paths, objs, info), (paths_j, objs_j, info_j))
    assert info["cause"] == info_j["cause"] and np.array_equal(info["nEvals"], info_j["nEvals"])
    n = info["nIter"]
    assert len(set(n.tolist())) > 1 and n.max() < nIter  # stop at different iterations
    for i in range(3):
        assert torch.equal(paths[i, n[i]:], paths[i, n[i]].expand(nIter + 1 - n[i], 2))
    assert sizes[0] == 3 and min(sizes) < 3 * 8 and len(sizes) == 1 + 2 * (n.max() + 1)
    p1, o1, i1 = enopt.gd_scan(peak_t, t64(U0[1]), chol=0.1, nIter=nIter, Z=Z[1])
    assert torch.equal(p1, paths[1, : n[1] + 1]) and torch.equal(o1, objs[1, : n[1] + 1])
    ref1 = enopt_j.gd_scan(peak_j, jnp.asarray(U0[1]), chol=0.1, nIter=nIter,
                           key=jax.random.split(key, 3)[1])
    assert i1 == ref1[2]


def test_gd_scan_multi_npv_matches_jax_with_its_draws():
    """One NPV case: two starts moving the injector of a 12x12 model,
    float64, JAX's draws."""
    mj = default_model(Nx=12, Ny=12)
    mt = convert.ressim_from_reference(mj, dtype=F64, device="cpu")
    cfg_j, cfg_t = NPVConfig_j(dt=0.025, nTime=5), NPVConfig(dt=0.025, nTime=5)
    U0 = np.array([[0.5, 0.3], [1.6, 0.6]])
    key, kw = jax.random.PRNGKey(1), dict(chol=0.1, nEns=6, nIter=3, xSteps=(0.5, 0.25, 0.125))
    ref = enopt_j.gd_scan_multi(lambda u: npv_value_j(mj, cfg_j, inj_xy=u.reshape(1, 2)),
                                jnp.asarray(U0), key=key, **kw)
    Z = np.stack([jax_gd_draws(k, 3, 6, 2, jnp.float64) for k in jax.random.split(key, 2)])
    run = enopt.gd_scan_multi(lambda U: npv_value(mt, cfg_t, inj_xy=U.reshape(-1, 1, 2)),
                              t64(U0), Z=Z, **kw)
    _same_run(run, ref, tol=1e-9)
    assert (run[1][:, -1] > run[1][:, 0]).all()


def test_zero_and_non_finite_gradients():
    """A flat objective: GD stops as converged, gd_scan freezes at its
    start. A non-finite gradient: JAX's GD calls that converged too; the
    port's has a cause of its own. Both differ from JAX in nEvals only by
    the line search that never ran (JAX counts it)."""
    key = jax.random.PRNGKey(0)
    Z = jax_gd_draws(key, 5, 10, 2, jnp.float64)
    flat_j = lambda u: 0.0 * jnp.sum(u, axis=-1)  # noqa: E731
    flat_t = lambda U: 0.0 * U.sum(-1)  # noqa: E731
    u0 = np.array([1.0, 2.0])
    nan_j = lambda u: jnp.where(jnp.all(u == jnp.asarray(u0), -1), 0.0, jnp.nan)  # noqa: E731
    nan_t = lambda U: torch.where((U == t64(u0)).all(-1), 0.0, torch.nan)  # noqa: E731
    for (obj_j, obj_t), cause in (((flat_j, flat_t), "GD converged"),
                                  ((nan_j, nan_t), "GD stopped: non-finite gradient")):
        p_j, o_j, i_j = enopt_j.GD(obj_j, jnp.asarray(u0), nIter=5, key=key)
        p_t, o_t, i_t = enopt.GD(obj_t, t64(u0), nIter=5, Z=Z)
        _same_run((p_t, o_t, i_t), (p_j, o_j, i_j), tol=0)
        assert len(p_t) == 1 and i_j["cause"] == "GD converged" and i_t["cause"] == cause
        assert (i_j["nEvals"], i_t["nEvals"]) == (1 + 10 + 8, 1 + 10)
        p_s, o_s, i_s = enopt.gd_scan(obj_t, t64(u0), nIter=5, Z=Z)
        assert i_s["nIter"] == 0 and torch.equal(p_s, t64(u0)[None])
        assert i_s == enopt_j.gd_scan(obj_j, jnp.asarray(u0), nIter=5, key=key)[2]


def test_gd_scan_multi_with_a_generator():
    """Draws from a torch.Generator: a seed gives one run, on the device
    of the controls (here the CPU)."""
    runs = [enopt.gd_scan_multi(peak_t, t64([[0.9, -0.5], [0.0, 1.0]]), chol=0.1, nIter=10,
                                generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(runs[0][0], runs[1][0]) and not torch.equal(runs[0][0], runs[2][0])
    assert bool((runs[0][1][:, -1] > runs[0][1][:, 0]).all())


if __name__ == "__main__":
    if "--write-fixture" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        write_fixture()
    elif "--perm-gap" in sys.argv:
        perm_gap()
