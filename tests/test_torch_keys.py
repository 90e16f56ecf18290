"""Port vs JAX: the random entry points with a JAX key, and the signature
gaps `center(axis=, rescale=)`, `funm_psd(sym_square=)`,
`gaussian_fields_chol` and `GD(quiet=)`, on the CPU.

The port draws with `prng`, which makes JAX's float32 normals (within one
float32 ulp; on this host bit for bit, tests/test_torch_prng.py). The JAX
package draws in the default float dtype, float64 under this suite's x64,
so every key comparison runs JAX with x64 off (`jax.enable_x64(False)`)
and the port in float32, except where the port is fed JAX's float32
normals as `Z`/`noise` (then equal bit for bit). Tolerances:
- the FFT prior: 2e-6 of the fields' scale (float32 rounding of the two
  DFTs, as tests/test_torch_prng.py's `build_case`);
- the dense prior: 2e-4 of the fields' scale (JAX's float32 Newton-Schulz
  square root against the port's eigendecomposition; measured 2.3e-5);
- EnOpt in float32: the preconditioned gradient 1e-5 relative (float32
  rounding); the least-squares gradient and GD paths 1e-4 (JAX's float32
  power-iteration sigma_max and Newton-Schulz inverse against the port's
  SVD and Cholesky: 3.5e-5 on the EnGrad case, 1.1e-5 on the paths);
  every start takes the same accepted steps;
- `center` and `funm_psd` in float64: 1e-12 relative (the same sums in
  another order; the eigenvectors of a Jacobi sweep against LAPACK's, up
  to each column's sign).
ROADMAP's F5 probes (8x8 grid) are `test_roadmap_f5_probes`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import historymatching_tpu as hm
import historymatching_tpu_torch as ht
from historymatching_tpu.da import geostat as geo_j
from historymatching_tpu.grid import Grid2D as Grid2D_j
from historymatching_tpu.opt import enopt as enopt_j
from historymatching_tpu_torch import prng
from historymatching_tpu_torch.da import geostat
from historymatching_tpu_torch.grid import Grid2D
from historymatching_tpu_torch.opt import enopt
from historymatching_tpu_torch.opt.cases import enopt_case
from tests.torch_helpers import rel_err, t64

F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def pkey(seed):
    return prng.PRNGKey(seed, device="cpu")


# -- da/geostat ---------------------------------------------------------------


@pytest.mark.parametrize("Nx,Ny,seed", [(8, 8, 1), (12, 10, 4)])
def test_sample_prior_perm_and_gaussian_fields_with_a_key(Nx, Ny, seed):
    """`sample_prior_perm(key, model, N)` and `gaussian_fields(pts, N, r,
    key=, grid=)` give JAX's fields for the same key; the key in the first
    place, as `key=`, and a generator all work; the fields equal the
    sampler fed JAX's own float32 white noise."""
    gj, gt = Grid2D_j(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0), Grid2D(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0)
    kj, kt = jax.random.PRNGKey(seed), pkey(seed)
    with jax.enable_x64(False):
        ref = np.asarray(geo_j.sample_prior_perm(kj, gj, 3))
        ref_g = np.asarray(geo_j.gaussian_fields(gj.mesh, 3, r=0.3, key=kj, grid=gj))
        k1, k2 = jax.random.split(kj)
        noise = tuple(np.asarray(jax.random.normal(k, (3, 2 * Nx, 2 * Ny))) for k in (k1, k2))
    assert ref.dtype == np.float32
    kw = dict(dtype=F32, device="cpu")
    a = ht.sample_prior_perm(kt, gt, 3, **kw)
    assert a.dtype == F32 and a.shape == (3, Nx * Ny)
    assert rel_err(a, ref) <= 2e-6
    for other in (ht.sample_prior_perm(gt, 3, key=kt, **kw), ht.sample_prior_perm(gt, N=3, key=kt, **kw),
                  ht.sample_prior_perm(kt, gt, 3, 0.8, **kw),
                  geostat.gaussian_fields_fft(gt, 3, r=0.8, noise=noise, **kw)):
        assert torch.equal(other, a)
    g = ht.gaussian_fields(gt.mesh, 3, r=0.3, key=kt, grid=gt, **kw)
    assert rel_err(g, ref_g) <= 2e-6
    gen = ht.sample_prior_perm(torch.Generator().manual_seed(0), gt, 3, **kw)
    assert torch.equal(gen, ht.sample_prior_perm(torch.Generator().manual_seed(0), gt, N=3, **kw))
    with pytest.raises(TypeError, match="twice"):
        ht.sample_prior_perm(kt, gt, 3, key=kt, **kw)


def test_gaussian_fields_dense_with_a_key():
    """`gaussian_fields_dense(key, pts, N, r)`: the port's key draws are
    JAX's float32 normals (the fields equal those of its own Z), and the
    fields are JAX's within the float32 square roots' difference; the
    alias `gaussian_fields_chol` is the dense sampler on both sides."""
    g = Grid2D(6, 5, 2.0, 1.0)
    gj = Grid2D_j(6, 5, 2.0, 1.0)
    kj, kt = jax.random.PRNGKey(11), pkey(11)
    with jax.enable_x64(False):
        ref = np.asarray(geo_j.gaussian_fields_dense(kj, gj.mesh, N=4, r=0.3))
        Z = np.asarray(jax.random.normal(kj, (4, g.Nxy)))
        ref_dispatch = np.asarray(geo_j.gaussian_fields(gj.mesh, 4, r=0.3, key=kj))
    assert geo_j.gaussian_fields_chol is geo_j.gaussian_fields_dense
    assert geostat.gaussian_fields_chol is geostat.gaussian_fields_dense
    kw = dict(dtype=F32, device="cpu")
    out = geostat.gaussian_fields_chol(kt, g.mesh, 4, 0.3, **kw)
    assert torch.equal(out, geostat.gaussian_fields_dense(g.mesh, N=4, r=0.3, Z=Z, **kw))
    assert torch.equal(out, geostat.gaussian_fields_dense(g.mesh, N=4, r=0.3, key=kt, **kw))
    assert torch.equal(out, ht.gaussian_fields(g.mesh, 4, r=0.3, key=kt, **kw))
    assert rel_err(out, ref) <= 2e-4 and rel_err(out, ref_dispatch) <= 2e-4
    # float64: the key's float32 normals, cast, through the float64 factor
    out64 = geostat.gaussian_fields_dense(kt, g.mesh, 4, 0.3, dtype=torch.float64, device="cpu")
    z64 = geostat.gaussian_fields_dense(g.mesh, N=4, r=0.3, Z=t64(Z), dtype=torch.float64,
                                        device="cpu")
    assert torch.equal(out64, z64)


@pytest.mark.parametrize("rk", [None, 5])
def test_funm_psd_sym_square_matches_jax(rk):
    """`funm_psd` in float64 with and without `sym_square`: V f(L) V' and
    the factor V f(L) (each column up to its sign) equal JAX's."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(9, 9))
    C = A @ A.T + 0.1 * np.eye(9)
    for fun_t, fun_j in ((torch.sqrt, jnp.sqrt), (lambda x: 1 / x, lambda x: 1 / x)):
        full_t = geostat.funm_psd(t64(C), fun_t, rk=rk)
        full_j = geo_j.funm_psd(jnp.asarray(C), fun_j, rk=rk)
        assert rel_err(full_t, full_j) < 1e-12
        assert torch.equal(full_t, geostat.funm_psd(t64(C), fun_t, rk=rk, sym_square=True))
        half_t = geostat.funm_psd(t64(C), fun_t, rk=rk, sym_square=False).numpy()
        half_j = np.asarray(geo_j.funm_psd(jnp.asarray(C), fun_j, rk=rk, sym_square=False))
        sign = np.sign(np.sum(half_t * half_j, axis=0))
        sign[sign == 0] = 1.0
        assert rel_err(half_t * sign, half_j) < 1e-12
        assert rel_err(half_t @ half_t.T, full_t @ full_t.T if fun_t is torch.sqrt
                       else half_j @ half_j.T) < 1e-12


# -- utils -------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("rescale", [False, True])
def test_center_axis_and_rescale_match_jax(axis, rescale):
    E = np.random.default_rng(3).normal(size=(7, 5))
    X_t, x_t = ht.center(t64(E), axis=axis, rescale=rescale)
    X_j, x_j = hm.utils.center(jnp.asarray(E), axis=axis, rescale=rescale)
    assert rel_err(X_t, X_j) < 1e-12 and rel_err(x_t, x_j) < 1e-12
    # the port's callers' `dim=` is `axis=`
    X_d, x_d = ht.center(t64(E), dim=axis, rescale=rescale)
    assert torch.equal(X_d, X_t) and torch.equal(x_d, x_t)


def test_gaussian_noise_key_and_default():
    """A key gives JAX's draws; without a key, generator or Z the draws
    are `prng.PRNGKey(0)`'s, not torch's global generator's."""
    L = np.tril(np.random.default_rng(0).normal(size=(4, 4))) + 3 * np.eye(4)
    with jax.enable_x64(False):
        ref = np.asarray(hm.gaussian_noise(jax.random.PRNGKey(5), 6, 4, L=jnp.asarray(L, jnp.float32)))
    out = ht.gaussian_noise(6, 4, L=torch.as_tensor(L, dtype=F32), key=pkey(5))
    assert np.abs(out.numpy() - ref).max() <= 2 ** -23 * np.abs(ref).max()
    torch.manual_seed(1)
    a = ht.gaussian_noise(6, 4, L=0.5, dtype=F32, device="cpu")
    torch.manual_seed(2)
    b = ht.gaussian_noise(6, 4, L=0.5, dtype=F32, device="cpu")
    assert torch.equal(a, b)
    assert torch.equal(a, ht.gaussian_noise(6, 4, L=0.5, key=pkey(0), dtype=F32, device="cpu"))


# -- opt/enopt ---------------------------------------------------------------


def quadratic_j(u):
    return jnp.mean((u - 0.3) * (u - 0.3), axis=-1)


def quadratic_t(U):
    return ((U - 0.3) ** 2).mean(-1)


def peak_j(u):
    return -jnp.sum((u - 0.3) ** 2, axis=-1)


def peak_t(U):
    return -((U - 0.3) ** 2).sum(-1)


@pytest.mark.parametrize("precond", [False, True])
def test_engrad_with_a_key(precond):
    """`EnGrad.__call__(obj, u, key)`: JAX's gradient in float32 (its draws
    bit for bit: the float64 port fed JAX's float32 normals as Z gives the
    key's gradient exactly); `prng.PRNGKey(0)` without a source."""
    u = np.array([0.4, -0.2, 0.7])
    with jax.enable_x64(False):
        g_j = np.asarray(enopt_j.EnGrad(chol=0.1, nEns=12, precond=precond)(
            peak_j, jnp.asarray(u, jnp.float32), jax.random.PRNGKey(7)))
        Z = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (12, 3)))
    ng = enopt.EnGrad(chol=0.1, nEns=12, precond=precond)
    g_t = ng(peak_t, torch.as_tensor(u, dtype=F32), pkey(7))
    assert g_t.dtype == F32 and rel_err(g_t, g_j) < (1e-5 if precond else 1e-4)
    g64 = ng(peak_t, t64(u), pkey(7))
    assert torch.equal(g64, ng(peak_t, t64(u), Z=Z))
    assert torch.equal(ng(peak_t, t64(u)), ng(peak_t, t64(u), key=pkey(0)))
    gen = ng(peak_t, t64(u), torch.Generator().manual_seed(1))  # a generator in the key's place
    assert torch.equal(gen, ng(peak_t, t64(u), generator=torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("case", ["quadratic", "peak"])
def test_gd_gd_scan_and_gd_scan_multi_with_a_key_match_jax(case):
    """GD (a split an iteration), gd_scan (the key's own chain) and
    gd_scan_multi (`split(key, nStart)`) with JAX's key: JAX's paths in
    float32, the same accepted steps; `GD(quiet=)` as JAX's."""
    obj_j, obj_t, sign = dict(quadratic=(quadratic_j, quadratic_t, -1),
                              peak=(peak_j, peak_t, +1))[case]
    U0 = np.array([[0.9, -0.5], [-1.2, 0.8], [0.35, 0.25]], np.float32)
    key, nIter = jax.random.PRNGKey(3), 12
    with jax.enable_x64(False):
        ref_gd = enopt_j.GD(obj_j, jnp.asarray(U0[1]), nabla=enopt_j.EnGrad(chol=0.1),
                            line_search=enopt_j.Backtracker(sign=sign), nIter=nIter, key=key,
                            quiet=False)
        ref_scan = enopt_j.gd_scan(obj_j, jnp.asarray(U0[1]), chol=0.1, nIter=nIter, sign=sign,
                                   key=key)
        ref_multi = enopt_j.gd_scan_multi(obj_j, jnp.asarray(U0), chol=0.1, nIter=nIter,
                                          sign=sign, key=key)
    kt = pkey(3)
    U0t = torch.as_tensor(U0)
    run_gd = enopt.GD(obj_t, U0t[1], nabla=enopt.EnGrad(chol=0.1),
                      line_search=enopt.Backtracker(sign=sign), nIter=nIter, key=kt, quiet=False)
    run_scan = enopt.gd_scan(obj_t, U0t[1], chol=0.1, nIter=nIter, sign=sign, key=kt)
    run_multi = enopt.gd_scan_multi(obj_t, U0t, chol=0.1, nIter=nIter, sign=sign, key=kt)
    for run, ref in ((run_gd, ref_gd), (run_scan, ref_scan), (run_multi, ref_multi)):
        assert run[0].dtype == F32 and run[0].shape == np.asarray(ref[0]).shape
        assert rel_err(run[0], ref[0]) < 1e-4 and rel_err(run[1], ref[1]) < 1e-4
        assert np.array_equal(np.asarray(run[2]["nIter"]), np.asarray(ref[2]["nIter"]))
    assert run_gd[2]["cause"] == ref_gd[2]["cause"] and run_scan[2] == ref_scan[2]
    # quiet changes nothing; no source is PRNGKey(0)
    again = enopt.GD(obj_t, U0t[1], nabla=enopt.EnGrad(chol=0.1),
                     line_search=enopt.Backtracker(sign=sign), nIter=nIter, key=kt, quiet=True)
    assert torch.equal(again[0], run_gd[0])
    for fn in (lambda **k: enopt.gd_scan(obj_t, U0t[1], chol=0.1, nIter=4, sign=sign, **k),
               lambda **k: enopt.gd_scan_multi(obj_t, U0t, chol=0.1, nIter=4, sign=sign, **k),
               lambda **k: enopt.GD(obj_t, U0t[1], nabla=enopt.EnGrad(chol=0.1), nIter=4,
                                    line_search=enopt.Backtracker(sign=sign), **k)):
        assert torch.equal(fn()[0], fn(key=pkey(0))[0])


def test_enopt_fixture_case_with_the_bench_key():
    """The enopt_20x20 fixture's starts and draws: gd_scan_multi with the
    bench's `k_gd` (the third of `split(PRNGKey(0), 3)`) draws the
    fixture's Z, JAX's bits, so its 30 iterations equal the run on
    `Z=case.Z` bit for bit and JAX's float32 run on the key within 1e-4;
    gd_scan and GD with a start's key (`split(k_gd, 4)`) equal the runs on
    that start's draws. The objective is a float32 quadratic peak at the
    fixture landscape's best cell (the NPV's 40 steps would take minutes
    here; chip_smoke [13] runs them)."""
    case = enopt_case(F32, "cpu")
    best = case.cells[int(np.argmax(case.landscape))]

    def obj_t(U):
        return -((U - best) ** 2).sum(-1)

    best_j = jnp.asarray(best.numpy())
    k_gd = prng.split(pkey(0), 3)[2]
    kw = dict(chol=0.1, nEns=10, nIter=30)
    by_key = ht.gd_scan_multi(obj_t, case.U0, key=k_gd, **kw)
    by_Z = ht.gd_scan_multi(obj_t, case.U0, Z=case.Z, **kw)
    assert torch.equal(by_key[0], by_Z[0]) and torch.equal(by_key[1], by_Z[1])
    assert bool((by_key[1][:, -1] > by_key[1][:, 0]).all())
    with jax.enable_x64(False):
        kj = jax.random.split(jax.random.PRNGKey(0), 3)[2]
        ref = enopt_j.gd_scan_multi(lambda u: -jnp.sum((u - best_j) ** 2, axis=-1),
                                    jnp.asarray(case.U0.numpy()), key=kj, **kw)
    assert rel_err(by_key[0], ref[0]) < 1e-4 and rel_err(by_key[1], ref[1]) < 1e-4
    assert np.array_equal(by_key[2]["nIter"], ref[2]["nIter"])
    k1 = prng.split(k_gd, 4)[1]
    one = ht.gd_scan(obj_t, case.U0[1], key=k1, **kw)
    assert torch.equal(one[0], ht.gd_scan(obj_t, case.U0[1], Z=case.Z[1], **kw)[0])
    gd = ht.GD(obj_t, case.U0[1], nabla=ht.EnGrad(chol=0.1), nIter=30, key=k1)
    assert torch.equal(gd[0], ht.GD(obj_t, case.U0[1], nabla=ht.EnGrad(chol=0.1), nIter=30,
                                    Z=case.Z[1])[0])


def test_roadmap_f5_probes():
    """ROADMAP's F5 case on an 8x8 grid: each call raised TypeError."""
    g = Grid2D(8, 8, 2.0, 1.0)
    k = pkey(1)
    kw = dict(dtype=F32, device="cpu")
    a = ht.sample_prior_perm(k, g, 3, **kw)
    assert a.shape == (3, 64) and torch.isfinite(a).all()
    assert torch.equal(ht.sample_prior_perm(g, 3, key=k, **kw), a)
    assert torch.equal(ht.gaussian_fields(g.mesh, 3, r=0.8, key=k, grid=g, **kw), a)
    path, objs, info = ht.gd_scan(peak_t, torch.tensor([0.9, -0.5]), chol=0.1, nIter=5, key=k)
    assert path.shape[1] == 2 and len(objs) == len(path) and torch.isfinite(objs).all()
