"""`parallel.mesh`, `forward_model(mesh=)` and the analyses and robust EnOpt
on member-sharded ensembles, across processes, on the CPU.

Each case starts `world` processes (2 or 4) that join one gloo process
group over a file store under the test's tmp_path (no network port), build
the "ens" mesh and run the legs of `__graft_entry__.dryrun_multichip` on
the port. Every rank writes what it got; the test holds each rank's
results to the same legs run without a mesh in this process.

- Float32 forward legs, at 8x8 with N = 2 * world members and nTime = 2:
  `forward_model(mesh=)` on a member-sharded DTensor (which stays
  member-sharded, compared gathered), with a replicated and with
  per-member initial states, warm starts and the `SimResult`;
  `obs_ens_fn(mesh=)`; the global and localized ES-MDA and IES on a whole
  prior with the sharded forward model; the indivisible-N `ValueError`.
  Bit for bit: a member's result is its own, whichever rank runs it.
- Float64 analysis legs on member-sharded inputs, at 8x8 with N = 4 *
  world (p = 12: the ensemble-space form on 2 ranks, the observation-space
  form on 4), nTime = 3 of dt 0.2 (water reaches the producers): ES-MDA
  global and localized (`domains=`, `taper_dom=`) with a `prng` key, IES
  and ILES over domains with member-sharded perturbations, robust StoSAG
  `GD` with X member-sharded (`robust_mean` its objective, NPV over 12
  steps), one StoSAG gradient drawn from a key, and `center`
  (`rescale=True`), `cov` and `gaussian_noise(key=, mesh=)`. Every callback's
  ensemble, every output and the stats keep N/world members a rank. Each
  leg is held to the unsharded port within 1e-10 relative: only the
  order of the sums over members differs.
- The same float64 legs against the JAX package's own, run here on
  `historymatching_tpu.parallel.mesh.ens_mesh(world)` over the suite's
  virtual CPU devices on the same numpy inputs and draws (ES-MDA's key
  draws float32 noise on both sides; GD's float64 draws go to the port as
  `Z`). Tolerance 1e-7 relative for the analyses, as the unsharded
  slices hold them (tests/test_torch_slice.py, test_torch_ies.py,
  test_torch_iles.py: pressure solves at tol 1e-10 with differently
  computed coarse inverses, statistics of a few members); GD's path and
  objectives to `lls_tol` of tests/test_torch_enopt.py, which holds the
  robust strategies unsharded so (JAX's sigma_max is a power iteration).

The workers import no JAX (they import this file, which imports none at
module level), and each has a timeout, so a hang fails the case. The JAX
legs and the unsharded run go on in this process while the workers run.

Run a worker by hand: python -m tests.test_torch_mesh RANK WORLD STORE OUT
(with OUT's directory holding the GD draws `gd_Z.npy`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

N_PER_RANK, NX, NTIME, DT = 2, 8, 2, 0.025
# The float64 analysis legs: members a rank, steps, ES-MDA key, IES/ILES
# step and iterations; robust EnOpt: NPV steps, start, chol, iterations.
F64_PER_RANK, F64_NTIME, F64_DT, KEY_MDA, XSTEP, ITERS = 4, 3, 0.2, 7, 0.4, 2
NPV_NTIME, U0, CHOL, GD_ITERS, KEY_GD = 12, (1.3, 0.6), 0.1, 2, 3
REL_UNSHARDED, REL_JAX = 1e-10, 1e-7
TIMEOUT_S = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _build_kw():
    near01 = np.array([0.12, 0.87])
    return dict(Nx=NX, Ny=NX, Lx=2.0, Ly=1.0, inj_xy=[[1.0, 0.5]],
                prd_xy=[[x, y] for y in near01 for x in 2.0 * near01], inj_rates=[[1.0]],
                prd_rates=np.ones((4, 1)) / 4)


def _model(dtype=torch.float32):
    from historymatching_tpu_torch import ResSim

    return ResSim.build(**_build_kw(), dtype=dtype, device="cpu")


def _f64_inputs(world):
    """The float64 legs' numpy inputs: prior (N, Nxy), obs (p,), perturbs
    (N, p) with the obs-error law, R12 (p, p)."""
    from historymatching_tpu_torch import temporal_R

    N, p = F64_PER_RANK * world, F64_NTIME * 4
    rng = np.random.default_rng(world)
    _, R12 = temporal_R(F64_NTIME, 4, device="cpu")
    R12 = R12.numpy()
    return dict(prior=0.3 * rng.standard_normal((N, NX * NX)),
                obs=np.clip(0.1 + 0.05 * rng.standard_normal(p), 0, 1),
                perturbs=rng.standard_normal((N, p)) @ R12.T, R12=R12)


def legs(world, mesh=None):
    """The float32 forward legs at N = N_PER_RANK * world: a dict of their
    results, gathered. With `mesh`, every forward run is split over it."""
    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.da.localization import domain_partition
    from historymatching_tpu_torch.da.update import decorrelator
    from historymatching_tpu_torch.parallel.mesh import member_mesh, replicate, shard_ens, whole
    from historymatching_tpu_torch.parallel.runner import prod_inds

    model = _model()
    N = N_PER_RANK * world
    rng = np.random.default_rng(0)
    prior = torch.as_tensor(0.3 * rng.standard_normal((N, model.Nxy)), dtype=torch.float32)
    w0 = torch.as_tensor(rng.uniform(0.0, 0.2, (N, model.Nxy)), dtype=torch.float32)
    _, R12 = ht.temporal_R(NTIME, model.nPrd, dtype=torch.float32, device="cpu")
    obs = torch.clamp(0.1 + 0.05 * torch.as_tensor(rng.standard_normal(NTIME * model.nPrd),
                                                   dtype=torch.float32), 0, 1)
    sharded = (lambda x: shard_ens(x, mesh)) if mesh else (lambda x: x)  # noqa: E731
    kw = dict(dt=DT, nTime=NTIME, mesh=mesh, maxiter=64)
    out = {}
    zeros = torch.zeros(model.Nxy)
    wsats, prods = ht.forward_model(model, sharded(prior), replicate(zeros, mesh) if mesh else zeros,
                                    **kw)
    if mesh is not None:  # member-sharded in, member-sharded out
        assert member_mesh(wsats) is mesh and member_mesh(prods) is mesh
        assert wsats.to_local().shape == (N_PER_RANK, NTIME + 1, model.Nxy)
    out["wsats"], out["prods"] = whole(wsats), whole(prods)
    w, p, pr, res = ht.forward_model(model, prior, w0, keep_pressures=True, return_sim=True,
                                     **kw)
    w2, p2, pr2 = ht.forward_model(model, prior, sharded(w0), p_init=sharded(pr),
                                   keep_pressures=True, **kw)
    out.update(wsats_w0=w, prods_w0=p, pressures=pr, wsats_warm=w2, prods_warm=p2,
               pressures_warm=pr2, **{f"sim_{k}": getattr(res, k) for k in (
                   "cg_ok", "cg_iters", "substeps", "prd_sats", "recooked")})
    out["obs_axis"] = ht.obs_ens_fn(model, DT, NTIME, mesh=mesh, nTime_axis_flat=False,
                                    maxiter=64)(prior)

    def fwd_obs(E):
        _, prods = ht.forward_model(model, E, **kw)
        return prods.reshape(prods.shape[0], -1)

    alphas = ht.mda_alphas(2, device="cpu")
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    out["es_mda"] = ht.es_mda(prior, fwd_obs, obs, R12, alphas, generator=gen())
    domains, taper_dom = domain_partition(model.grid, prod_inds(model), nTime=NTIME,
                                          steps=(4, 4), radius=1.2, dtype=torch.float32,
                                          device="cpu")
    out["es_mda_loc"] = ht.es_mda(prior, fwd_obs, obs, R12, alphas, generator=gen(),
                                  domains=domains, taper_dom=taper_dom)
    perturbs = ht.gaussian_noise(N, obs.shape[0], L=R12, generator=gen(), dtype=torch.float32,
                                 device="cpu")
    out["ies"], _ = ht.ies(prior, fwd_obs, obs, perturbs, decorrelator(R12), xStep=0.4, iMax=2)
    if mesh is not None:
        try:
            ht.forward_model(model, prior[:N - 1], **kw)
            out["indivisible"] = "no error"
        except ValueError as e:
            out["indivisible"] = str(e)
    return out


def _obj_ux(model, cfg):
    """The dryrun's conditional objective, batched: the NPV with the
    injector at U's rows and the pre-permeability fields Xb's rows."""
    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.parallel.runner import perm_transf

    def obj_ux(U, Xb):
        K = perm_transf(Xb).reshape(-1, NX, NX)
        return ht.npv_value(model, cfg, inj_xy=U.reshape(-1, 1, 2), K=torch.stack([K, K], 1))

    return obj_ux


def analysis_legs(world, gd_Z, mesh=None):
    """The float64 analysis and robust EnOpt legs at N = F64_PER_RANK *
    world, on member-sharded inputs with `mesh`: a dict of their results,
    gathered, and "local_rows", the members a rank held in every callback's
    ensemble, every output and the stats."""
    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch import prng
    from historymatching_tpu_torch.da.localization import domain_partition
    from historymatching_tpu_torch.da.update import decorrelator
    from historymatching_tpu_torch.parallel.mesh import member_mesh, shard_ens, whole
    from historymatching_tpu_torch.parallel.runner import prod_inds

    F64 = torch.float64
    model = _model(F64)
    inp = {k: torch.as_tensor(v, dtype=F64) for k, v in _f64_inputs(world).items()}
    N, R12 = inp["prior"].shape[0], inp["R12"]
    sharded = (lambda x: shard_ens(x, mesh)) if mesh else (lambda x: x)  # noqa: E731
    rows = []

    def held(x):
        """x's members on this rank, recorded; x gathered."""
        if mesh is not None:
            assert member_mesh(x) is mesh, type(x)
        rows.append(x.to_local().shape[0] if mesh is not None else x.shape[0])
        return whole(x)

    seen = lambda info: held(info["E"])  # noqa: E731
    fwd = ht.obs_ens_fn(model, F64_DT, F64_NTIME, mesh=mesh)
    alphas = ht.mda_alphas(2, dtype=F64, device="cpu")
    key = lambda k: prng.PRNGKey(k, device="cpu")  # noqa: E731
    domains, taper_dom = domain_partition(model.grid, prod_inds(model), nTime=F64_NTIME,
                                          steps=(4, 4), radius=1.2, dtype=F64, device="cpu")
    out = {}
    # the utilities on a member-sharded ensemble
    X0, x0 = ht.center(sharded(inp["prior"]), rescale=True)
    out["center"], out["center_mean"] = held(X0), x0
    out["cov"] = ht.cov(sharded(inp["prior"]), sharded(inp["perturbs"]))
    out["noise"] = held(ht.gaussian_noise(N, R12.shape[0], L=R12, key=key(KEY_MDA), mesh=mesh))
    out["es_mda"] = held(ht.es_mda(sharded(inp["prior"]), fwd, inp["obs"], R12, alphas,
                                   key=key(KEY_MDA), callback=seen))
    out["es_mda_loc"] = held(ht.es_mda(sharded(inp["prior"]), fwd, inp["obs"], R12, alphas,
                                       key=key(KEY_MDA), domains=domains, taper_dom=taper_dom,
                                       callback=seen))
    dec = decorrelator(R12)
    post, st = ht.ies(sharded(inp["prior"]), fwd, inp["obs"], sharded(inp["perturbs"]), dec,
                      xStep=XSTEP, iMax=ITERS, callback=seen)
    post_l, st_l = ht.iles_domains(sharded(inp["prior"]), fwd, inp["obs"],
                                   sharded(inp["perturbs"]), dec, taper_dom, domains,
                                   xStep=XSTEP, iMax=ITERS, callback=seen)
    for stats in (st, st_l):  # every iteration's E and Eo stay member-sharded
        for k, width in (("E", NX * NX), ("Eo", F64_NTIME * 4)):
            n = stats[k].to_local().shape if mesh is not None else stats[k].shape
            assert n == (ITERS, N // (world if mesh is not None else 1), width), (k, n)
    out["ies"], out["ies_E"] = held(post), whole(st["E"])
    out["iles_domains"], out["iles_E"] = held(post_l), whole(st_l["E"])

    X = sharded(inp["prior"])
    obj_ux = _obj_ux(model, ht.NPVConfig(dt=0.025, nTime=NPV_NTIME, rate0=1.0))
    nabla = ht.EnGrad(chol=CHOL, nEns=N, robustly="StoSAG", obj_ux=obj_ux, X=X)
    u0 = torch.tensor(U0, dtype=F64)
    out["grad_key"] = nabla(ht.robust_mean(obj_ux, X), u0, key(KEY_GD))
    path, objs, info = ht.GD(ht.robust_mean(obj_ux, X), u0, nabla=nabla, nIter=GD_ITERS,
                             Z=torch.as_tensor(gd_Z))
    out.update(gd_path=path, gd_objs=objs, gd_nIter=torch.tensor(info["nIter"]))
    out["local_rows"] = torch.tensor(rows)
    return out


def _worker(rank, world, store, out_path):
    import torch.distributed as dist

    from historymatching_tpu_torch.parallel.mesh import ens_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = ens_mesh(world, devices="cpu")
        assert mesh.mesh_dim_names == ("ens",) and mesh.size() == world
        res = legs(world, mesh)
        gd_Z = np.load(os.path.join(os.path.dirname(out_path), "gd_Z.npy"))
        res["f64"] = analysis_legs(world, gd_Z, mesh)
        res["jax_loaded"] = "jax" in sys.modules
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def jax_gd_draws(world):
    """JAX's float64 draws of `GD` from PRNGKey(KEY_GD): a split an
    iteration, (GD_ITERS, N, 2)."""
    import jax

    key, out = jax.random.PRNGKey(KEY_GD), []
    for _ in range(GD_ITERS):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (F64_PER_RANK * world, 2),
                                                dtype=np.float64)))
    return np.stack(out)


def jax_legs(world):
    """The float64 legs in the JAX package, on its mesh of `world` virtual
    CPU devices, member-sharded as `__graft_entry__.dryrun_multichip`
    shards them: numpy results."""
    import jax
    import jax.numpy as jnp

    import historymatching_tpu as hm
    from historymatching_tpu.da.localization import domain_partition
    from historymatching_tpu.da.update import decorrelator, ies, iles_domains
    from historymatching_tpu.opt.enopt import GD, EnGrad
    from historymatching_tpu.opt.npv import NPVConfig, npv_value
    from historymatching_tpu.parallel.mesh import ens_mesh, shard_ens
    from historymatching_tpu.parallel.runner import forward_model, prod_inds, set_perm

    model = hm.ResSim.build(**_build_kw())
    mesh = ens_mesh(world)
    inp = _f64_inputs(world)
    N = inp["prior"].shape[0]
    prior = lambda: shard_ens(jnp.asarray(inp["prior"]), mesh)  # noqa: E731
    R12, obs = jnp.asarray(inp["R12"]), jnp.asarray(inp["obs"])

    def fwd(E):
        _, prods = forward_model(model, E, dt=F64_DT, nTime=F64_NTIME, mesh=mesh,
                                 keep_wsats=False)
        return prods.reshape(N, -1)

    domains, taper_dom = domain_partition(model.grid, np.asarray(prod_inds(model)),
                                          nTime=F64_NTIME, steps=(4, 4), radius=1.2)
    key = jax.random.PRNGKey(KEY_MDA)
    out = {"es_mda": hm.es_mda(prior(), fwd, obs, R12, hm.mda_alphas(2), key),
           "es_mda_loc": hm.es_mda(prior(), fwd, obs, R12, hm.mda_alphas(2), key,
                                   domains=domains, taper_dom=taper_dom)}
    pert = shard_ens(jnp.asarray(inp["perturbs"]), mesh)
    out["ies"], st = ies(prior(), fwd, obs, pert, decorrelator(R12), xStep=XSTEP, iMax=ITERS)
    out["ies_E"] = st["E"]
    out["iles_domains"], st = iles_domains(prior(), fwd, obs, pert, decorrelator(R12),
                                           taper_dom, domains, xStep=XSTEP, iMax=ITERS)
    out["iles_E"] = st["E"]

    cfg = NPVConfig(dt=0.025, nTime=NPV_NTIME, rate0=1.0)
    X = prior()

    def obj_ux(u, x):
        m = set_perm(model.replace(inj_xy=u.reshape(1, 2)), x)
        return npv_value(m, cfg, wsat0=jnp.zeros(model.Nxy))

    def obj_mean(u):
        return jax.vmap(obj_ux, in_axes=(None, 0))(u, X).mean()

    nabla = EnGrad(chol=CHOL, nEns=N, robustly="StoSAG", obj_ux=obj_ux, X=X)
    path, objs, info = GD(obj_mean, jnp.asarray(U0), nabla=nabla, nIter=GD_ITERS,
                          key=jax.random.PRNGKey(KEY_GD))
    out.update(gd_path=path, gd_objs=objs, gd_nIter=info["nIter"])
    return {k: np.asarray(v) for k, v in out.items()}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_legs_match_unsharded(tmp_path, world):
    from tests.test_torch_enopt import lls_tol

    gd_Z = jax_gd_draws(world)
    np.save(tmp_path / "gd_Z.npy", gd_Z)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_mesh", str(r), str(world),
                               store, outs[r]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        ref = legs(world)
        ref64 = analysis_legs(world, gd_Z)
        ref_j = jax_legs(world)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    N64 = F64_PER_RANK * world
    ref_rows = ref64.pop("local_rows")
    for r, path in enumerate(outs):
        got = torch.load(path)
        assert got.pop("jax_loaded") is False
        assert got.pop("indivisible") == f"N={N_PER_RANK * world - 1} not divisible by mesh size {world}"
        got64 = got.pop("f64")
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (r, k)
        # every rank held N/world members in each callback, output and stats
        rows = got64.pop("local_rows")
        assert len(rows) == 2 + 2 * 2 + 2 * ITERS + 4 and bool((rows == N64 // world).all()), rows
        assert ref_rows.tolist() == [N64] * len(rows)
        assert got64.keys() == ref64.keys()
        for k, v in ref64.items():
            assert got64[k].shape == v.shape and _rel(got64[k], v) <= REL_UNSHARDED, (r, k)
    assert ref["wsats"].shape == (N_PER_RANK * world, NTIME + 1, NX * NX)
    assert torch.isfinite(ref["es_mda"]).all() and torch.isfinite(ref["ies"]).all()
    # the float64 legs against the JAX package's on its mesh
    for k in ("es_mda", "es_mda_loc", "ies", "ies_E", "iles_domains", "iles_E"):
        assert _rel(got64[k], ref_j[k]) <= REL_JAX, k
        assert _rel(got64[k], _f64_inputs(world)["prior"]) > 1e-3, k  # the analysis moved it
    tol = max(lls_tol(CHOL * (z - z.mean(0))) for z in gd_Z)
    assert int(got64["gd_nIter"]) == int(ref_j["gd_nIter"]) >= 1
    assert _rel(got64["gd_path"], ref_j["gd_path"]) <= tol
    assert _rel(got64["gd_objs"], ref_j["gd_objs"]) <= tol


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
