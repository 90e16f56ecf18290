"""`parallel.mesh` and `forward_model(mesh=)` across processes, on the CPU.

Each case starts `world` processes (2 or 4) that join one gloo process
group over a file store under the test's tmp_path (no network port), build
the "ens" mesh and run, at 8x8 with N = 2 * world members and nTime = 2,
the legs of `__graft_entry__.dryrun_multichip` on the port:
`forward_model(mesh=)` on a member-sharded DTensor (with a replicated and
with per-member initial states, warm starts and the `SimResult`),
`obs_ens_fn(mesh=)`, the global ES-MDA, the localized (domain) ES-MDA and
IES with the sharded forward model, and the indivisible-N `ValueError`.
Every rank writes what it got; the test holds each rank's results to the
same run without a mesh in this process, bit for bit: a member's result
is its own, whichever rank runs it, and the analyses run unchanged on the
gathered ensemble. The workers import no JAX (they import this file, which
imports none), and each has a timeout, so a hang fails the case.

Run a worker by hand: python -m tests.test_torch_mesh RANK WORLD STORE OUT
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

N_PER_RANK, NX, NTIME, DT = 2, 8, 2, 0.025
TIMEOUT_S = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model():
    from historymatching_tpu_torch import ResSim

    near01 = np.array([0.12, 0.87])
    prd_xy = [[x, y] for y in near01 for x in 2.0 * near01]
    return ResSim.build(Nx=NX, Ny=NX, Lx=2.0, Ly=1.0, inj_xy=[[1.0, 0.5]], prd_xy=prd_xy,
                        inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4, dtype=torch.float32,
                        device="cpu")


def legs(world, mesh=None):
    """The dryrun legs at N = N_PER_RANK * world: a dict of their results.
    With `mesh`, every forward run is split over it."""
    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.da.localization import domain_partition
    from historymatching_tpu_torch.da.update import decorrelator
    from historymatching_tpu_torch.parallel.mesh import replicate, shard_ens
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
    out["wsats"], out["prods"] = ht.forward_model(
        model, sharded(prior), replicate(zeros, mesh) if mesh else zeros, **kw)
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
        res["jax_loaded"] = "jax" in sys.modules
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_legs_match_unsharded(tmp_path, world):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_mesh", str(r), str(world),
                               store, outs[r]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    ref = legs(world)
    for r, path in enumerate(outs):
        got = torch.load(path)
        assert got.pop("jax_loaded") is False
        assert got.pop("indivisible") == f"N={N_PER_RANK * world - 1} not divisible by mesh size {world}"
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (r, k)
    assert ref["wsats"].shape == (N_PER_RANK * world, NTIME + 1, NX * NX)
    assert torch.isfinite(ref["es_mda"]).all() and torch.isfinite(ref["ies"]).all()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
