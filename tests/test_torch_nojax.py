"""The PyTorch port imports no JAX: it must run on a host that has none.
Checked in a subprocess with `jax` (and matplotlib, which the card's
host lacks) blocked at the finder level, like tests/test_packaging.py
blocks the optional extras: every module of the package is imported, the
port's JAX-keyed draws are made, and the simulator (with the straggler recook
engaged, and with the Chebyshev smoother), the localized ES-MDA, IES,
ILES-domains, EnOpt on the bench case's fixture, an ES-MDA resumed through
a checkpoint, a profiler trace, the member-sharded ES-MDA and IES on a
gloo world of one, EnGrad with a key, and the exact float64 oracle
(`models.oracle`, `ops.banded`, `parity.run_case(oracle=True)`) run. chip_smoke.py imports nothing of
JAX in any phase, nor does bench_gpu.py, which refuses to run without a
card."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'historymatching_tpu', 'matplotlib'):
            raise ImportError(name + ' must not be imported by the port')
        return None

sys.meta_path.insert(0, _Block())
import importlib, pkgutil
import historymatching_tpu_torch as ht
for mod in pkgutil.walk_packages(ht.__path__, 'historymatching_tpu_torch.'):
    importlib.import_module(mod.name)
# matplotlib is hidden too (the card's host has none): plotting imports it
# only where a function draws.
from historymatching_tpu_torch import plotting
assert plotting.ens_style("ES")["color"] == "C2"
try:
    plotting.spectrum([1.0, 0.5])
    raise AssertionError("plotting drew without matplotlib")
except ImportError as e:
    assert "matplotlib" in str(e)
import torch
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
m = ht.ResSim.build(Nx=8, Ny=8, dtype=torch.float64, device="cpu")
r = ht.simulate(m, torch.zeros(m.Nxy, dtype=torch.float64), 0.01, 2)
assert bool(r.cg_ok)
# The new paths run without JAX: the recook (8x8 packs 16 members a row,
# so 300 members pad to 512 and the worst 256 are recooked), the localized
# ES-MDA and IES, on a linear forward operator.
from historymatching_tpu_torch.parallel.runner import set_perm
g = torch.Generator().manual_seed(0)
mm = set_perm(m, 0.3 * torch.randn(300, m.Nxy, generator=g, dtype=torch.float64))
r = ht.simulate(mm, torch.zeros(m.Nxy, dtype=torch.float64), 0.01, 2, maxiter=128)
per_step = r.recooked.sum(0)
assert bool(((per_step > 0) & (per_step <= 256)).all()) and bool(r.cg_ok.all())
dom, tap = ht.localization.domain_partition(m.grid, [9, 54], nTime=3, steps=(4, 4),
                                            device="cpu")
G = torch.randn(m.Nxy, 6, generator=g, dtype=torch.float64) / 8
E0 = torch.randn(10, m.Nxy, generator=g, dtype=torch.float64)
_, R12 = ht.temporal_R(3, 2, device="cpu")
obs = torch.zeros(6, dtype=torch.float64)
post = ht.es_mda(E0, lambda E: E @ G, obs, R12, ht.mda_alphas(2, dtype=torch.float64,
                 device="cpu"), generator=g, domains=dom, taper_dom=tap)
post_ies, _ = ht.ies(E0, lambda E: E @ G, obs, 0.1 * torch.randn(10, 6, generator=g,
                     dtype=torch.float64), torch.eye(6, dtype=torch.float64) * 10, iMax=2)
assert bool(torch.isfinite(post).all() & torch.isfinite(post_ies).all())
# EnOpt without JAX: the bench case's fixture loads, and a batch with one
# injector a member, gd_scan_multi on the fixture's draws and robust GD
# (StoSAG, its two halves one batch) run on it, at 2 of its 40 steps.
from historymatching_tpu_torch.opt.cases import enopt_case
case = enopt_case(torch.float64, "cpu")
assert case.landscape.shape == (400,) and case.Z.shape == (4, 30, 10, 2)
em, cfg = case.model, case.cfg.replace(nTime=2)
obj = lambda U: ht.npv_value(em, cfg, inj_xy=U.reshape(-1, 1, 2))
v = obj(case.cells[:3])
assert v.shape == (3,) and bool(torch.isfinite(v).all())
paths, objs, info = ht.gd_scan_multi(obj, case.U0[:2], chol=0.1, nEns=3, nIter=1,
                                     xSteps=(0.5, 0.25), Z=case.Z[:2, :1, :3])
assert paths.shape == (2, 2, 2) and bool(torch.isfinite(objs).all())
X = 0.1 + torch.exp(5 * ht.sample_prior_perm(g, em.grid, 3, dtype=torch.float64, device="cpu"))
obj1 = lambda U, Xb: ht.npv_value(em, cfg, inj_xy=U.reshape(-1, 1, 2),
                                  K=Xb.reshape(-1, 1, 20, 20).expand(-1, 2, 20, 20))
robust = lambda U: obj1(U.repeat_interleave(3, 0), X.repeat(len(U), 1)).reshape(-1, 3).mean(1)
path, objs, info = ht.GD(robust, case.U0[0], nabla=ht.EnGrad(chol=0.1, nEns=3, robustly="StoSAG",
                         obj_ux=obj1, X=X), nIter=1, generator=g)
assert bool(torch.isfinite(objs).all()) and info["nEvals"] >= 1 + 6
# This slice's paths without JAX: a Chebyshev-smoothed simulation, an
# iles_domains step, and an ES-MDA resumed through a checkpoint; the
# checkpoint and profiling modules import (walk_packages above) and run.
from historymatching_tpu_torch import checkpoint, profiling
r = ht.simulate(set_perm(m, 0.3 * torch.randn(4, m.Nxy, generator=g, dtype=torch.float64)),
                torch.zeros(m.Nxy, dtype=torch.float64), 0.01, 2, smoother="cheb")
assert bool(r.cg_ok.all())
post_il, st = ht.iles_domains(E0, lambda E: E @ G, obs, 0.1 * torch.randn(10, 6, generator=g,
                              dtype=torch.float64), torch.eye(6, dtype=torch.float64) * 10,
                              tap, dom, iMax=1)
assert bool(torch.isfinite(post_il).all()) and st["pinv_domains"].tolist() == [0]
import os, tempfile
alphas = ht.mda_alphas(3, dtype=torch.float64, device="cpu")
fwd = lambda E: E @ G
ref = ht.es_mda(E0, fwd, obs, R12, alphas, generator=torch.Generator().manual_seed(1))
path = os.path.join(tempfile.mkdtemp(), "mda.npz")
def cb(info):
    if info["pass_"] == 1:
        checkpoint.save_checkpoint(path, {"E": info["E"], "gen": info["generator_state"]})
ht.es_mda(E0, fwd, obs, R12, alphas, generator=torch.Generator().manual_seed(1), callback=cb)
st = checkpoint.load_checkpoint(path)
gen = torch.Generator()
gen.set_state(torch.from_numpy(st["gen"]))
assert torch.equal(ht.es_mda(torch.from_numpy(st["E"]), fwd, obs, R12, alphas, generator=gen,
                             start_pass=1), ref)
with profiling.trace(tempfile.mkdtemp()) as d:
    E0.sum()
assert profiling.parse_trace(d).host
from historymatching_tpu_torch import prng, parity
assert prng.split(prng.PRNGKey(0, device="cpu")).tolist() == [[1797259609, 2579123966], [928981903, 3453687069]]
case = parity.build_case(1, 4, 8, 8, nTime=3, device="cpu")
assert case["prior"].shape == (4, 64) and case["prior"].dtype == torch.float32
# Member-sharded analyses on a gloo world of one (ens_mesh makes it): the
# ensemble stays a DTensor, and the run does the unsharded run's operations
# in the same order, so the posteriors are equal; EnGrad draws from a key.
import torch.distributed as dist
from historymatching_tpu_torch.parallel.mesh import ens_mesh, member_map, shard_ens
mesh = ens_mesh(devices="cpu")
try:
    fwd_s = lambda E: member_map(lambda x: x @ G, E)
    a2 = ht.mda_alphas(2, dtype=torch.float64, device="cpu")
    k = prng.PRNGKey(2, device="cpu")
    post_s = ht.es_mda(shard_ens(E0, mesh), fwd_s, obs, R12, a2, key=k, domains=dom,
                       taper_dom=tap)
    assert post_s.to_local().shape == E0.shape
    assert torch.equal(post_s.full_tensor(), ht.es_mda(E0, fwd, obs, R12, a2, key=k, domains=dom,
                                                       taper_dom=tap))
    pert = 0.1 * torch.randn(10, 6, generator=g, dtype=torch.float64)
    dec = torch.eye(6, dtype=torch.float64) * 10
    ies_s, st_s = ht.ies(shard_ens(E0, mesh), fwd_s, obs, shard_ens(pert, mesh), dec, iMax=2)
    assert torch.equal(ies_s.full_tensor(), ht.ies(E0, fwd, obs, pert, dec, iMax=2)[0])
    gk = ht.EnGrad(chol=0.1, nEns=4)(lambda U: -(U * U).sum(-1),
                                     torch.tensor([0.3, 0.2], dtype=torch.float64), k)
    assert torch.equal(gk, ht.EnGrad(chol=0.1, nEns=4)(lambda U: -(U * U).sum(-1),
                       torch.tensor([0.3, 0.2], dtype=torch.float64), key=k))
finally:
    dist.destroy_process_group()
# The exact float64 oracle without JAX: the banded solve against the
# stencil's operator, and a forward run through parity's oracle path.
from historymatching_tpu_torch import ops
from historymatching_tpu_torch.models import oracle
from historymatching_tpu_torch.ops.banded import banded_solve
TX, TY = ops.transmissibilities(torch.ones(8, 8, dtype=torch.float64),
                                torch.ones(8, 8, dtype=torch.float64), 0.1, 0.1)
ab = oracle.banded_operator(TX, TY, ops.stencil_diag(TX, TY))[None]
qq = torch.randn(1, 64, generator=g, dtype=torch.float64)
assert float((oracle.banded_matvec(ab, banded_solve(ab, qq)) - qq).abs().max()) < 1e-12
_, prods_o = oracle.forward_oracle(m, torch.zeros(2, 64, dtype=torch.float64), dt=0.01, nTime=2)
assert prods_o.shape == (2, 2, 1) and prods_o.dtype == torch.float64
out = parity.run_case("es_mda", 1, 4, 8, 8, nTime=2, sched=[{}] * 2, dtype=torch.float64,
                      device="cpu", oracle=True)
assert out["rmse_post"][0] > 0
print('port-import-ok')
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "port-import-ok" in r.stdout


def test_chip_smoke_imports_no_jax():
    """Every import statement of chip_smoke.py, the EnOpt phases' included,
    names neither JAX nor the JAX package."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "historymatching_tpu_torch.opt.cases" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "historymatching_tpu")]


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    card, and where the port's package is not beside it."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    for cwd in (REPO, str(tmp_path)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                           text=True, timeout=300,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                    OMP_NUM_THREADS="1"))
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_bench_gpu_imports_no_jax_and_needs_a_card():
    """bench_gpu.py imports neither JAX nor the JAX package, and raises
    where there is no card (no CPU fallback)."""
    import ast

    with open(os.path.join(REPO, "bench_gpu.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "historymatching_tpu_torch" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "historymatching_tpu")]
    r = subprocess.run([sys.executable, "bench_gpu.py", "--out", "_no_card_"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"))
    assert r.returncode != 0 and "CUDA device" in r.stderr
    assert not os.path.exists(os.path.join(REPO, "_no_card_"))
