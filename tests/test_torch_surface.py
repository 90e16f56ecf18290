"""The port's public surface against the JAX package's, and the V-cycle
preconditioner closure `ops.multigrid.vcycle_solver`.

The walk reads each module of the JAX package with `ast` (nothing of it is
imported for the walk) and takes its public names: module-level functions,
classes and assignments, and in a package's `__init__` its re-exports. Each
must exist in the port's module of the same path, under the same name, or
under the name of the port's counterpart for the two Pallas modules. The
only exclusions are ROADMAP.md's "Do not port" list.

Tolerances (float64 on the CPU): the closure against the JAX one on the
same coarse inverse 1e-12 relative (the V-cycle's sums of 2 or 4 terms in
possibly another order, as tests/test_torch_multigrid.py); with each side's
own coarse inverse 1e-8 (Cholesky against Newton-Schulz, as there); PCG
preconditioned by the closure against the JAX `pcg` with the JAX closure,
on the same coarse inverse, the same iteration counts and 1e-9 relative on
the solution (as tests/test_torch_pressure.py's `pcg` check)."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops import cg as cg_j
from historymatching_tpu.ops import multigrid as mg_j
from historymatching_tpu.ops.stencil import stencil_matvec as matvec_j
from historymatching_tpu_torch.ops import cg as cg_t
from historymatching_tpu_torch.ops import multigrid as mg_t
from historymatching_tpu_torch.ops.stencil import stencil_matvec as matvec_t
from tests.torch_helpers import default_model, perm_fields, rel_err, scaled_system, t64

JAX_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "historymatching_tpu")

# ROADMAP.md, "Do not port": whole modules, and names by module.
NOT_PORTED_MODULES = {"ops.packed", "models.oracle"}
NOT_PORTED = {
    "ops.linalg": {"svd", "eigh_psd", "sqrtm_psd", "pinv", "sigma_max"},
    "ops.multigrid": {"pack_hierarchy", "pack_coarse_inv", "vcycle_apply_packed"},
    "ops.cg": {"pcg_batched"},
}
# The Pallas modules' counterparts: the kernels' wrappers (one for the
# three layouts of each TPU kernel) and the host logic around them.
RENAMED = {
    "ops.pressure_pallas": ("ops.pressure", {
        "pressure_solve_pallas": "pressure_solve_cuda",
        "pressure_solve_pallas_batched": "pressure_solve_cuda",
        "pressure_solve_pallas_packed": "pressure_solve_cuda",
        "pressure_solve_vmappable": "pressure_solve_recook"}),
    "ops.transport_pallas": ("ops.transport", {
        "transport_substeps_pallas": "transport_substeps_cuda",
        "transport_substeps_pallas_batched": "transport_substeps_cuda",
        "transport_substeps_pallas_packed": "transport_substeps_cuda",
        "transport_substeps_vmappable": "transport_substeps"}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_modules():
    """Every module of the JAX package, as its dotted path below the
    package ("" for the package itself)."""
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)[:-3].replace(os.sep, ".")
                out.append(rel[:-len("__init__")].rstrip(".") if rel.endswith("__init__") else rel)
    return sorted(out)


def public_names(rel):
    """The public names of a JAX module, read from its source."""
    path = os.path.join(JAX_PKG, *rel.split("."), "__init__.py") if rel == "" or os.path.isdir(
        os.path.join(JAX_PKG, *rel.split("."))) else os.path.join(JAX_PKG, *rel.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif path.endswith("__init__.py") and isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


@pytest.mark.parametrize("rel", [m for m in _jax_modules() if m not in NOT_PORTED_MODULES])
def test_every_public_name_has_a_counterpart(rel):
    """Each public name of the JAX module exists in the port's module."""
    port_rel, renamed = RENAMED.get(rel, (rel, {}))
    port = importlib.import_module("historymatching_tpu_torch" + ("." + port_rel if port_rel else ""))
    names = [n for n in public_names(rel) if n not in NOT_PORTED.get(rel, ())]
    missing = [n for n in names if not hasattr(port, renamed.get(n, n))]
    assert not missing, f"{rel}: no counterpart in {port.__name__} for {missing}"


def test_the_walk_sees_the_gaps_it_guards():
    """The walk reads what it should: the re-exports of `ops`, `parallel`
    and `models`, the closure, and the excluded names are public names of
    the JAX package."""
    assert {"pcg", "transmissibilities", "stencil_diag", "stencil_matvec"} <= set(
        public_names("ops"))
    assert {"ens_mesh", "shard_ens", "ensemble_simulate", "forward_model", "perm_transf",
            "set_perm"} <= set(public_names("parallel"))
    assert {"Fluid", "ResSim", "SimResult", "simulate"} <= set(public_names("models"))
    assert "vcycle_solver" in public_names("ops.multigrid")
    for rel, names in NOT_PORTED.items():
        assert names <= set(public_names(rel)), rel
    assert set(RENAMED["ops.transport_pallas"][1]) <= set(public_names("ops.transport_pallas"))
    assert set(RENAMED["ops.pressure_pallas"][1]) <= set(public_names("ops.pressure_pallas"))


def _hierarchy(Nx, Ny, N, seed):
    m = default_model(Nx=Nx, Ny=Ny)
    TXs, TYs, ones, _, _ = scaled_system(perm_fields(seed, N, m.Nxy, scale=0.8), m)
    return (TXs, TYs, ones), mg_t.build_hierarchy_5pt(t64(TXs), t64(TYs), t64(ones))


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
def test_vcycle_solver_matches_jax(smoother):
    """The closure is one V-cycle from a zero start, as the JAX one: on the
    same coarse inverse, and each with its own."""
    Nx = Ny = 16
    N = 3
    (TXs, TYs, ones), hier_t = _hierarchy(Nx, Ny, N, 2)
    Ainv_t = mg_t.coarse_inverse(hier_t)
    b = np.random.default_rng(7).normal(size=(N, Nx, Ny))
    M_t = mg_t.vcycle_solver(hier_t, smoother=smoother)
    M_given = mg_t.vcycle_solver(hier_t, Ainv=Ainv_t, smoother=smoother)
    z_t = M_t(t64(b))
    assert torch.equal(z_t, M_given(t64(b)))
    assert torch.equal(z_t, mg_t.vcycle_apply(hier_t, Ainv_t, t64(b), smoother=smoother))
    for k in range(N):
        hier_j = mg_j.build_hierarchy_5pt(*(jnp.asarray(x[k]) for x in (TXs, TYs, ones)))
        same = mg_j.vcycle_solver(hier_j, Ainv=jnp.asarray(Ainv_t[k].numpy()),
                                  smoother=smoother)
        assert rel_err(z_t[k], same(jnp.asarray(b[k]))) < 1e-12
        own = mg_j.vcycle_solver(hier_j, smoother=smoother)
        assert rel_err(z_t[k], own(jnp.asarray(b[k]))) < 1e-8


def test_vcycle_solver_preconditions_pcg_as_jax():
    """`pcg` with the closure as `Minv` takes the JAX `pcg`'s iterations
    with the JAX closure on each member (the same coarse inverse), to the
    same solution, and converges."""
    Nx = Ny = 16
    N = 3
    (TXs, TYs, ones), hier_t = _hierarchy(Nx, Ny, N, 4)
    Ainv_t = mg_t.coarse_inverse(hier_t)
    b = np.random.default_rng(9).normal(size=(N, Nx, Ny))
    b -= b.mean(axis=(1, 2), keepdims=True)
    TX, TY, D = hier_t[0]
    kw = dict(tol=1e-10, maxiter=200)
    x_t, it_t, rel_t = cg_t.pcg(lambda v: matvec_t(TX, TY, D, v), t64(b),
                                Minv=mg_t.vcycle_solver(hier_t, Ainv=Ainv_t), **kw)
    assert bool((rel_t <= 1e-10).all())
    for k in range(N):
        args = tuple(jnp.asarray(x[k]) for x in (TXs, TYs, ones))
        hier_j = mg_j.build_hierarchy_5pt(*args)
        M_j = mg_j.vcycle_solver(hier_j, Ainv=jnp.asarray(Ainv_t[k].numpy()))
        x_j, it_j, _ = jax.jit(lambda bb: cg_j.pcg(lambda v: matvec_j(*args, v), bb,
                                                   Minv=M_j, **kw))(jnp.asarray(b[k]))
        assert int(it_t[k]) == int(it_j)
        assert rel_err(x_t[k], x_j) < 1e-9
