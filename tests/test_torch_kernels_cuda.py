"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, in float32. Skipped without CUDA (this file imports no JAX, so it
also runs on a host without it: `python -m pytest --noconftest
tests/test_torch_kernels_cuda.py`).

Tolerances: K 1e-5 absolute on saturations (FMA contraction, the kernel's
folded flux coefficients and fast reciprocal, over hundreds of substeps);
P 1e-3 relative on p after fixed work (block reductions sum in another
order than torch, and the coarse sweeps multiply by 1/d)."""

import numpy as np
import pytest
import torch

from historymatching_tpu_torch.models.ressim import ResSim, _tpfa, scaled_system
from historymatching_tpu_torch.ops import _build, transport
from historymatching_tpu_torch.ops.multigrid import build_hierarchy, coarse_inverse, n_levels
from historymatching_tpu_torch.ops.pressure import (
    kernel_name,
    pressure_solve_cuda,
    pressure_solve_recook,
    pressure_solve_torch,
    recook_plan,
    smem_bytes,
)
from historymatching_tpu_torch.ops.pressure import route as pressure_route
from historymatching_tpu_torch.ops.stencil import stencil_residual_ds
from historymatching_tpu_torch.ops.transport import (
    transport_substeps,
    transport_substeps_cuda,
    transport_substeps_torch,
)
from historymatching_tpu_torch.ops.transport import route as transport_route
from historymatching_tpu_torch.parallel.runner import set_perm

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _model(Nx, Ny, dev):
    """The flagship geometry (2x1 domain, centre injector, 4 producers)."""
    near01 = np.array([0.12, 0.87])
    prd = [[x, y] for y in near01 for x in 2.0 * near01]
    return ResSim.build(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0, inj_xy=[[1.0, 0.5]], prd_xy=prd,
                        inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4,
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("Nx,Ny", _build.GRIDS)
def test_transport_kernel_matches_plain(dev, Nx, Ny):
    g = torch.Generator(device=dev).manual_seed(0)
    B = 8
    s = torch.rand(B, Nx, Ny, generator=g, device=dev)
    Fx = 0.1 * torch.randn(B, Nx + 1, Ny, generator=g, device=dev)
    Fy = 0.1 * torch.randn(B, Nx, Ny + 1, generator=g, device=dev)
    Fx[:, 0] = Fx[:, -1] = 0
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    dts_pv = torch.full((B,), 0.05, device=dev)
    n_sub = torch.arange(1, 8 * B, 8, dtype=torch.int32, device=dev)
    fluid = (1.0, 1.0, 0.0, 0.0)
    before = _build.LAUNCHES["transport_upwind"]
    out = transport_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind"] == before + 1
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    assert float((out - ref).abs().max()) <= 1e-5


def _system(mm, q, unit_diag):
    """P's arguments for fields `mm` at s = 0: the scaled system, or the
    unscaled one (w = 1)."""
    B, (Nx, Ny) = mm.K.shape[0], mm.shape
    s = torch.zeros(B, Nx, Ny, device=mm.K.device)
    if unit_diag:
        _, _, diag, sd, hier, Ainv = scaled_system(mm, s)
        return hier, Ainv, (q * sd).contiguous(), torch.zeros_like(s), (diag * sd).contiguous()
    TX, TY, _, pin = _tpfa(mm, s)
    hier = build_hierarchy(TX, TY, pin)
    return (hier, coarse_inverse(hier), q.expand(B, Nx, Ny).contiguous(), torch.zeros_like(s),
            torch.ones_like(s))


def _pressure_vs_plain(dev, Nx, Ny, smoother, unit_diag=True, window=16, scale=1.0, force=None,
                       plan=None, B=8, noise=False, moved=False):
    """One launch of P's `smoother` instantiation against the plain version
    with the same smoother, after fixed work (one restart window of
    `window` iterations, or two of 8 for 16); the launch counts on that
    instantiation's own key. Without `unit_diag`, on the unscaled system
    (the instantiation that reads the fine diagonal); `scale` multiplies
    the pre-permeability fields; `force` the route (P-gm: "gm", P-gm1:
    "gm1"), `plan` P-cl's cluster; B members. The kernel's step from the
    start is held to the plain version's; with `noise` the start is seeded
    noise at the right-hand side's scale, not 0; with `moved` every
    member's plain step must be nonzero (so the check cannot pass on the
    start alone)."""
    g = torch.Generator(device=dev).manual_seed(1)
    m = _model(Nx, Ny, dev)
    mm = set_perm(m, scale * torch.randn(B, m.Nxy, generator=g, device=dev))
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    args = _system(mm, q, unit_diag)
    if noise:
        p0 = torch.randn(args[2].shape, generator=g, device=dev)
        args = (*args[:3], p0 * args[2].abs().amax(dim=(-2, -1), keepdim=True), args[4])
    fixed = dict(tol=0.0, maxiter=window, restart_every=min(window, 8), patience_iters=160,
                 smoother=smoother, unit_diag=unit_diag)
    route = "cl" if plan else force or pressure_route(Nx, Ny, unit_diag, B)
    name = kernel_name(smoother, unit_diag, route)
    before = dict(_build.LAUNCHES)
    p_k, it_k, rel_k = pressure_solve_cuda(*args, **fixed, force=force, plan=plan)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]} == {name: 1}
    p_t, it_t, rel_t = pressure_solve_torch(*args, **fixed)
    assert torch.equal(it_k, it_t)
    step_k, step_t = p_k - args[3], p_t - args[3]
    dn, nt = (step_k - step_t).norm(dim=(-2, -1)), step_t.norm(dim=(-2, -1))
    assert not moved or bool((nt > 0).all()), nt
    # zero from both: the member's weighted residual never improved on its start
    err = torch.where((dn == 0) & (nt == 0), 0.0, dn / nt)
    assert float(err.max()) <= 1e-3


@pytest.mark.parametrize("Nx,Ny", _build.GRIDS)
def test_pressure_kernel_matches_plain(dev, Nx, Ny):
    _pressure_vs_plain(dev, Nx, Ny, "jacobi")


@pytest.mark.parametrize("Nx,Ny", _build.GRIDS)
def test_pressure_cheb_kernel_matches_plain(dev, Nx, Ny):
    """The Chebyshev-smoothed instantiation of P, as the Jacobi one."""
    _pressure_vs_plain(dev, Nx, Ny, "cheb")


NEW_P_GRIDS = [(8, 8), (10, 10), (12, 12), (24, 16), (80, 80)]


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("Nx,Ny", NEW_P_GRIDS)
def test_pressure_kernel_at_new_grids(dev, Nx, Ny, smoother):
    """P built for grids outside `GRIDS` (its library built on first use):
    a fine level of 64 cells (8x8), sides of 2 mod 4 (10x10), an odd
    coarsest level (12x12: 3x3), a non-square grid, and one block an SM
    (80x80). Fixed work is one restart window of 4 iterations: on grids of
    up to 400 cells 8 iterations reach float32's floor, where two float32
    summation orders, or float32 and float64, part by up to 1e-1."""
    _pressure_vs_plain(dev, Nx, Ny, smoother, window=4)


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("Nx,Ny", [(20, 20), (64, 64), (12, 12)])
def test_pressure_unscaled_kernel_matches_plain(dev, Nx, Ny, smoother):
    """P with an explicit fine diagonal, on the unscaled system, after one
    restart window of 4 iterations, on fields of mild contrast (the
    pre-permeability times 0.2): at a contrast of e^10 and more float32
    leaves the unscaled system undetermined, its plain version in float32
    and float64 parting by O(1) after one iteration."""
    _pressure_vs_plain(dev, Nx, Ny, smoother, unit_diag=False, window=4, scale=0.2)


@pytest.mark.parametrize("Nx,Ny", [(15, 15), (12, 9), (10, 10), (12, 12), (24, 16), (80, 80),
                                   (64, 64), (5, 3), (60, 60), (75, 75), (97, 97), (3, 500),
                                   (25, 150)])
def test_transport_runtime_grid_matches_plain(dev, Nx, Ny):
    """K-rt, the strip body built for a grid outside `GRIDS` (strips of 4
    rows with short last strips at 15x15, 10x10 and 5x3; of 7 rows with the
    faces in shared memory at 80x80, 6 at 75x75, 11 at 97x97; of 5 rows,
    faces in registers, at 25x150), does the
    plain version's float32 operations in its order, so it agrees bit for
    bit, on its route and forced (80x80's route is K-cl, 64x64's the
    templated K)."""
    g = torch.Generator(device=dev).manual_seed(5)
    B = 16
    s = torch.rand(B, Nx, Ny, generator=g, device=dev)
    Fx = 0.1 * torch.randn(B, Nx + 1, Ny, generator=g, device=dev)
    Fy = 0.1 * torch.randn(B, Nx, Ny + 1, generator=g, device=dev)
    Fx[:, 0] = Fx[:, -1] = 0
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = torch.zeros(B, Nx, Ny, device=dev)
    q[:, Nx // 2, Ny // 2], q[:, 0, 0] = 1.0, -1.0
    n_sub = torch.randint(1, 200, (B,), generator=g, device=dev, dtype=torch.int32)
    dts_pv = 0.3 / n_sub.float()
    fluid = (1.0, 1.0, 0.0, 0.0)
    before = _build.LAUNCHES["transport_upwind_rt"]
    out = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, force="rt")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_rt"] == before + 1
    ref = transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("Nx,Ny,force", [(4, 1100, None), (2, 2000, None), (15, 15, "rt1"),
                                         (80, 80, "rt1"), (64, 64, "rt1")])
def test_transport_rt1_matches_plain(dev, Nx, Ny, force):
    """K-rt1, the tile body with a member in one block, on its route where no
    strip plan of one column a thread fits (rows of 1,100 and 2,000 cells:
    strips of 4 rows and 2 or 4 columns a thread) and forced where K-rt,
    K-cl or the templated K take the grid: bit for bit. (8x3632 and 150x150,
    its grids before no one-block plan built without spilling, are K-gm1's
    and K-gm's: `test_transport_gm1_matches_plain`,
    `test_transport_gm_matches_plain`.)"""
    args = _transport_inputs(dev, Nx, Ny, 5)
    assert transport_route(Nx, Ny) == "rt1" or force == "rt1"
    before = _build.LAUNCHES["transport_upwind_rt1"]
    out = transport_substeps_cuda(*args, force=force)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_rt1"] == before + 1
    assert torch.equal(out, transport_substeps_torch(*args))


@pytest.mark.parametrize("Nx,Ny,members,strip", [(12, 12, 4, 2), (10, 10, 4, 1), (12, 9, 3, 4),
                                                 (24, 16, 2, 2)])
def test_transport_rt1_groups_match_plain(dev, Nx, Ny, members, strip):
    """K-rt1 on small grids, one member a block, members of unequal substep
    counts (every `members`-th none) each looping over its own count: bit
    for bit on the route's plan and on strips of `strip` rows."""
    from historymatching_tpu_torch.ops.transport import TilePlan, rt1_plan, tile_threads

    B = 3 * members + 1
    s, Fx, Fy, q, dts_pv, n_sub, fluid = _transport_inputs(dev, Nx, Ny, 11, B)
    n_sub[::members] = 0
    assert len(set(n_sub.tolist())) > 2
    threads = -(-tile_threads(Nx, Ny, strip, 1) // 32) * 32
    plan = TilePlan(1, 1, strip, 1, "registers", threads)
    ref = transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    before = _build.LAUNCHES["transport_upwind_rt1"]
    for p in (plan, rt1_plan(Nx, Ny)):
        out = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, force="rt1", plan=p)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), p
    assert _build.LAUNCHES["transport_upwind_rt1"] == before + 2
    info = _build.kernel_info("transport_upwind_rt1", Nx, Ny, plan)
    assert info["threads"] == threads and info["local_bytes"] == 0, info


def test_transport_rt_refuses_what_it_does_not_take(dev):
    """K-rt forced where no strip plan fits raises before any launch; a
    grid's library refuses another grid (its launch returns an error, the
    wrapper raises); neither counts a launch."""
    from historymatching_tpu_torch.ops import transport

    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="no strip plan"):
        transport_substeps_cuda(*_transport_inputs(dev, 8, 3632, 5, B=2), force="rt")
    lib = _build.transport_rt_lib(15, 15, *transport.rt_plan(15, 15))
    s, Fx, Fy, q, dts_pv, n_sub, _ = _transport_inputs(dev, 12, 12, 5, B=2)
    out = torch.empty_like(s)
    code = lib.hm_transport_substeps_rt(s.data_ptr(), Fx.data_ptr(), Fy.data_ptr(), q.data_ptr(),
                                        144, dts_pv.data_ptr(), n_sub.data_ptr(), out.data_ptr(),
                                        2, 12, 12, 1.0, 1.0, 0.0, 0.0, _build.stream_ptr(dev))
    with pytest.raises(RuntimeError, match="transport_upwind_rt: CUDA error"):
        _build.check(code, "transport_upwind_rt")
    assert _build.LAUNCHES == before


def test_failed_coarse_member_on_the_card(dev):
    """One member of 64 with an indefinite coarsest operator: its inverse
    comes from the guarded Newton-Schulz and is finite, the other members'
    are the unforced run's, and P solves the batch."""
    g = torch.Generator(device=dev).manual_seed(6)
    m = _model(64, 64, dev)
    B = 64
    mm = set_perm(m, 0.8 * torch.randn(B, m.Nxy, generator=g, device=dev))
    _, _, diag, sd, hier, Ainv = scaled_system(mm, torch.zeros(B, 64, 64, device=dev))
    TXc, TYc, Dc = hier[-1]
    Dc = Dc.clone()
    Dc[5] = 0.5 * Dc[5]  # no longer dominant: indefinite
    hier_f = hier[:-1] + [(TXc, TYc, Dc)]
    Ainv_f = coarse_inverse(hier_f)
    keep = torch.arange(B, device=dev) != 5
    assert torch.equal(Ainv_f[keep], Ainv[keep]) and torch.isfinite(Ainv_f).all()
    q = torch.zeros(64, 64, device=dev)
    q[32, 32], q[1, 1] = 1.0, -1.0
    p, it, rel = pressure_solve_cuda(hier_f, Ainv_f, (q * sd).contiguous(), torch.zeros_like(sd),
                                     (diag * sd).contiguous(), tol=2e-3, maxiter=128)
    p0, _, _ = pressure_solve_cuda(hier, Ainv, (q * sd).contiguous(), torch.zeros_like(sd),
                                   (diag * sd).contiguous(), tol=2e-3, maxiter=128)
    assert torch.equal(p[keep], p0[keep]) and torch.isfinite(p).all()


def test_pressure_members_leave_at_their_own_windows(dev):
    """One launch, four members at 64x64: a warm start one window from the
    tolerance, one two windows away, a cold start on a mild field that
    needs >= 8 windows, and a rough field that runs to maxiter. Each block
    stops on its own count, as the per-member `pcg` does."""
    Nx = Ny = 64
    g = torch.Generator().manual_seed(2)
    m = _model(Nx, Ny, "cpu")
    base = torch.randn(1, m.Nxy, generator=g)
    mm = set_perm(m, torch.tensor([0.5, 0.5, 0.3, 0.8])[:, None] * base)
    _, _, diag, sd, hier, Ainv = scaled_system(mm, torch.zeros(4, Nx, Ny))
    q = torch.zeros(Nx, Ny)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    qs, w = q * sd, diag * sd
    ref, _, _ = pressure_solve_torch(hier, Ainv, qs, torch.zeros_like(qs), w, tol=1e-5,
                                     maxiter=512)
    warm = torch.tensor([1e-4, 3e-4, 0.0, 0.0])[:, None, None]
    noise = torch.randn(4, Nx, Ny, generator=g)
    p0 = torch.where(warm > 0, ref + warm * noise * ref.abs().amax(dim=(1, 2), keepdim=True),
                     torch.zeros_like(ref))
    to = lambda t: t.to(dev).contiguous()  # noqa: E731
    args = ([tuple(to(t) for t in lvl) for lvl in hier], to(Ainv), to(qs), to(p0), to(w))
    kw = dict(tol=1e-3, maxiter=128, patience_iters=512)
    p_k, it_k, rel_k = pressure_solve_cuda(*args, **kw)
    p_t, it_t, rel_t = pressure_solve_torch(*args, **kw)
    it_k, it_t = it_k.tolist(), it_t.tolist()
    assert it_k[:2] == it_t[:2] == [8, 16]
    assert it_k[2] >= 64 and abs(it_k[2] - it_t[2]) <= 8
    assert it_k[3] == it_t[3] == 128 and float(rel_k[3]) > 1e-3
    assert bool((rel_k[:3] <= 1e-3).all())
    err = ((p_k - p_t).norm(dim=(-2, -1)) / p_t.norm(dim=(-2, -1)))[:3]
    assert float(err.max()) <= 1e-3


def _fixed_work_err(p_k, p_t):
    """Per-member relative difference; zero from both counts as agreement
    (a member whose weighted residual never improved on its start)."""
    dn, nt = (p_k - p_t).norm(dim=(-2, -1)), p_t.norm(dim=(-2, -1))
    return float(torch.where((dn == 0) & (nt == 0), 0.0, dn / nt).max())


@pytest.mark.parametrize("Nx,Ny", [(16, 16), (64, 64)])
def test_pressure_kernel_on_the_recook_passes(dev, Nx, Ny):
    """The recook's new uses of P: a gathered subset of members (fresh
    tensors from an index, in another order) warm-started from an earlier
    solve, and the correction solve from zero on a compensated residual.
    Each against the plain version after one restart window; then the
    whole recook, three launches, against the plain recook."""
    g = torch.Generator(device=dev).manual_seed(3)
    m = _model(Nx, Ny, dev)
    B = 64 if Ny == 64 else 256
    mm = set_perm(m, 0.8 * torch.randn(B, m.Nxy, generator=g, device=dev))
    _, _, diag, sd, hier, Ainv = scaled_system(mm, torch.zeros(B, Nx, Ny, device=dev))
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    qs, w = (q * sd).contiguous(), (diag * sd).contiguous()
    hier = [tuple(t.expand(B, *t.shape[-2:]) for t in lvl) for lvl in hier]
    p1, _, _ = pressure_solve_cuda(hier, Ainv, qs, torch.zeros_like(qs), w, tol=0.0, maxiter=8)
    idx = torch.randperm(B, generator=g, device=dev)[: B // 4]
    sub = ([tuple(t[idx] for t in lvl) for lvl in hier], Ainv[idx], qs[idx])
    fixed = dict(tol=0.0, maxiter=8, patience_iters=160)
    p_k, it_k, _ = pressure_solve_cuda(*sub, p1[idx], w[idx], **fixed)
    p_t, it_t, _ = pressure_solve_torch(*sub, p1[idx], w[idx], **fixed)
    assert torch.equal(it_k, it_t) and _fixed_work_err(p_k, p_t) <= 1e-3
    r_ds = stencil_residual_ds(*sub[0][0], p_k, sub[2])
    d_k, _, _ = pressure_solve_cuda(*sub[:2], r_ds, torch.zeros_like(r_ds), w[idx], **fixed)
    d_t, _, _ = pressure_solve_torch(*sub[:2], r_ds, torch.zeros_like(r_ds), w[idx], **fixed)
    assert torch.isfinite(d_k).all() and _fixed_work_err(d_k, d_t) <= 1e-3

    kw = dict(tol=2e-4, maxiter=128, patience_iters=256, twopass_j1=8, twopass_div=8)
    Nb, K = recook_plan(B, Ny, 128, True, 8, 8)
    before = _build.LAUNCHES["pressure_pcg"]
    _, it_k, rel_k, rec_k = pressure_solve_recook(hier, Ainv, qs, torch.zeros_like(qs), w, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pressure_pcg"] == before + 3
    _, it_t, rel_t, rec_t = pressure_solve_recook(hier, Ainv, qs, torch.zeros_like(qs), w,
                                                  solve=pressure_solve_torch, **kw)
    assert int(rec_k.sum()) == int(rec_t.sum()) == K  # B is a multiple of the group
    # float32 ties near the cut may swap a member in or out
    assert int((rec_k & rec_t).sum()) >= 0.9 * K
    assert abs(int((rel_k <= 5e-2).sum()) - int((rel_t <= 5e-2).sum())) <= max(1, B // 50)


@pytest.mark.parametrize("Nx,Ny", _build.GRIDS)
def test_kernel_resources(dev, Nx, Ny):
    """What the runtime reports matches the wrapper's footprint formula, and
    P keeps two blocks resident on an SM at the flagship grid, with either
    smoother."""
    for name in ("pressure_pcg", "pressure_pcg_cheb"):
        p = _build.kernel_info(name, Nx, Ny)
        assert p["shared_bytes"] == smem_bytes(Nx, Ny, n_levels(Nx, Ny))
        assert p["blocks_per_sm"] >= (2 if (Nx, Ny) == (64, 64) else 1)
    k = _build.kernel_info("transport_upwind", Nx, Ny)
    assert k["shared_bytes"] == 2 * 4 * Nx * Ny and k["blocks_per_sm"] >= 1


@pytest.mark.parametrize("Nx,Ny", NEW_P_GRIDS + [(20, 20), (64, 64)])
def test_new_kernel_resources(dev, Nx, Ny):
    """The new instantiations' footprints: P at grids outside `GRIDS`, P
    with an explicit fine diagonal, and K's runtime-grid variant."""
    for name, unit in (("pressure_pcg", True), ("pressure_pcg_cheb", True),
                       ("pressure_pcg_diag", False), ("pressure_pcg_cheb_diag", False)):
        p = _build.kernel_info(name, Nx, Ny)
        assert p["shared_bytes"] == smem_bytes(Nx, Ny, n_levels(Nx, Ny), unit)
        assert p["blocks_per_sm"] >= 1
    from historymatching_tpu_torch.ops.transport import rt_bytes, rt_plan, rt_threads

    k = _build.kernel_info("transport_upwind_rt", Nx, Ny)
    plan = rt_plan(Nx, Ny)
    assert k["shared_bytes"] == rt_bytes(Nx, Ny, *plan) and k["blocks_per_sm"] >= 1, k
    assert k["threads"] == rt_threads(Nx, Ny, plan[0]) and k["local_bytes"] == 0, k
    from historymatching_tpu_torch.ops.transport import rt1_plan, tile_bytes

    k = _build.kernel_info("transport_upwind_rt1", Nx, Ny)
    plan = rt1_plan(Nx, Ny)
    assert k["shared_bytes"] == tile_bytes(Nx, Ny, plan.strip, plan.cols, plan.faces)
    assert k["local_bytes"] == 0 and k["blocks_per_sm"] >= 1, k


def test_build_defaults_to_cuda(dev):
    assert ResSim.build(Nx=16, Ny=16).K.is_cuda


def test_kernels_refuse_what_they_do_not_take(dev):
    s = torch.zeros(2, 8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        transport_substeps(s, torch.zeros(2, 9, 8, dtype=torch.float64, device=dev),
                           torch.zeros(2, 8, 9, dtype=torch.float64, device=dev), s,
                           torch.ones(2, dtype=torch.float64, device=dev),
                           torch.ones(2, dtype=torch.int32, device=dev), (1.0, 1.0, 0.0, 0.0))


@pytest.mark.parametrize("Nx,Ny,force", [(128, 128, "gm"), (60, 220, "gm"), (64, 64, "gm")])
@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
def test_pressure_gm_matches_plain(dev, Nx, Ny, force, smoother):
    """P-gm where P's shared-memory layout does not fit (128x128 needs
    458,528 bytes; 60x220 with its 825-cell coarse inverse), forced there
    since P-cl takes those grids, and forced at 64x64 (one block a member),
    against the plain version after one window of 4 iterations."""
    _pressure_vs_plain(dev, Nx, Ny, smoother, window=4, force=force)


# P-gm's points: its route at 120x440 (no cluster holds it; 15 banded
# blocks and 6 or 9 with inverse rows only), the scaled 100x100 forced (9
# banded blocks, P-cl/d's route at this batch) and 64x64 forced (one block).
GM_POINTS = [(120, 440, None, 2), (100, 100, "gm", 8), (64, 64, "gm", 8)]


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("Nx,Ny,force,B", GM_POINTS)
def test_pressure_gm_blocks_match_plain(dev, Nx, Ny, force, B, smoother, unit_diag):
    """P-gm, a member over co-resident blocks, in its four instantiations,
    against the plain version after one window of 4 iterations (the
    unscaled system on fields of mild contrast), counted on its own key."""
    kw = {} if unit_diag else dict(unit_diag=False, scale=0.2)
    _pressure_vs_plain(dev, Nx, Ny, smoother, window=4, force=force, B=B, **kw)


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("Nx,Ny,B", [(120, 440, 2), (100, 100, 8), (64, 64, 8), (32, 1088, 2),
                                     (100, 100, 5), (60, 220, 5)])
def test_pressure_gm1_matches_plain(dev, Nx, Ny, B, smoother, unit_diag):
    """P-gm1, one block a member with its arrays split between shared and
    device memory and its inverse streamed through the ring, forced at
    P-gm's points and on its own route at 32x1088 (a band of 8 rows of
    1,088 cells fits no block), as P-gm. Five members at 100x100 and 60x220
    (625^2 and 825^2 are 1 mod 4): each member's inverse starts at another
    16-byte phase, and the last one's tail is not a whole 16 bytes. The
    scaled system starts from seeded noise: from 0 some members' window
    (every one at 32x1088) does not improve the residual, and both versions
    return the start. Every member's plain step is nonzero."""
    kw = dict(noise=True) if unit_diag else dict(unit_diag=False, scale=0.2)
    force = None if (Nx, Ny) == (32, 1088) else "gm1"
    assert pressure_route(Nx, Ny, unit_diag, B) == "gm1" or force == "gm1"
    _pressure_vs_plain(dev, Nx, Ny, smoother, window=4, force=force, B=B, moved=True, **kw)


def test_pressure_gm_refused_launch_raises(dev, monkeypatch):
    """A P-gm launch whose blocks the card cannot hold at once (a plan of
    1,100 blocks a member) is refused by the cooperative launch; the wrapper
    raises and counts no launch."""
    from historymatching_tpu_torch.ops import pressure

    Nx, Ny = 100, 100
    monkeypatch.setattr(pressure, "gm_plan", lambda Nx, Ny, unit_diag=True: (1100, 1))
    m = _model(Nx, Ny, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    mm = set_perm(m, torch.randn(2, m.Nxy, generator=g, device=dev))
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="pressure_pcg_gm: CUDA error"):
        pressure_solve_cuda(*_system(mm, q, True), tol=0.0, maxiter=4, force="gm")
    assert _build.LAUNCHES == before


def _transport_inputs(dev, Nx, Ny, seed, B=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.rand(B, Nx, Ny, generator=g, device=dev)
    Fx = 0.1 * torch.randn(B, Nx + 1, Ny, generator=g, device=dev)
    Fy = 0.1 * torch.randn(B, Nx, Ny + 1, generator=g, device=dev)
    Fx[:, 0] = Fx[:, -1] = 0
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = torch.zeros(B, Nx, Ny, device=dev)
    q[:, Nx // 2, Ny // 2], q[:, 0, 0] = 1.0, -1.0
    n_sub = torch.randint(0, 200, (B,), generator=g, device=dev, dtype=torch.int32)
    dts_pv = 0.3 / n_sub.float().clamp_min(1.0)
    return s, Fx, Fy, q, dts_pv, n_sub, (1.0, 1.0, 0.0, 0.0)


@pytest.mark.parametrize("Nx,Ny,force,B", [(171, 171, None, 8), (120, 440, None, 16),
                                           (120, 440, None, 64), (192, 192, "gm", 8),
                                           (64, 64, "gm", 8), (150, 150, None, 8)])
def test_transport_gm_matches_plain(dev, Nx, Ny, force, B):
    """K-gm, a member over co-resident blocks a band of rows, where the two
    fw tiles do not fit one block and no cluster takes the grid (171x171
    needs 233,928 bytes: 9 bands of 19 rows; 120x440: 15 bands of 8),
    forced at 192x192 (K-cl's route; 10 bands of 20 and 19 rows) and at
    64x64 (one band): the plain version's operations in its order, so bit
    for bit. At 120x440, 64 members exceed the 8 groups of 15 bands the
    card holds at once; each batch has a member with no substep."""
    s, Fx, Fy, q, dts_pv, n_sub, fluid = _transport_inputs(dev, Nx, Ny, 7, B)
    n_sub[1] = 0
    before = _build.LAUNCHES["transport_upwind_gm"]
    out = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, force=force)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_gm"] == before + 1
    assert torch.equal(out, transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid))
    q1 = q[:1].contiguous()
    assert torch.equal(transport_substeps_cuda(s, Fx, Fy, q1, dts_pv, n_sub, fluid, force=force),
                       transport_substeps_torch(s, Fx, Fy, q1, dts_pv, n_sub, fluid))
    if B == 64:  # more members than groups of bands the card holds at once
        assert B > _build.kernel_info("transport_upwind_gm", Nx, Ny)["groups_resident"]


def test_transport_gm_refused_launch_raises(dev, monkeypatch):
    """A K-gm launch whose bands the card cannot hold at once (133 bands of
    one 1,024-column row, one block an SM on 132 SMs) is refused by the
    cooperative launch; the wrapper raises and counts no launch."""
    from historymatching_tpu_torch.ops import transport

    Nx, Ny = 133, 1024
    monkeypatch.setattr(transport, "gm_bands",
                        lambda Nx, Ny, strip=4, cols=1: [(i, 1) for i in range(Nx)])
    before = _build.LAUNCHES["transport_upwind_gm"]
    with pytest.raises(RuntimeError, match="transport_upwind_gm: CUDA error"):
        transport_substeps_cuda(*_transport_inputs(dev, Nx, Ny, 7, B=2), force="gm")
    assert _build.LAUNCHES["transport_upwind_gm"] == before


@pytest.mark.parametrize("Nx,Ny,force,B", [(8, 5000, None, 8), (32, 1088, "gm1", 8),
                                           (171, 171, "gm1", 8), (64, 64, "gm1", 8),
                                           (5, 6000, None, 8), (8, 3632, None, 8),
                                           (1090, 1090, None, 2)])
def test_transport_gm1_matches_plain(dev, Nx, Ny, force, B):
    """K-gm1 on its route past K-gm's capacity, a member over co-resident
    2-D tiles (8x5000, [23]'s 5x6000, and 8x3632, K-rt1's before), on its
    device-memory body past the tiles' capacity (1090x1090, two members of
    one step), and forced at 32x1088 (K-gm's since its plans widened),
    171x171 and 64x64: bit for bit, a shared source field too; at 64x64
    the device-memory body on the card's blocks spread over the batch, on
    one block a member and on three."""
    from historymatching_tpu_torch.ops.transport import DEVICE, GM1Device, gm1_plan

    s, Fx, Fy, q, dts_pv, n_sub, fluid = _transport_inputs(dev, Nx, Ny, 7, B)
    assert (gm1_plan(Nx, Ny) is None) == ((Nx, Ny) == (1090, 1090))
    before = _build.LAUNCHES["transport_upwind_gm1"]
    out = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, force=force)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_gm1"] == before + 1
    assert torch.equal(out, transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid))
    q1 = q[:1].contiguous()
    small = (Nx, Ny) == (64, 64)  # the device-memory body on a small grid
    ref1 = transport_substeps_torch(s, Fx, Fy, q1, dts_pv, n_sub, fluid)
    for plan in (DEVICE, GM1Device(1), GM1Device(3)) if small else (None,):
        out = transport_substeps_cuda(s, Fx, Fy, q1, dts_pv, n_sub, fluid, force="gm1",
                                      plan=plan)
        assert torch.equal(out, ref1), plan


def test_transport_gm1_refused_launch_raises(dev):
    """A K-gm1 plan whose tiles the card cannot hold at once (266 tiles of
    one row of 512 columns, at most two blocks an SM on 132 SMs), and a
    device-memory plan of more blocks a member than the card holds, are
    refused by the cooperative launch; the wrapper raises and counts no
    launch."""
    from historymatching_tpu_torch.ops.transport import GM1Device, TilePlan

    before = _build.LAUNCHES["transport_upwind_gm1"]
    with pytest.raises(RuntimeError, match="transport_upwind_gm1: CUDA error"):
        transport_substeps_cuda(*_transport_inputs(dev, 133, 1024, 7, B=2), force="gm1",
                                plan=TilePlan(133, 2, 4, 1, "shared", 512))
    per = _build.gm1_resident(dev) + 1
    with pytest.raises(RuntimeError, match="transport_upwind_gm1: CUDA error"):
        transport_substeps_cuda(*_transport_inputs(dev, 64, 64, 7, B=2), force="gm1",
                                plan=GM1Device(per))
    assert _build.LAUNCHES["transport_upwind_gm1"] == before


# K-gm's widened plans (`gm_plan`): grids past the first plan's capacity.
WIDE_GM = [(32, 1088, 4), (600, 600, 2), (1057, 440, 2), (1000, 1000, 1), (33, 1025, 2),
           (2112, 440, 1), (1320, 700, 1)]


@pytest.mark.parametrize("Nx,Ny,B", WIDE_GM)
def test_transport_gm_wide_matches_plain(dev, Nx, Ny, B):
    """K-gm on its widened plans, on its route: 32x1088 (8 bands of 4 rows,
    strips of 4 rows and 2 columns a thread), 600x600 (120 bands, strips of
    5 rows), 1057x440 (106 bands of 10 rows, strips of 5), 1000x1000 (125
    bands of 8 rows, strips of 4 rows and 2 columns), 33x1025 (the last
    column group one column), 2112x440 (132 bands of 16 rows, strips of 8)
    and 1320x700 (132 bands of 10 rows, strips of 5 rows and 2 columns):
    bit for bit, a shared source field too; one launch each."""
    from historymatching_tpu_torch.ops.transport import gm_plan

    assert transport_route(Nx, Ny) == "gm" and gm_plan(Nx, Ny)[1:] != (4, 1)
    s, Fx, Fy, q, dts_pv, n_sub, fluid = _transport_inputs(dev, Nx, Ny, 9, B)
    n_sub.clamp_(max=40)
    before = _build.LAUNCHES["transport_upwind_gm"]
    out = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_gm"] == before + 1
    assert torch.equal(out, transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid))
    q1 = q[:1].contiguous()
    assert torch.equal(transport_substeps_cuda(s, Fx, Fy, q1, dts_pv, n_sub, fluid),
                       transport_substeps_torch(s, Fx, Fy, q1, dts_pv, n_sub, fluid))


@pytest.mark.parametrize("Nx,Ny", [(15, 15), (12, 9), (10, 10), (12, 12), (24, 16), (80, 80),
                                   (60, 60), (75, 75), (97, 97), (3, 500), (64, 64), (25, 150)])
def test_rt_kernel_resources(dev, Nx, Ny):
    """Every K-rt instantiation: its plan's threads and bytes (`rt_bytes`),
    no spills (the register model `RT_REGS` holds), a block resident on an
    SM."""
    from historymatching_tpu_torch.ops.transport import rt_bytes, rt_plan, rt_threads

    k = _build.kernel_info("transport_upwind_rt", Nx, Ny)
    plan = rt_plan(Nx, Ny)
    print(f"K-rt {Nx}x{Ny} {plan}: {k}")
    assert (k["strip"], k["faces"]) == plan
    assert k["threads"] == rt_threads(Nx, Ny, plan[0]) and k["local_bytes"] == 0, k
    assert k["shared_bytes"] == rt_bytes(Nx, Ny, *plan) and k["blocks_per_sm"] >= 1, k


@pytest.mark.parametrize("Nx,Ny,B", WIDE_GM)
def test_gm_wide_kernel_resources(dev, Nx, Ny, B):
    """Every widened K-gm instantiation: its plan's threads and bytes
    (`gm_threads`, `gm_bytes`), no spills (the register model `GM_REGS`
    holds), its bands and at least one member in flight."""
    from historymatching_tpu_torch.ops.transport import gm_bytes, gm_plan, gm_threads

    bands, strip, cols = gm_plan(Nx, Ny)
    rows = max(h for _, h in bands)
    k = _build.kernel_info("transport_upwind_gm", Nx, Ny)
    print(f"K-gm {Nx}x{Ny} strip {strip} cols {cols}: {k}")
    assert (k["strip"], k["cols"], k["bands"]) == (strip, cols, len(bands)), k
    assert k["local_bytes"] == 0 and k["groups_resident"] >= 1, k
    assert k["threads"] == gm_threads(Ny, rows, strip, cols), k
    assert k["shared_bytes"] == gm_bytes(Ny, rows, strip, cols), k


# The tile body's plans on the card tests' and chip_smoke's paths: K-rt1's
# and K-gm1's.
TILE_PLANS = [("rt1", 4, 1100), ("rt1", 2, 2000), ("rt1", 15, 15), ("rt1", 12, 12),
              ("rt1", 80, 80), ("rt1", 64, 64), ("rt1", 88, 88), ("gm1", 5, 6000),
              ("gm1", 8, 5000), ("gm1", 16, 2056), ("gm1", 8, 3632), ("gm1", 32, 1088),
              ("gm1", 171, 171), ("gm1", 600, 600), ("gm1", 120, 440), ("gm1", 128, 128)]


@pytest.mark.parametrize("rt,Nx,Ny", TILE_PLANS)
def test_tile_kernel_resources(dev, rt, Nx, Ny):
    """Every plan of the tile body on these paths: its threads and bytes as
    the plan counts them (`tile_threads`, `tile_bytes`), no spills (the
    register table `TILE_SHAPES` holds), its tiles and at least one member
    in flight."""
    from historymatching_tpu_torch.ops.transport import (
        gm1_plan,
        rt1_plan,
        tile_bytes,
        tile_dims,
    )

    plan = rt1_plan(Nx, Ny) if rt == "rt1" else gm1_plan(Nx, Ny)
    k = _build.kernel_info(f"transport_upwind_{rt}", Nx, Ny, plan)
    print(f"K-{rt} {Nx}x{Ny} {plan}: {k}")
    assert k["local_bytes"] == 0 and k["groups_resident"] >= 1, k
    assert k["threads"] == plan.threads and k["tiles"] == plan.gr * plan.gc, k
    assert k["shared_bytes"] == tile_bytes(*tile_dims(Nx, Ny, plan), plan.strip, plan.cols,
                                           plan.faces, plan.threads), k


# Each register cap of `TILE_SHAPES` and the most threads a block that
# leaves it (`reg_budget`).
CAP_THREADS = {128: 512, 96: 640, 80: 768, 72: 896, 64: 1024}
TILE_SHAPE_CASES = [(faces, sc) for faces in ("registers", "shared", "tiles")
                    for sc in transport.TILE_SHAPES[faces]]


@pytest.mark.parametrize("faces,shape", TILE_SHAPE_CASES)
def test_tile_shapes_build_without_spills(dev, faces, shape):
    """Every strip shape of `TILE_SHAPES`, built at the most threads its
    register cap allows (one strip row of that many column groups, one
    tile; "tiles" in K-gm1's build with the edge logic): no spilled bytes,
    and at most the cap's registers."""
    from historymatching_tpu_torch.ops.transport import TilePlan, reg_budget

    strip, cols = shape
    cap = transport.TILE_SHAPES[faces][shape]
    threads = CAP_THREADS[cap]
    assert reg_budget(threads) == cap
    rt = "gm1" if faces == "tiles" else "rt1"
    plan = TilePlan(1, 1, strip, cols, "shared" if faces == "tiles" else faces, threads)
    k = _build.kernel_info(f"transport_upwind_{rt}", strip, cols * threads, plan)
    print(f"tile body {faces} {shape} at {threads} threads: {k}")
    assert k["local_bytes"] == 0 and k["registers"] <= cap and k["threads"] == threads, k


@pytest.mark.parametrize("Nx,Ny", [(64, 64), (128, 128), (60, 220), (256, 256), (120, 440)])
def test_gm_kernel_resources(dev, Nx, Ny):
    """The device-memory variants' footprints: P-gm1's shared bytes and
    threads as its plan counts them (`gm1_plan`), K-gm1's forced tiles
    (`transport.gm1_plan`: its tiles' two fw tiles and slots, its threads, at
    least one member in flight) and its device-memory body's few static
    shared bytes, K-gm's two fw tiles of its largest band and each thread's 17
    faces and sources; no spills;
    resident blocks on an SM; K-gm's bands and the members in flight
    (groups of bands resident at once). P-gm, where `gm_plan` cuts the grid
    (not 256x256): its bytes a block as `gm_layout` counts them, its
    blocks a member, no spills, and at least one member in flight."""
    from historymatching_tpu_torch.ops.pressure import gm1_plan, gm_bytes, gm_plan
    from historymatching_tpu_torch.ops.transport import gm_plan as k_gm_plan

    for name in ("pressure_pcg_gm1", "pressure_pcg_cheb_gm1", "pressure_pcg_diag_gm1",
                 "pressure_pcg_cheb_diag_gm1"):
        p = _build.kernel_info(name, Nx, Ny)
        plan = gm1_plan(Nx, Ny, "_diag" not in name)
        print(f"{name} {Nx}x{Ny}: {p}")
        assert p["shared_bytes"] == plan.smem_bytes and p["threads"] == plan.threads, p
        assert p["local_bytes"] == 0 and p["blocks_per_sm"] >= 1, p
    from historymatching_tpu_torch.ops.transport import DEVICE, tile_bytes, tile_dims
    from historymatching_tpu_torch.ops.transport import gm1_plan as k_gm1_plan

    k = _build.kernel_info("transport_upwind_gm1", Nx, Ny)
    plan = k_gm1_plan(Nx, Ny)
    assert k["local_bytes"] == 0 and k["blocks_per_sm"] >= 1 and k["groups_resident"] >= 1, k
    assert k["threads"] == plan.threads and k["tiles"] == plan.gr * plan.gc, k
    assert k["shared_bytes"] == tile_bytes(*tile_dims(Nx, Ny, plan), plan.strip, plan.cols,
                                           "shared"), k
    k = _build.kernel_info("transport_upwind_gm1", Nx, Ny, DEVICE)
    assert k["shared_bytes"] <= 1024 and k["local_bytes"] == 0 and k["blocks"] >= 132, k
    for name in ("pressure_pcg_gm", "pressure_pcg_cheb_gm", "pressure_pcg_diag_gm",
                 "pressure_pcg_cheb_diag_gm"):
        unit = "_diag" not in name
        plan = gm_plan(Nx, Ny, unit)
        if plan is None:
            continue
        p = _build.kernel_info(name, Nx, Ny)
        print(f"{name} {Nx}x{Ny}: {p}")
        assert p["shared_bytes"] == gm_bytes(Nx, Ny, n_levels(Nx, Ny), *plan, unit), p
        assert p["local_bytes"] == 0 and p["blocks"] == plan[0] and p["groups_resident"] >= 1, p
    k = _build.kernel_info("transport_upwind_gm", Nx, Ny)
    bands = k_gm_plan(Nx, Ny)[0]
    rows = max(h for _, h in bands)
    print(f"K-gm {Nx}x{Ny}: {k}")
    assert k["local_bytes"] == 0 and k["blocks_per_sm"] >= 1, k
    assert k["bands"] == len(bands) and k["groups_resident"] >= 1, k
    threads = -(-rows // 4) * Ny
    assert k["threads"] == threads and k["shared_bytes"] == 4 * (2 * rows * Ny + 17 * threads), k


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("Nx,Ny,B", [(60, 60, 8), (88, 88, 8), (96, 96, 8), (128, 128, 8),
                                     (128, 128, 5), (60, 220, 8), (192, 192, 8),
                                     (256, 256, 8)])
def test_pressure_cl_matches_plain(dev, Nx, Ny, B, smoother, unit_diag):
    """P-cl forced, against the plain version after one window of 4
    iterations: 60x60 (the inverse read in place, a 30x30 level gathered on
    both ranks), 88x88 (its 11x11 inverse in place, over four ranks), 96x96,
    128x128 (on 8 members and on 5) and 192x192 (the small coarse levels on
    each rank's warp), 256x256 (16 ranks, four split levels), 60x220 (its
    825-cell inverse distributed over 15 or 16 ranks, P-cl/d). The unscaled
    system on fields of mild contrast, as the shared-memory P."""
    _pressure_vs_plain(dev, Nx, Ny, smoother, unit_diag=unit_diag, window=4,
                       scale=1.0 if unit_diag else 0.2, force="cl", B=B)


# P-cl/d's grids with their plans (c ranks, the inverse distributed), and
# the inverse read in place on two ranks (P-cl's plan there before P-cl/d;
# the unscaled 60x220 has none).
CL_D_CASES = [((Nx, Ny), unit, place) for Nx, Ny in ((100, 100), (60, 220))
              for unit in (True, False) for place in ("distributed", "device")
              if (Nx, Ny, unit, place) != (60, 220, False, "device")]


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("grid,unit_diag,place", CL_D_CASES)
def test_pressure_cl_distributed_matches_plain(dev, grid, unit_diag, place, smoother):
    """P-cl/d at 100x100 (9 ranks, bands of 12 and 8 rows, 70 rows of the
    625-row inverse a rank) and 60x220 (15 ranks scaled, 16 unscaled with
    the last holding no rows; bands of 4 rows, 55 or 52 rows of the 825-row
    inverse), and the in-place plan on two ranks, against the plain version
    after one window of 4 iterations, on 4 members (each member's inverse
    block starts at another 16-byte phase: the bulk copy's aligned middle
    and plain ends)."""
    from historymatching_tpu_torch.ops.pressure import cl_plan

    plan = cl_plan(*grid, unit_diag, place)
    assert place == "device" or plan == cl_plan(*grid, unit_diag)
    _pressure_vs_plain(dev, *grid, smoother, unit_diag=unit_diag, window=4,
                       scale=1.0 if unit_diag else 0.2, plan=plan, B=4)


# K-cl's route grids: between them several strips a band, a short last
# strip (100x100), one strip a band, and one, two and four ranks an SM.
KCL_GRIDS = [(80, 80), (88, 88), (96, 96), (100, 100), (128, 128), (60, 220), (192, 192),
             (256, 256)]


@pytest.mark.parametrize("Nx,Ny", KCL_GRIDS)
def test_transport_cl_matches_plain(dev, Nx, Ny):
    """K-cl on its route at every grid it takes: the plain version's
    operations in its order, so bit for bit; members with 0, 1, 3 and 5
    substeps (each substep's edge rows pushed into the slots of parity
    k & 1: a count below two and odd counts); a shared source field too."""
    assert transport_route(Nx, Ny) == "cl"
    args = _transport_inputs(dev, Nx, Ny, 11)
    args[5][:4] = torch.tensor([0, 1, 3, 5], dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["transport_upwind_cl"]
    out = transport_substeps_cuda(*args, force="cl")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_cl"] == before + 1
    assert torch.equal(out, transport_substeps_torch(*args))
    s, Fx, Fy, q, dts_pv, n_sub, fluid = args
    q1 = q[:1].contiguous()
    assert torch.equal(transport_substeps_cuda(s, Fx, Fy, q1, dts_pv, n_sub, fluid, "cl"),
                       transport_substeps_torch(s, Fx, Fy, q1, dts_pv, n_sub, fluid))


@pytest.mark.parametrize("Nx,Ny", [(60, 60), (88, 88), (96, 96), (100, 100), (128, 128),
                                   (60, 220), (192, 192), (256, 256)])
def test_cl_kernel_resources(dev, Nx, Ny):
    """The cluster variants' footprints: the bytes a rank that the layout
    counts (`ops/pressure.layout` with `cl`; K-cl's `cl_bytes`), no spills,
    a block resident on an SM (K-cl: the ranks an SM its plan asks for,
    `cl_ranks`) and a cluster on the card."""
    from historymatching_tpu_torch.ops.pressure import cl_bytes, cl_plan

    for name, unit in (("pressure_pcg_cl", True), ("pressure_pcg_cheb_cl", True),
                       ("pressure_pcg_diag_cl", False), ("pressure_pcg_cheb_diag_cl", False)):
        # the route's plan, and where it distributes the inverse the in-place one
        plans = {cl_plan(Nx, Ny, unit)}
        if cl_plan(Nx, Ny, unit)[1] == "distributed":
            plans.add(cl_plan(Nx, Ny, unit, "device"))
        for c, place in plans - {None}:
            p = _build.kernel_info(name, Nx, Ny, (c, place))
            assert p["shared_bytes"] == cl_bytes(Nx, Ny, n_levels(Nx, Ny), c, unit, place), (
                name, p)
            assert p["cluster"] == c and p["local_bytes"] == 0, (name, place, p)
            assert p["blocks_per_sm"] >= 1 and p["max_active_clusters"] >= 1, (name, place, p)
    if transport_route(Nx, Ny) == "cl":
        from historymatching_tpu_torch.ops.transport import cl_bytes, cl_plan, cl_ranks

        plan = cl_plan(Nx, Ny)
        k = _build.kernel_info("transport_upwind_cl", Nx, Ny)
        assert k["local_bytes"] == 0 and k["shared_bytes"] == cl_bytes(Nx, Ny, plan), k
        assert k["blocks_per_sm"] >= cl_ranks(Nx, Ny, plan) >= 1, k
        assert k["cluster"] == plan.c and k["max_active_clusters"] >= 1, k


def test_npv_batch_with_wells_per_member(dev):
    """An EnOpt batch at 20x20: eight members on one permeability field,
    each with its own injector, one `npv` call of 6 steps. The grid never
    recooks, so the batch takes one P and one K launch a step; each value
    matches the member run alone to 1e-3 relative (the batch's float32 torch
    reductions round otherwise than one member's, and the solves stop at
    tol 2e-3)."""
    from historymatching_tpu_torch.opt.npv import NPVConfig, npv_value

    g = torch.Generator(device=dev).manual_seed(4)
    m = _model(20, 20, dev)
    mm = set_perm(m, 0.5 * torch.randn(m.Nxy, generator=g, device=dev))
    xy = torch.rand(8, 1, 2, generator=g, device=dev) * torch.tensor([2.0, 1.0], device=dev)
    cfg = NPVConfig(dt=0.025, nTime=6)
    before = dict(_build.LAUNCHES)
    v = npv_value(mm, cfg, inj_xy=xy)
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before if k in (
        "pressure_pcg", "transport_upwind", "pressure_pcg_cheb")} == {
        "pressure_pcg": 6, "transport_upwind": 6, "pressure_pcg_cheb": 0}
    assert sum(_build.LAUNCHES.values()) - sum(before.values()) == 12
    assert v.shape == (8,) and torch.isfinite(v).all() and bool((v != 0).any())
    for b in range(3):
        one = npv_value(mm, cfg, inj_xy=xy[b])
        assert abs(float(one) - float(v[b])) <= 1e-3 * abs(float(one))
