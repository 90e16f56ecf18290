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
from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.multigrid import build_hierarchy, coarse_inverse, n_levels
from historymatching_tpu_torch.ops.pressure import (
    kernel_name,
    pressure_solve_cuda,
    pressure_solve_recook,
    pressure_solve_torch,
    recook_plan,
    smem_bytes,
)
from historymatching_tpu_torch.ops.stencil import stencil_residual_ds
from historymatching_tpu_torch.ops.transport import (
    transport_substeps,
    transport_substeps_cuda,
    transport_substeps_torch,
)
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


def _pressure_vs_plain(dev, Nx, Ny, smoother, unit_diag=True, window=16, scale=1.0):
    """One launch of P's `smoother` instantiation against the plain version
    with the same smoother, after fixed work (one restart window of
    `window` iterations, or two of 8 for 16); the launch counts on that
    instantiation's own key. Without `unit_diag`, on the unscaled system
    (the instantiation that reads the fine diagonal); `scale` multiplies
    the pre-permeability fields."""
    g = torch.Generator(device=dev).manual_seed(1)
    m = _model(Nx, Ny, dev)
    B = 8
    mm = set_perm(m, scale * torch.randn(B, m.Nxy, generator=g, device=dev))
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    args = _system(mm, q, unit_diag)
    fixed = dict(tol=0.0, maxiter=window, restart_every=min(window, 8), patience_iters=160,
                 smoother=smoother, unit_diag=unit_diag)
    name = kernel_name(smoother, unit_diag)
    before = dict(_build.LAUNCHES)
    p_k, it_k, rel_k = pressure_solve_cuda(*args, **fixed)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]} == {name: 1}
    p_t, it_t, rel_t = pressure_solve_torch(*args, **fixed)
    assert torch.equal(it_k, it_t)
    dn, nt = (p_k - p_t).norm(dim=(-2, -1)), p_t.norm(dim=(-2, -1))
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
                                   (64, 64), (5, 3)])
def test_transport_runtime_grid_matches_plain(dev, Nx, Ny):
    """K's runtime-grid variant does the plain version's float32 operations
    in its order, so it agrees bit for bit, at grids outside `GRIDS` and,
    forced, at 64x64."""
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
    out = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid,
                                  runtime_grid=True if (Nx, Ny) in _build.GRIDS else None)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind_rt"] == before + 1
    ref = transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    assert torch.equal(out, ref)


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
    k = _build.kernel_info("transport_upwind_rt", Nx, Ny)
    assert k["shared_bytes"] == 2 * 4 * Nx * Ny and k["blocks_per_sm"] >= 1


def test_build_defaults_to_cuda(dev):
    assert ResSim.build(Nx=16, Ny=16).K.is_cuda


def test_kernels_refuse_what_they_do_not_take(dev):
    s = torch.zeros(2, 8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        transport_substeps(s, torch.zeros(2, 9, 8, dtype=torch.float64, device=dev),
                           torch.zeros(2, 8, 9, dtype=torch.float64, device=dev), s,
                           torch.ones(2, dtype=torch.float64, device=dev),
                           torch.ones(2, dtype=torch.int32, device=dev), (1.0, 1.0, 0.0, 0.0))
    big = torch.zeros(1, 128, 128, device=dev)
    huge = torch.zeros(1, 171, 171, device=dev)
    with pytest.raises(ValueError, match="171x171 grid needs 233928 bytes"):
        transport_substeps(huge, torch.zeros(1, 172, 171, device=dev),
                           torch.zeros(1, 171, 172, device=dev), huge,
                           torch.ones(1, device=dev),
                           torch.ones(1, dtype=torch.int32, device=dev), (1.0, 1.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="128x128 grid needs 458528 bytes"):
        pressure_solve_cuda([], torch.zeros(1, 16, 16, device=dev), big, big, big, tol=1e-3,
                            maxiter=8)


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
