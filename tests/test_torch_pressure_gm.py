"""What the CPU can check of P-gm, kernel P on a member spread over
co-resident blocks (csrc/pressure_pcg_gm.cu): its plan (`ops/pressure.gm_plan`
and the bands, inverse rows, threads and shared-memory layout behind it),
the constants it shares with the CUDA source, the routes around it (P-gm1,
one block a member, where no plan fits), and its schedule, in a plain
emulation held to the plain version and to the JAX package's Pallas kernel.

The emulation (`blocked_solve`) runs each block of a member as its own
coroutine, as the kernel does: a block sees only its band of every split
level (with a halo row above and below), the whole coarsest level's
right-hand side and correction, and its rows of the coarsest inverse. It
stores its band's edge rows into its slot for the next point (two slots,
by the point count's parity), publishes the count on its flag, and copies
a neighbour's rows only once the neighbour's flag has reached the point;
member-wide points (the reductions and the coarse solve) wait for every
flag and sum the blocks' totals in block order. A seeded scheduler
interleaves the blocks as far as those waits allow. Every slot, total and
coarse value carries the point it was written for, and a read asserts it
is the point just passed, so a slot overwritten before its reader copied
it, or read before it was written, fails. One group of blocks runs the
members one after another with its counts carried on, as the kernel's
groups do.

Tolerances: float64 against `pressure_solve_torch` after one window of 8
iterations within 1e-9 relative (the blocks' totals and the band-wise
sweeps sum in another order than torch; the window amplifies it), with
equal iteration counts; float32 against `pressure_solve_pallas` in
interpret mode by tests/test_torch_pressure.py's measure: the relative
residual of both below 1e-3 and p within 2e-3 max|p|. The kernel runs only
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from historymatching_tpu.ops.multigrid import build_hierarchy_5pt as build_j
from historymatching_tpu.ops.pressure_pallas import pressure_solve_pallas
from historymatching_tpu.ops.stencil import stencil_matvec as matvec_j
from historymatching_tpu_torch.models.ressim import _tpfa
from historymatching_tpu_torch.ops import _build, pressure
from historymatching_tpu_torch.ops.multigrid import (
    CHEB_BOUNDS,
    build_hierarchy,
    build_hierarchy_5pt,
    coarse_inverse,
    n_levels,
)
from historymatching_tpu_torch.ops.pressure import (
    GM_BATCH_MAX,
    GM_MAX_BLOCKS,
    GM_MAX_THREADS,
    GM_MIN_THREADS,
    GM_TILES_A_THREAD,
    LEVEL_KEYS,
    gm_bands,
    gm_bytes,
    gm_inverse_rows,
    gm_layout,
    gm_net_floats,
    gm_plan,
    gm_threads,
    pressure_solve_cuda,
    pressure_solve_torch,
)
from historymatching_tpu_torch.parallel.runner import set_perm
from tests.torch_helpers import default_model, perm_fields, scaled_system


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nc(Nx, Ny):
    lc = n_levels(Nx, Ny) - 1
    return (Nx >> lc) * (Ny >> lc)


def _ranks(Nx, Ny, G):
    return sum(1 for _, h in gm_bands(Nx, Ny, G) if h)


# ---------------------------------------------------------------- the plan

# Grids P-gm takes (its route: 120x440, the scaled 100x100 past 192
# members), grids where it is forced (the cluster grids, 64x64), small
# grids, and grids past its capacity.
PLAN_GRIDS = [(120, 440), (100, 100), (60, 220), (128, 128), (64, 64), (60, 60), (88, 88),
              (96, 96), (80, 80), (16, 48), (24, 40), (8, 8)]


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", PLAN_GRIDS)
def test_gm_plan_covers_every_row_once_and_fits(Nx, Ny, unit_diag):
    """The plan's bands cover every row of every split level once, in order,
    each an even count, the banded blocks first; the inverse's rows are
    partitioned 0..nc-1 in order; every block, banded or not, fits one
    block's shared memory; and no plan of fewer blocks does."""
    G, kb = gm_plan(Nx, Ny, unit_diag)
    levels = n_levels(Nx, Ny)
    bands = gm_bands(Nx, Ny, G)
    ranks = _ranks(Nx, Ny, G)
    assert len(bands) == G and all(h > 0 for _, h in bands[:ranks])
    assert all(h == 0 for _, h in bands[ranks:])
    for lvl in range(levels - 1):
        cover = [i for f, h in bands for i in range(f >> lvl, (f + h) >> lvl)]
        assert cover == list(range(Nx >> lvl))
        assert all((h >> lvl) % 2 == 0 for _, h in bands)
    nc = _nc(Nx, Ny)
    rows = gm_inverse_rows(nc, G, ranks, kb)
    assert [i for a, b in rows for i in range(a, b)] == list(range(nc))
    assert gm_bytes(Nx, Ny, levels, G, kb, unit_diag) <= _build.SMEM_LIMIT
    assert gm_threads(Nx, Ny, G) % 128 == 0
    for g in range(1, G):  # fewer blocks fit with no split of the inverse's rows
        r = _ranks(Nx, Ny, g)
        assert all(gm_bytes(Nx, Ny, levels, g, k, unit_diag) > _build.SMEM_LIMIT
                   or sum(b - a for a, b in gm_inverse_rows(nc, g, r, k)) < nc
                   for k in range(0, -(-nc // g) + 1))


# The plans P-gm takes on its path and where it is forced: (G, kb, bytes a
# block, threads), scaled and unscaled. 120x440: 15 bands of 8 rows, the
# other blocks rows of the inverse only (6 scaled, 9 unscaled).
GM_PLANS = {
    (120, 440): ((21, 28, 231_120, 256), (24, 18, 231_568, 256)),
    (100, 100): ((9, 70, 217_728, 256), (9, 70, 228_928, 256)),
    (60, 220): ((15, 55, 225_184, 256), (16, 52, 225_840, 256)),
    (128, 128): ((4, 4, 125_920, 256), (4, 4, 160_736, 256)),
    (64, 64): ((1, 16, 120_672, 256), (1, 16, 154_464, 256)),
}


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("grid", list(GM_PLANS))
def test_gm_plans(grid, unit_diag):
    G, kb, nbytes, threads = GM_PLANS[grid][0 if unit_diag else 1]
    levels = n_levels(*grid)
    assert gm_plan(*grid, unit_diag) == (G, kb)
    assert gm_bytes(*grid, levels, G, kb, unit_diag) == nbytes
    assert gm_threads(*grid, G) == threads
    if grid == (120, 440):
        assert [h for _, h in gm_bands(*grid, G)] == [8] * 15 + [0] * (G - 15)


def test_plan_constants_match_the_cuda_source():
    """`gm_threads` and `gm_plan` use the kernel's thread rule and
    shared-memory limit."""
    with open(os.path.join(_build.CSRC, "pressure_pcg_gm.cu")) as f:
        text = f.read()
    got = re.search(r"constexpr int kTilesAThread = (\d+), kMinThreads = (\d+), "
                    r"kMaxThreads = (\d+);", text)
    assert tuple(map(int, got.groups())) == (GM_TILES_A_THREAD, GM_MIN_THREADS, GM_MAX_THREADS)
    assert int(re.search(r"constexpr int kSmemLimit = (\d+);", text).group(1)) == _build.SMEM_LIMIT
    assert re.search(r"constexpr int kSmPerSm = 228 \* 1024;", text)
    assert _build.SMEM_PER_SM == 228 * 1024 and GM_MAX_BLOCKS == 132


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", [(120, 440), (100, 100), (16, 48), (60, 220)])
def test_gm_layout_arrays_fit_and_do_not_overlap(Nx, Ny, unit_diag):
    """A block's arrays lie inside its floats, 4-aligned, and do not overlap
    (each intermediate level's temporary inside the fine one, as P-cl's);
    a block without a band puts its inverse rows right after the head."""
    G, kb = gm_plan(Nx, Ny, unit_diag)
    levels = n_levels(Nx, Ny)
    lv, extra, floats = gm_layout(Nx, Ny, levels, G, kb, unit_diag)
    nc = _nc(Nx, Ny)
    warps = gm_threads(Nx, Ny, G) // 32
    spans = [(("coarse_B",), extra["coarse_B"], extra["coarse_B"] + nc),
             (("coarse_X",), extra["coarse_X"], extra["coarse_X"] + nc),
             (("reduction",), extra["reduction"], extra["reduction"] + 2 * warps),
             (("barrier",), extra["barrier"], extra["barrier"] + 2),
             (("inverse",), extra["inverse"], extra["inverse"] + kb * nc + 3)]
    for lvl, d in enumerate(lv[:-1]):
        h, m = d["n"] + 2, d["m"]
        keys = ("TX", "TY", "X", "B", "T") + (() if lvl == 0 and unit_diag else ("D", "RD"))
        spans += [((k, lvl), d[k], d[k] + h * m) for k in keys]  # from the halo row above
    assert all(o % 4 == 0 and 0 <= o < e <= floats for _, o, e in spans)
    coarse_t = lambda k: k[0] == "T" and k[1] > 0  # noqa: E731
    own = sorted((o, e, k) for k, o, e in spans if not coarse_t(k))
    assert all(e1 <= o2 for (_, e1, _), (o2, _, _) in zip(own, own[1:])), own
    fine_t = next((o, e) for k, o, e in spans if k == ("T", 0))
    assert all(fine_t[0] <= o and e <= fine_t[1] for k, o, e in spans if coarse_t(k))
    assert lv[-1]["B"] == extra["coarse_B"] and lv[-1]["X"] == extra["coarse_X"]
    assert set(LEVEL_KEYS) <= set(lv[0])
    if G > _ranks(Nx, Ny, G):
        kn = max(b - a for a, b in gm_inverse_rows(nc, G, _ranks(Nx, Ny, G), kb))
        assert extra["inverse_only"] == extra["barrier"] + 4
        assert extra["inverse_only"] + kn * nc + 3 <= floats
    assert gm_net_floats(Nx, Ny, G) >= G * 4 * Ny + 4 * G + 2 * nc


# P's route by grid, fine diagonal and batch where P-gm or P-gm1 takes it:
# at 120x440 P-gm up to GM_BATCH_MAX's batch, P-gm1 past it; at the scaled
# 100x100 and 60x220 past DIST_BATCH_MAX P-gm1 (P-gm lost to it there).
GM_ROUTES = {
    (120, 440, True, None): "gm1", (120, 440, False, None): "gm1",
    (120, 440, True, 16): "gm", (120, 440, False, 16): "gm",
    (120, 440, True, GM_BATCH_MAX[(120, 440, True)]): "gm",
    (120, 440, True, GM_BATCH_MAX[(120, 440, True)] + 1): "gm1",
    (120, 440, False, GM_BATCH_MAX[(120, 440, False)] + 1): "gm1",
    (100, 100, True, 1000): "gm1", (100, 100, True, None): "gm1",
    (100, 100, True, 64): "cl", (100, 100, False, 1000): "cl",
    (60, 220, True, 1000): "gm1", (60, 220, True, None): "gm1", (60, 220, True, 256): "cl",
    (60, 220, True, 257): "gm1", (60, 220, False, 1000): "cl",
    (32, 1088, True, 4): "gm1", (32, 1088, False, 4): "gm1",
    (8, 5000, True, None): "gm1", (192, 192, True, None): "cl",
}


@pytest.mark.parametrize("key", list(GM_ROUTES))
def test_gm_routes_and_capacity(key):
    """P-gm where no cluster holds the grid (120x440) up to the batch of
    `GM_BATCH_MAX`, P-gm1 past it and past the scaled 100x100's and
    60x220's `DIST_BATCH_MAX` (P-gm lost to P-gm1 at every batch timed
    there); P-gm1,
    before any launch, where `gm_plan` gives no plan (a band of
    2**(levels - 1) rows too wide for a block:
    32x1088, 8x5000; 192x192, where P-cl takes it). P-gm forced where it
    has no plan is refused; P-gm1 forced anywhere,
    and P-gm where it has a plan, reach the wrapper's refusal of CPU
    tensors (nothing falls back)."""
    Nx, Ny, unit, batch = key
    rt = GM_ROUTES[key]
    assert pressure.route(Nx, Ny, unit, batch) == rt
    has_plan = gm_plan(Nx, Ny, unit) is not None
    assert has_plan or rt != "gm"
    assert has_plan or (Nx, Ny, unit) not in GM_BATCH_MAX
    z = torch.zeros(1, Nx, Ny)
    hier = build_hierarchy_5pt(torch.zeros(1, Nx - 1, Ny), torch.zeros(1, Nx, Ny - 1), z)
    nc = hier[-1][2][0].numel()
    args = (hier, torch.zeros(1, nc, nc), z, z, z)
    if not has_plan:
        with pytest.raises(ValueError, match="no plan of P-gm"):
            pressure_solve_cuda(*args, tol=1e-3, maxiter=8, unit_diag=unit, force="gm")
    for force in ("gm1",) + (("gm",) if has_plan else ()) + (None,):
        with pytest.raises(ValueError, match="need float32 CUDA"):
            pressure_solve_cuda(*args, tol=1e-3, maxiter=8, unit_diag=unit, force=force)
    assert pressure.kernel_name("cheb", unit, rt) == (
        "pressure_pcg_cheb" + ("" if unit else "_diag") + "_" + rt)


# ----------------------------------------------------------- the emulation

OMEGA, OMEGA_C = 0.7, 1.4


class _Group:
    """One group's exchange: the flags, the blocks' slots and totals, and the
    coarse right-hand side and correction, each value with the point it was
    written for."""

    def __init__(self, G, Ny, nc, dtype):
        self.flags = [0] * G
        self.slots = {}  # (block, parity, first/last) -> (point, row)
        self.totals = {}  # (block, parity) -> (point, (a, b))
        self.cb = torch.full((nc,), float("nan"), dtype=dtype)
        self.cx = torch.full((nc,), float("nan"), dtype=dtype)
        self.cb_at = torch.zeros(nc, dtype=torch.int64)
        self.cx_at = torch.zeros(nc, dtype=torch.int64)


def blocked_solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96, restart_every=8,
                  smoother="jacobi", unit_diag=True, G=3, kb=None, seed=0):
    """P-gm's schedule in plain torch: every member on G blocks (the bands of
    `gm_bands`, `kb` inverse rows a banded block, by default ceil(nc / G)),
    one group running the members in turn, the blocks interleaved at
    random (`seed`) as far as their waits allow. Same arguments and results
    as `pressure_solve_torch`."""
    B, Nx, Ny = q.shape
    levels, dtype = len(hier), q.dtype
    lc = levels - 1
    nc = _nc(Nx, Ny)
    bands = gm_bands(Nx, Ny, G)
    ranks = _ranks(Nx, Ny, G)
    kb = -(-nc // G) if kb is None else kb
    inv_rows = gm_inverse_rows(nc, G, ranks, kb)
    assert sum(b - a for a, b in inv_rows) == nc
    patience = max(4, -(-patience_iters // restart_every))
    lmin, lmax = CHEB_BOUNDS
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho0 = 1.0 / sigma
    rho1 = 1.0 / (2.0 * sigma - rho0)
    grp = _Group(G, Ny, nc, dtype)
    rng = np.random.default_rng(seed)
    p_out = torch.zeros_like(q)
    it_out = torch.zeros(B, dtype=torch.int32)
    rel_out = torch.zeros(B, dtype=q.dtype)

    def block(r):
        first, h0 = bands[r]
        banded = r < ranks
        up, dn = banded and r > 0, banded and r < ranks - 1
        st = {"e": 0, "mw": 0}

        def put_slot(v_own):
            """The band's first and last rows into the slots of the next point."""
            nxt = st["e"] + 1
            if up:
                grp.slots[(r, nxt & 1, 0)] = (nxt, v_own[0].clone())
            if dn:
                grp.slots[(r, nxt & 1, 1)] = (nxt, v_own[-1].clone())

        def copy_halos(vh):
            e = st["e"]
            if up:
                at, row = grp.slots[(r - 1, e & 1, 1)]
                assert at == e, ("stale or early slot", r, at, e)
                vh[0] = row
            if dn:
                at, row = grp.slots[(r + 1, e & 1, 0)]
                assert at == e, ("stale or early slot", r, at, e)
                vh[-1] = row

        def sync_nb(vh=None):
            st["e"] += 1
            grp.flags[r] = st["e"]
            yield
            while (up and grp.flags[r - 1] < st["e"]) or (dn and grp.flags[r + 1] < st["e"]):
                yield
            if vh is not None:
                copy_halos(vh)

        def sync_all(a=0.0, b=0.0, vh=None):
            st["e"] += 1
            st["mw"] += 1
            par = st["mw"] & 1
            grp.totals[(r, par)] = (st["e"], (a, b))
            grp.flags[r] = st["e"]
            yield
            while any(f < st["e"] for f in grp.flags):
                yield
            ta, tb = 0.0, 0.0
            for k in range(G):
                at, (a_k, b_k) = grp.totals[(k, par)]
                assert at == st["e"], ("stale or early total", k, at, st["e"])
                ta, tb = (a_k if k == 0 else ta + a_k), (b_k if k == 0 else tb + b_k)
            if vh is not None:
                copy_halos(vh)
            return ta, tb

        def band_of(lvl, t, fill=0.0):
            """Level lvl's rows of member tensor t around the band (one halo
            row each side), `fill` outside the grid."""
            f, h, n = first >> lvl, h0 >> lvl, Nx >> lvl
            out = torch.full((h + 2, t.shape[-1]), fill, dtype=dtype)
            lo, hi = max(f - 1, 0), min(f + h + 1, n)
            out[lo - (f - 1):hi - (f - 1)] = t[lo:hi]
            return out

        def matvec(lv, vh):
            TXb, TYb, Db = lv["TX"], lv["TY"], lv["D"]
            v = vh[1:-1]
            out = Db[1:-1] * v
            out = out - TXb[1:] * vh[2:]
            out = out - TXb[:-1] * vh[:-2]
            out = out - F.pad(TYb * v[:, 1:], (0, 1))
            out = out - F.pad(TYb * v[:, :-1], (1, 0))
            return out

        def halo_rows(vh):
            """Zero the halo rows outside the grid (the kernel reads 0 there)."""
            if not up:
                vh[0] = 0.0
            if not dn:
                vh[-1] = 0.0
            return vh

        def prolong_add(lv_x, E, lvl):
            """x + omega_c e(parent) on the band and its halo rows, e from the
            parent's rows (its band with halos, or the whole coarsest level)."""
            f, h = first >> lvl, h0 >> lvl
            x = lv_x.clone()
            rows = range(-1, h + 1)
            for i in rows:
                if (i == -1 and not up) or (i == h and not dn):
                    continue
                pi = (f + i) // 2 - (f // 2 - 1 if lvl + 1 < lc else 0)
                x[i + 1] = x[i + 1] + OMEGA_C * E[pi].repeat_interleave(2)
            return x

        def vcycle(L, R):
            """z on the band from the fine right-hand side R (halo'd); a
            block without a band passes the same points and multiplies its
            rows of the inverse."""
            Bs = [R] + [None] * lc
            xh = bh = None
            for lvl in range(lc):
                if banded:
                    lv, b = L[lvl], Bs[lvl]
                    d = lv["D"]
                    if smoother == "jacobi":
                        t = halo_rows(OMEGA * b / d)
                        x = t[1:-1] + OMEGA * (b[1:-1] - matvec(lv, t)) / d[1:-1]
                    else:
                        t = halo_rows((b / d) * (1.0 / theta))
                        rr = b[1:-1] - matvec(lv, t)
                        x = t[1:-1] + ((rho1 * rho0) * t[1:-1]
                                       + (2.0 * rho1 / delta) * (rr / d[1:-1]))
                    xh = torch.zeros_like(b)
                    xh[1:-1] = x
                    put_slot(x)
                yield from sync_nb(xh)
                if banded:
                    lv["X"] = xh
                    res = b[1:-1] - matvec(lv, xh)
                    h = res.shape[0]
                    rc = res.reshape(h // 2, 2, -1, 2).sum(dim=(1, 3))
                    if lvl + 1 < lc:
                        bh = torch.zeros(h // 2 + 2, rc.shape[-1], dtype=dtype)
                        bh[1:-1] = rc
                        put_slot(rc)
                    else:  # the coarsest level's right-hand side, to the group
                        f, mc = (first >> lvl) // 2, rc.shape[-1]
                        grp.cb[f * mc:(f + h // 2) * mc] = rc.reshape(-1)
                        grp.cb_at[f * mc:(f + h // 2) * mc] = st["e"] + 1
                if lvl + 1 < lc:
                    yield from sync_nb(bh)
                    Bs[lvl + 1] = bh
            yield from sync_all()
            assert bool((grp.cb_at == st["e"]).all()), "stale coarse right-hand side"
            a, b_ = inv_rows[r]
            grp.cx[a:b_] = Ainv_b[a:b_] @ grp.cb.clone()
            grp.cx_at[a:b_] = st["e"] + 1
            yield from sync_all()
            E = z = None
            if banded:  # the coarse rows the prolongation reads
                mcl = Ny >> lc
                fl, hl = (first >> (lc - 1)) // 2, (h0 >> (lc - 1)) // 2
                lo, hi = max(fl - 1, 0), min(fl + hl + 1, Nx >> lc)
                assert bool((grp.cx_at[lo * mcl:hi * mcl] == st["e"]).all()), "stale correction"
                E = torch.full((Nx >> lc, mcl), float("nan"), dtype=dtype)
                E[lo:hi] = grp.cx[lo * mcl:hi * mcl].reshape(hi - lo, mcl)
            th = xh = None
            for lvl in range(lc - 1, -1, -1):
                if banded:
                    lv, b = L[lvl], Bs[lvl]
                    d = lv["D"]
                    x = prolong_add(lv["X"], E, lvl)
                    if smoother == "jacobi":
                        t = x[1:-1] + OMEGA * (b[1:-1] - matvec(lv, x)) / d[1:-1]
                    else:
                        t = x[1:-1] + (b[1:-1] - matvec(lv, x)) / d[1:-1] * (1.0 / theta)
                    th = torch.zeros_like(b)
                    th[1:-1] = t
                    put_slot(t)
                yield from sync_nb(th)
                if banded:
                    if smoother == "jacobi":
                        x2 = t + OMEGA * (b[1:-1] - matvec(lv, th)) / d[1:-1]
                    else:
                        x2 = t + ((rho1 * rho0) * (t - x[1:-1])
                                  + (2.0 * rho1 / delta) * ((b[1:-1] - matvec(lv, th)) / d[1:-1]))
                    if lvl == 0:
                        z = x2
                    else:
                        xh = torch.zeros_like(b)
                        xh[1:-1] = x2
                        put_slot(x2)
                if lvl > 0:
                    yield from sync_nb(xh)
                    E = xh
            return z

        for bi in range(B):
            Ainv_b = Ainv[bi]
            L = []
            if banded:
                for lvl in range(lc):
                    TX, TY, D = hier[lvl]
                    f, h = first >> lvl, h0 >> lvl
                    n, m = Nx >> lvl, Ny >> lvl
                    txb = torch.zeros(h + 1, m, dtype=dtype)
                    lo, hi = max(f - 1, 0), min(f + h, n - 1)
                    txb[lo - (f - 1):hi - (f - 1)] = TX[bi, lo:hi]
                    d = torch.ones(h + 2, m, dtype=dtype) if (lvl == 0 and unit_diag) else (
                        band_of(lvl, D[bi], 1.0))
                    L.append({"TX": txb, "TY": TY[bi, f:f + h], "D": d})
            q_b = band_of(0, q[bi])[1:-1]
            w_b = band_of(0, w[bi])[1:-1]
            x = band_of(0, p0[bi])[1:-1].clone()
            xb = x.clone()
            Tv = torch.zeros(x.shape[0] + 2, Ny, dtype=dtype)
            Tv[1:-1] = x
            put_slot(x)
            yield from sync_nb(Tv)

            def residual(Tv):
                Rh = torch.zeros_like(Tv)
                if banded:
                    Rh[1:-1] = q_b - matvec(L[0], Tv)
                return Rh

            R = residual(Tv)
            put_slot(R[1:-1])
            wq2, wr2 = (w_b * q_b).pow(2).sum(), (w_b * R[1:-1]).pow(2).sum()
            bb, rr_best = yield from sync_all(wq2, wr2, R)
            tol2 = (tol * tol) * max(bb, torch.finfo(dtype).tiny)
            use_sd, r_valid, first_w, n_bad, kk = False, True, True, 0, 0
            p = torch.zeros_like(x)
            while kk < maxiter and rr_best > tol2 and n_bad < patience:
                if not r_valid:
                    Tv = torch.zeros_like(Tv)
                    Tv[1:-1] = x
                    put_slot(x)
                    yield from sync_nb(Tv)
                    R = residual(Tv)
                    put_slot(R[1:-1])
                    yield from sync_nb(R)
                z = yield from vcycle(L, R)
                z = torch.zeros_like(x) if z is None else z
                if use_sd or first_w:
                    p = z.clone()
                Ph = torch.zeros_like(Tv)
                Ph[1:-1] = p
                put_slot(p)
                rz, rr = yield from sync_all((R[1:-1] * z).sum(), (w_b * R[1:-1]).pow(2).sum(), Ph)
                beta_mask = 0.0 if use_sd else 1.0
                for _ in range(restart_every):
                    if not rr > tol2:
                        break
                    Ap = matvec(L[0], Ph) if banded else torch.zeros_like(x)
                    pAp, _ = yield from sync_all((p * Ap).sum())
                    alpha = rz / (1.0 if pAp == 0 else pAp)
                    x = x + alpha * p
                    R = R.clone()
                    R[1:-1] = R[1:-1] - alpha * Ap
                    put_slot(R[1:-1])
                    yield from sync_nb(R)
                    z = yield from vcycle(L, R)
                    z = torch.zeros_like(x) if z is None else z
                    rz_new, rr = yield from sync_all((R[1:-1] * z).sum(),
                                                     (w_b * R[1:-1]).pow(2).sum())
                    beta = beta_mask * rz_new / (1.0 if rz == 0 else rz)
                    p = z + beta * p
                    rz = rz_new
                    Ph = torch.zeros_like(Tv)
                    Ph[1:-1] = p
                    put_slot(p)
                    yield from sync_nb(Ph)
                Tv = torch.zeros_like(Tv)
                Tv[1:-1] = x
                put_slot(x)
                yield from sync_nb(Tv)
                R = residual(Tv)
                put_slot(R[1:-1])
                rr_new, _ = yield from sync_all((w_b * R[1:-1]).pow(2).sum(), 0.0, R)
                finite = bool(torch.isfinite(torch.as_tensor(rr_new)))
                blown = not finite or rr_new > 100.0 * max(rr_best, tol2)
                better = finite and rr_new < rr_best
                if better:
                    xb = x.clone()
                    rr_best = rr_new
                if blown:
                    x = xb.clone()
                n_bad = 0 if better else n_bad + 1
                use_sd, r_valid, first_w = blown, not blown, False
                kk += restart_every
            if banded:
                p_out[bi, first:first + h0] = xb
            if r == 0:
                it_out[bi] = kk
                rel_out[bi] = torch.sqrt(torch.as_tensor(rr_best)
                                         / max(bb, torch.finfo(dtype).tiny))

    running = [block(r) for r in range(G)]
    while running:
        co = running[rng.integers(len(running))]
        try:
            next(co)
        except StopIteration:
            running.remove(co)
    return p_out, it_out, rel_out


def _system(Nx, Ny, N, unit_diag, dtype, seed):
    """P's arguments on the JAX package's default model at a grid: the
    scaled system (fine diagonal 1), or the unscaled one on fields of mild
    contrast (w = 1); q a source and a sink."""
    m = default_model(Nx=Nx, Ny=Ny)
    perm = perm_fields(seed, N, m.Nxy, scale=0.6 if unit_diag else 0.2)
    q = np.zeros((N, Nx, Ny))
    q[:, Nx // 2, Ny // 2], q[:, 2, 2] = 1.0, -1.0
    if unit_diag:
        TXs, TYs, ones, w, _ = scaled_system(perm, m)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
        hier = build_hierarchy_5pt(t(TXs), t(TYs), t(ones))
        qs = t(q * (1.0 / np.asarray(w)))
        return hier, coarse_inverse(hier), qs, torch.zeros_like(qs), t(w)
    from historymatching_tpu_torch import convert

    mt = set_perm(convert.ressim_from_reference(m, dtype=dtype, device="cpu"),
                  torch.as_tensor(perm, dtype=dtype))
    TX, TY, _, pin = _tpfa(mt, torch.zeros(N, Nx, Ny, dtype=dtype))
    hier = build_hierarchy(TX, TY, pin)
    qt = torch.as_tensor(q, dtype=dtype)
    return hier, coarse_inverse(hier), qt, torch.zeros_like(qt), torch.ones_like(qt)


# (grid, G, kb): 16x48 (three levels, 4 units of 4 rows, a 4x12 coarsest
# level) on 3 blocks of 2, 1 and 1 units; on 6 blocks, 4 banded and 2
# holding only inverse rows (as at 120x440); on one block; and 24x40 (a
# 6x10 coarsest level, 3 units of 4 rows) on 4 blocks, one of them
# inverse rows only.
SPLITS = [((16, 48), 3, None), ((16, 48), 6, 5), ((16, 48), 1, None), ((24, 40), 4, 20)]


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("grid,G,kb", SPLITS)
def test_blocked_schedule_matches_plain_f64(grid, G, kb, smoother, unit_diag):
    """Float64, one window of 8 iterations: the blocks, each seeing only its
    band and what its neighbours and the member-wide points published, give
    the plain version's p within 1e-9 relative and its iteration counts,
    however the scheduler interleaves them (two members, one group)."""
    Nx, Ny = grid
    args = _system(Nx, Ny, 2, unit_diag, torch.float64, 3)
    window = dict(tol=0.0, maxiter=8, restart_every=8, patience_iters=160, smoother=smoother,
                  unit_diag=unit_diag)
    p_t, it_t, _ = pressure_solve_torch(*args, **window)
    p_g, it_g, _ = blocked_solve(*args, **window, G=G, kb=kb, seed=G)
    assert torch.equal(it_g, it_t)
    err = (p_g - p_t).norm(dim=(-2, -1)) / p_t.norm(dim=(-2, -1))
    assert float(err.max()) <= 1e-9, err


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("grid,G,kb", [((16, 48), 3, None), ((16, 48), 6, 5)])
def test_blocked_schedule_matches_pallas_interpret_f32(grid, G, kb, smoother, unit_diag):
    """Float32 to convergence (tol 1e-4): the blocks' solution and the JAX
    package's Pallas kernel in interpret mode, member by member, both with
    a relative residual below 1e-3 and within 2e-3 max|p| of each other."""
    Nx, Ny = grid
    hier, Ainv, q, p0, w = _system(Nx, Ny, 1, unit_diag, torch.float32, 5)
    p_g, _, rel_g = blocked_solve(hier, Ainv, q, p0, w, tol=1e-4, maxiter=256,
                                  smoother=smoother, unit_diag=unit_diag, G=G, kb=kb, seed=1)
    assert p_g.dtype == torch.float32 and float(rel_g[0]) < 1e-3
    lc = len(hier) - 1
    Nc, Mc = Nx >> lc, Ny >> lc
    TX, TY, D = (np.asarray(a[0]) for a in hier[0])
    hier_j = build_j(jnp.asarray(TX), jnp.asarray(TY), jnp.asarray(D))
    hier_flat = tuple(x for lvl in hier_j for x in lvl)
    qk = jnp.asarray(q[0].numpy())
    p_j, _, rel_j = pressure_solve_pallas(
        hier_flat, jnp.asarray(Ainv[0].numpy()).reshape(-1, Nc, Mc), qk, jnp.zeros_like(qk),
        jnp.asarray(w[0].numpy()), tol=1e-4, maxiter=256, interpret=True, smoother=smoother)
    assert float(rel_j) < 1e-3
    mv = lambda x: np.asarray(matvec_j(*hier_j[0], jnp.asarray(x)))  # noqa: E731
    nq = np.linalg.norm(q[0].numpy())
    for p_sol in (p_g[0].numpy(), np.asarray(p_j)):
        assert np.linalg.norm(q[0].numpy() - mv(p_sol)) / nq < 1e-3
    scale = np.abs(np.asarray(p_j)).max()
    assert np.allclose(p_g[0].numpy(), np.asarray(p_j), atol=2e-3 * scale)
