"""What the CPU can check of the tile body (csrc/transport_upwind.cu
`transport_upwind_tile_kernel`, built under -DHM_KT_*), which K-rt1 and
K-gm1 run: its plans (`ops/transport.rt1_plan`: a member in one block,
small members on their own block of warps; `gm1_plan`: a member over
co-resident 2-D tiles; K-gm1's device-memory body, `GM1Device`), the
routes around
them, the libraries they get, and their schedules in plain emulations
held to the plain version and to the JAX package's Pallas kernel.

`tiled_substeps` runs each tile of a member as its own coroutine: a tile
sees only its own cells, computes their fw, writes its first and last fw
rows and columns into its halo slot k & 1, publishes k + 1 on its flag,
and reads a neighbour's edge only once that neighbour's flag has passed k.
A seeded scheduler interleaves the tiles as far as those waits allow. The
halo starts as NaN, so a read of a slot nobody wrote shows, and each slot
records who has yet to read it: rewriting a slot that a neighbour has not
read raises.

`grouped_substeps` runs members of unequal substep counts side by side,
each a coroutine looping over its own member's substeps and meeting only
its own barrier (its block's, in the kernel: one member a block); with one
barrier shared by several members instead, they deadlock.

Tolerances: float64 against `transport_substeps_torch` bit for bit (the
same operations in the same order); float32 against
`transport_substeps_pallas` in interpret mode at atol 1e-6, the tolerance
tests/test_torch_transport.py holds the plain version to. The kernel runs
only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops.transport_pallas import transport_substeps_pallas
from historymatching_tpu_torch.ops import _build, transport
from historymatching_tpu_torch.ops.transport import (
    GM_MAX_BANDS,
    MAX_THREADS,
    RT1_CELLS,
    TILE_SHAPES,
    TilePlan,
    gm1_plan,
    reg_budget,
    rt1_plan,
    tile_bytes,
    tile_dims,
    tile_threads,
    transport_substeps_cuda,
    transport_substeps_torch,
)
from tests.test_sim import default_model
from tests.test_torch_transport_gm import _inputs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _split(n, parts):
    """[(first, size)] of `parts` runs covering n, the first n mod parts
    one longer (csrc `transport_upwind_tile_kernel`, `gm_bands`)."""
    base, rem = divmod(n, parts)
    sizes = [base + 1] * rem + [base] * (parts - rem)
    return [(sum(sizes[:r]), sizes[r]) for r in range(parts)]


def _owners(Nx, Ny, plan):
    """Each cell's (tile, thread) on a plan, as the kernel assigns them."""
    rows, width = tile_dims(Nx, Ny, plan)
    cgs = -(-width // plan.cols)
    owner = {}
    for tr, (r0, h) in enumerate(_split(Nx, plan.gr)):
        for tc, (c0, w) in enumerate(_split(Ny, plan.gc)):
            for lt in range(plan.threads):
                i0, j0 = lt // cgs * plan.strip, lt % cgs * plan.cols
                for i in range(i0, min(i0 + plan.strip, h)):
                    for j in range(j0, min(j0 + plan.cols, w)):
                        assert (r0 + i, c0 + j) not in owner
                        owner[r0 + i, c0 + j] = (tr * plan.gc + tc, lt)
    return owner


# K-gm1's grids: its route's (rows wider than K-gm's, [23]'s 5x6000), the
# grid that left K-rt1 for it (8x3632), grids forced in chip_smoke and the
# card tests, odd splits, and past the tiles' capacity.
GM1_GRIDS = [(5, 6000), (8, 5000), (16, 2056), (8, 3632), (32, 1088), (171, 171), (64, 64),
             (120, 440), (128, 128), (600, 600), (33, 65), (7, 1), (1, 7), (3, 2001)]


@pytest.mark.parametrize("Nx,Ny", GM1_GRIDS)
def test_gm1_plan_covers_every_cell_once(Nx, Ny):
    """The tiles cover every cell once, each cell one thread's; one block
    holds the largest tile (threads, bytes, the registers its shape needs
    under "tiles"); at most GM_MAX_BANDS tiles; the plan's strip divides
    the largest tile's rows where any shape's plan does, and no such
    shape's plan has fewer cells a thread."""
    plan = gm1_plan(Nx, Ny)
    rows, width = tile_dims(Nx, Ny, plan)
    assert plan.faces == "shared" and plan.gr * plan.gc <= GM_MAX_BANDS
    assert plan.threads == tile_threads(rows, width, plan.strip, plan.cols) <= MAX_THREADS
    assert tile_bytes(rows, width, plan.strip, plan.cols, "shared") <= _build.SMEM_LIMIT
    assert TILE_SHAPES["tiles"][plan.strip, plan.cols] <= reg_budget(plan.threads)
    assert len(_owners(Nx, Ny, plan)) == Nx * Ny
    short = lambda p: tile_dims(Nx, Ny, p)[0] % p.strip > 0  # noqa: E731
    others = [p[1] for p in (transport._gm1_shape_plan(Nx, Ny, *sc)
                             for sc in TILE_SHAPES["tiles"]) if p]
    assert plan in others
    assert all((short(plan), plan.strip * plan.cols) <= (short(p), p.strip * p.cols)
               for p in others)


def test_gm1_past_its_tiles_takes_the_device_memory_body():
    """Past ~1.08 M cells no plan of at most GM_MAX_BANDS tiles fits:
    K-gm1 runs its device-memory body (DEVICE: the card's blocks spread
    over the batch), forced or on its route, and reaches the wrappers'
    refusal of CPU tensors (nothing falls back)."""
    for Nx, Ny in [(1090, 1090), (2000, 2000), (1, 400_000)]:
        assert gm1_plan(Nx, Ny) is None and transport.route(Nx, Ny) == "gm1"
        assert transport._plan("gm1", Nx, Ny, 2, None) == transport.DEVICE
    assert transport._plan("gm1", 64, 64, 2, transport.GM1Device(1)) == (1,)
    z = torch.zeros(1, 6, 5)
    args = (z, torch.zeros(1, 7, 5), torch.zeros(1, 6, 6), z, torch.ones(1),
            torch.ones(1, dtype=torch.int32), (1.0, 1.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="need float32 CUDA"):
        transport_substeps_cuda(*args, force="gm1", plan=transport.DEVICE)
    with pytest.raises(ValueError, match="no plan of rt1"):
        transport_substeps_cuda(*args, force="rt1", plan=transport.DEVICE)


# bench_routes.py --kernel k1 on the H100: K-gm1's faster plan at each
# (grid, batch) measured, its tiles or one block a member.
GM1_FASTER = {
    **{((5, 6000), n): "tiles" for n in (4, 64, 128, 256, 1000)},
    **{((8, 5000), n): "tiles" for n in (4, 16, 32, 48)},
    **{((8, 5000), n): "block" for n in (64, 128, 256, 1000)},
    **{(g, n): "tiles" for g in ((16, 2056), (8, 3632)) for n in (4, 16, 32)},
    **{(g, n): "block" for g in ((16, 2056), (8, 3632)) for n in (48, 64, 128, 256, 1000)}}


@pytest.mark.parametrize("case", list(GM1_FASTER))
def test_gm1_route_plan_takes_the_faster(case):
    """K-gm1's plan by the batch is the one that ran faster: one block a
    member where its tiles hold fewer than GM1_TILE_CELLS cells in flight
    and the batch reaches those cells over GM1_WAVE_CELLS, else the tiles;
    the launch's plan where none is given."""
    (Nx, Ny), batch = case
    plan = transport.gm1_route_plan(Nx, Ny, batch)
    assert transport.route(Nx, Ny, batch) == "gm1"
    assert plan == (transport.GM1Device(1) if GM1_FASTER[case] == "block" else gm1_plan(Nx, Ny))
    tiles = gm1_plan(Nx, Ny)
    flight = GM_MAX_BANDS // (tiles.gr * tiles.gc) * Nx * Ny
    assert (GM1_FASTER[case] == "block") == (
        flight < transport.GM1_TILE_CELLS and batch * transport.GM1_WAVE_CELLS >= flight)
    assert transport._plan("gm1", Nx, Ny, batch, None) == plan


# K-rt1's grids: rows wider than a block of the strip body ([23]'s
# 4x1100, 2x2000), forced ones of chip_smoke and the card tests, and the
# small grids of [18] and [21].
RT1_GRIDS = [(4, 1100), (2, 2000), (80, 80), (64, 64), (88, 88), (60, 60), (15, 15), (12, 9),
             (10, 10), (12, 12), (24, 16), (30, 30), (1, 1), (3, 5)]


@pytest.mark.parametrize("Nx,Ny", RT1_GRIDS)
def test_rt1_plan_is_one_block_a_member(Nx, Ny):
    """One tile a member covering every cell once; a small grid's member on
    its own warps (faces in registers, strips of RT1_STRIP rows), one a
    block; a larger one in one block, faces in shared memory, on the
    fewest cells a thread; within the block's threads, bytes and
    registers."""
    plan = rt1_plan(Nx, Ny)
    assert (plan.gr, plan.gc) == (1, 1) and len(_owners(Nx, Ny, plan)) == Nx * Ny
    assert plan.threads <= MAX_THREADS and TILE_SHAPES[plan.faces][plan.strip, plan.cols] <= (
        reg_budget(plan.threads))
    assert tile_bytes(Nx, Ny, plan.strip, plan.cols, plan.faces,
                      plan.threads) <= _build.SMEM_LIMIT
    if Nx * Ny <= RT1_CELLS:
        assert plan.faces == "registers" and plan.strip == min(transport.RT1_STRIP, Nx)
        assert plan.cols == 1 and plan.threads % 32 == 0
    else:
        assert plan.faces == "shared"
        assert plan.threads == tile_threads(Nx, Ny, plan.strip, plan.cols)
        assert all(not transport.tile_fits(Nx, Ny, a, c, "shared")
                   for a, c in TILE_SHAPES["shared"] if a * c < plan.strip * plan.cols)


# Grids that left K-rt1 (bench_routes.py --kernel k1: no one-block plan
# builds without spilling, ~8,000 cells at most; its first form held them
# with the faces read from L1 every substep): to K-gm where `gm_plan` gives
# a plan, else to K-gm1's tiles.
LEFT_RT1 = {(8, 3632): "gm1", (150, 150): "gm", (99, 199): "gm", (96, 96): "cl"}


@pytest.mark.parametrize("grid", list(LEFT_RT1))
def test_grids_past_one_block_leave_rt1(grid):
    """No tile plan of one block, so the route takes K-gm or K-gm1, and
    K-rt1 forced there is refused before any launch; the route's body
    reaches the wrappers' refusal of CPU tensors."""
    Nx, Ny = grid
    assert rt1_plan(Nx, Ny) is None and transport.route(Nx, Ny) == LEFT_RT1[grid]
    z = torch.zeros(1, Nx, Ny)
    args = (z, torch.zeros(1, Nx + 1, Ny), torch.zeros(1, Nx, Ny + 1), z, torch.ones(1),
            torch.ones(1, dtype=torch.int32), (1.0, 1.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="no tile plan of K-rt1"):
        transport_substeps_cuda(*args, force="rt1")
    with pytest.raises(ValueError, match="need float32 CUDA"):
        transport_substeps_cuda(*args)


def test_tile_constants_match_the_cuda_source():
    """The face placements, the thread bound of a library (a block's
    threads in groups of four warps, which keeps `reg_budget`) and its
    flags."""
    with open(os.path.join(_build.CSRC, "transport_upwind.cu")) as f:
        text = f.read()
    assert re.search(r"constexpr int kFacesRegs = 0, kFacesSlots = 1;", text)
    assert transport.TILE_FACES == ("registers", "shared")
    key, stem, flags, _, sigs = _build._tile_spec(4, 2, "shared", False, 550)
    assert key == "transport_upwind_tile_s4w2st640" and sigs == "transport_upwind_tile"
    assert flags == ["-DHM_KT_S=4", "-DHM_KT_W=2", "-DHM_KT_F=1", "-DHM_KT_G=0", "-DHM_KT_T=640"]
    small = TilePlan(1, 1, 1, 1, "registers", 160)
    assert _build._tile_plan_spec(small, False)[0] == "transport_upwind_tile_s1w1rt256"
    assert all(reg_budget(t) == reg_budget(-(-t // 128) * 128) for t in range(1, 1025))
    plan = gm1_plan(5, 6000)
    assert [sp[0] for sp in _build._kt_specs(5, 6000)] == [
        f"transport_upwind_tile_s{plan.strip}w{plan.cols}sgt{-(-plan.threads // 128) * 128}"]
    assert [sp[0] for sp in _build._kt_specs(12, 12)][0] == "transport_upwind_tile_s1w1rt256"


def test_forced_plans_are_checked():
    """A plan given to K-rt1 or K-gm1 must take the grid: one tile a member
    for K-rt1, threads covering the tile, within one block; a GM1Device
    only for K-gm1; K-cl's plans only for K-cl."""
    good = rt1_plan(12, 12)
    assert transport._plan("rt1", 12, 12, 8, good) == good
    for bad in (good._replace(threads=48), good._replace(threads=100),
                good._replace(gr=2), good._replace(faces="global"), (2, 4),
                good._replace(threads=MAX_THREADS + 32), transport.DEVICE):
        with pytest.raises(ValueError, match="no plan of"):
            transport._plan("rt1", 12, 12, 8, bad)
    with pytest.raises(ValueError, match="no plan of"):
        transport._plan("gm1", 64, 64, 8, transport.GM1Device(-1))
    tiles = TilePlan(3, 4, 4, 1, "shared", 51)
    assert transport._plan("gm1", 33, 65, 5, tiles) == tiles
    with pytest.raises(ValueError, match="no plan of"):
        transport._plan("gm1", 33, 65, 5, tiles._replace(threads=50))


def tiled_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid, gr, gc, strip=4, cols=1, seed=0):
    """K-gm1's tile schedule in plain torch: each member in gr x gc tiles
    (rows and columns split as `_split`), strips of `strip` rows and groups
    of `cols` columns a thread inside a tile (the edges written by each
    thread's cells), the tiles run as coroutines interleaved at random
    (`seed`) as far as their waits allow. Same arguments as
    `transport_substeps_torch`, `q` with one member or B."""
    vw, vo, swc, sor = fluid
    B, Nx, Ny = s.shape
    rsplit, csplit = _split(Nx, gr), _split(Ny, gc)
    H, WT = rsplit[0][1], csplit[0][1]
    HN = 2 * (WT + H)  # a slot: first row, last row, first column, last column
    P = gr * gc
    rng = np.random.default_rng(seed)
    out = s.clone()
    for b in range(B):
        halo = torch.full((P * 2 * HN,), float("nan"), dtype=s.dtype)
        unread = {}  # (tile, slot, edge) -> the tile still to read it
        flags = [0] * P
        qb = q[b if q.shape[0] > 1 else 0]

        def tile(t):
            tr, tc = divmod(t, gc)
            (r0, h), (c0, w) = rsplit[tr], csplit[tc]
            sb = s[b, r0:r0 + h, c0:c0 + w]
            fx, fy = Fx[b, r0:r0 + h + 1, c0:c0 + w], Fy[b, r0:r0 + h, c0:c0 + w + 1]
            xp, xn, yp, yn = fx.clamp_min(0.0), fx.clamp_max(0.0), fy.clamp_min(0.0), fy.clamp_max(0.0)
            fi, fp = qb[r0:r0 + h, c0:c0 + w].clamp_min(0.0), qb[r0:r0 + h, c0:c0 + w].clamp_max(0.0)
            # edge: (offset in a slot, reader tile, neighbour's facing edge offset)
            edges = {"up": (0, t - gc, WT) if tr > 0 else None,
                     "dn": (WT, t + gc, 0) if tr < gr - 1 else None,
                     "l": (2 * WT, t - 1, 2 * WT + H) if tc > 0 else None,
                     "r": (2 * WT + H, t + 1, 2 * WT) if tc < gc - 1 else None}
            for k in range(int(n_sub[b])):
                S = (sb - swc) / (1.0 - swc - sor)
                Mw = S * S / vw
                Mo = (1.0 - S) * (1.0 - S) / vo
                fw = Mw / (Mw + Mo)
                slot = t * 2 * HN + (k & 1) * HN
                cells = {"up": fw[0], "dn": fw[h - 1], "l": fw[:, 0], "r": fw[:, w - 1]}
                for side, e in edges.items():
                    if e is None:
                        continue
                    assert (t, k & 1, side) not in unread, (t, k, side, "rewritten unread")
                    vals = cells[side]
                    step = cols if side in ("up", "dn") else strip
                    for a in range(0, len(vals), step):  # each thread its cells of the edge
                        halo[slot + e[0] + a:slot + e[0] + min(a + step, len(vals))] = (
                            vals[a:a + step])
                    unread[t, k & 1, side] = e[1]
                flags[t] = k + 1
                yield
                for side, e in edges.items():
                    while e is not None and flags[e[1]] <= k:
                        yield
                got = {}
                for side, e in edges.items():
                    n = w if side in ("up", "dn") else h
                    if e is None:
                        got[side] = torch.zeros(n, dtype=s.dtype)
                        continue
                    nslot = e[1] * 2 * HN + (k & 1) * HN + e[2]
                    got[side] = halo[nslot:nslot + n].clone()
                    facing = {"up": "dn", "dn": "up", "l": "r", "r": "l"}[side]
                    assert unread.pop((e[1], k & 1, facing)) == t
                fwx = torch.cat([got["up"][None], fw, got["dn"][None]])
                Fw_x = xp * fwx[:-1] + xn * fwx[1:]
                fwy = torch.cat([got["l"][:, None], fw, got["r"][:, None]], dim=1)
                Fw_y = yp * fwy[:, :-1] + yn * fwy[:, 1:]
                div = (Fw_x[1:] - Fw_x[:-1]) + (Fw_y[:, 1:] - Fw_y[:, :-1])
                sb = torch.clamp(sb + dts_pv[b] * (fi + fp * fw - div), swc, 1.0 - sor)
            out[b, r0:r0 + h, c0:c0 + w] = sb

        running = [tile(t) for t in range(P)]
        while running:
            co = running[rng.integers(len(running))]
            try:
                next(co)
            except StopIteration:
                running.remove(co)
    return out


# (grid, tiles along i and j, strip rows, columns a thread): tiles on both
# axes with unequal rows and columns, one tile row (5x6000's layout),
# one tile column, single-row and single-column tiles, taller strips and
# several columns a thread.
TILINGS = [((12, 10), 3, 2, 4, 1), ((13, 11), 2, 3, 5, 2), ((5, 23), 1, 4, 4, 1),
           ((9, 7), 4, 1, 4, 1), ((6, 6), 6, 3, 4, 1), ((11, 9), 2, 2, 8, 1)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("grid,gr,gc,strip,cols", TILINGS)
def test_tiled_schedule_matches_plain_f64(grid, gr, gc, strip, cols, seed):
    """Float64: the tiles, each seeing only its cells and its neighbours'
    published edges, give the plain version's saturations bit for bit,
    however the scheduler interleaves them, and no slot is rewritten
    before its reader read it."""
    Nx, Ny = grid
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, _inputs(13, 4, Nx, Ny, np.float64))
    fluid = (0.3, 3.0, 0.1, 0.2)
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    got = tiled_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, gr, gc, strip, cols, seed)
    assert torch.equal(got, ref)
    assert not torch.equal(ref, s)


@pytest.mark.parametrize("grid,gr,gc,strip,cols", TILINGS[:3])
def test_tiled_schedule_matches_pallas_interpret_f32(grid, gr, gc, strip, cols):
    """Float32: the tile schedule against the JAX package's Pallas kernel
    in interpret mode (atol 1e-6), member by member, on the fluid of the
    JAX package's default model; and bit for bit against the plain
    version."""
    Nx, Ny = grid
    fl = default_model(Nx=Nx, Ny=Ny).fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    arrays = _inputs(14, 3, Nx, Ny, np.float32)
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, arrays)
    got = tiled_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, gr, gc, strip, cols, 5)
    assert got.dtype == torch.float32
    assert torch.equal(got, transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid))
    for b in range(3):
        ref = transport_substeps_pallas(*(jnp.asarray(x[b]) for x in arrays[:3]),
                                        jnp.asarray(arrays[3]), arrays[4][b], arrays[5][b],
                                        fluid, interpret=True)
        assert np.allclose(got[b].numpy(), np.asarray(ref), atol=1e-6), b


class Deadlock(RuntimeError):
    pass


def grouped_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid, members, strip=2, seed=0,
                     barrier="named"):
    """K-rt1's small-grid schedule in plain torch: the members in sets of
    `members` resident together, member g of set x a coroutine that
    computes its member's fw (strips of `strip` rows, one column a thread;
    its faces split once), meets a barrier, updates its cells, for its own
    member's substeps. "named": each member's own barrier (its block's
    `__syncthreads`: one member a block); "block": one barrier shared by
    the set's members, which a member that has finished never reaches, so
    the others raise Deadlock. Same arguments as
    `transport_substeps_torch`."""
    vw, vo, swc, sor = fluid
    B, Nx, Ny = s.shape
    rng = np.random.default_rng(seed)
    out = s.clone()
    XP, XN, YP, YN = Fx.clamp_min(0.0), Fx.clamp_max(0.0), Fy.clamp_min(0.0), Fy.clamp_max(0.0)
    for x in range(-(-B // members)):
        block = range(x * members, min(B, (x + 1) * members))
        arrived = {}  # barrier id -> groups waiting at it

        def group(b):
            qb = q[b if q.shape[0] > 1 else 0]
            fi, fp = qb.clamp_min(0.0), qb.clamp_max(0.0)
            sb = s[b]
            bid = b - x * members + 1 if barrier == "named" else 0
            expect = 1 if barrier == "named" else len(block)
            for k in range(int(n_sub[b])):
                S = (sb - swc) / (1.0 - swc - sor)
                Mw = S * S / vw
                Mo = (1.0 - S) * (1.0 - S) / vo
                fw = torch.empty_like(sb)
                for i0 in range(0, Nx, strip):  # each thread its strip's fw
                    fw[i0:i0 + strip] = Mw[i0:i0 + strip] / (Mw[i0:i0 + strip] + Mo[i0:i0 + strip])
                arrived.setdefault(bid, set()).add(b)
                while len(arrived[bid]) < expect:
                    yield "wait"
                yield "passed"
                arrived[bid].discard(b)
                zr, zc = torch.zeros(1, Ny, dtype=s.dtype), torch.zeros(Nx, 1, dtype=s.dtype)
                fwx = torch.cat([zr, fw, zr])
                Fw_x = XP[b] * fwx[:-1] + XN[b] * fwx[1:]
                fwy = torch.cat([zc, fw, zc], dim=1)
                Fw_y = YP[b] * fwy[:, :-1] + YN[b] * fwy[:, 1:]
                div = (Fw_x[1:] - Fw_x[:-1]) + (Fw_y[:, 1:] - Fw_y[:, :-1])
                sb = torch.clamp(sb + dts_pv[b] * (fi + fp * fw - div), swc, 1.0 - sor)
            out[b] = sb

        running = {b: group(b) for b in block}
        waiting = set()
        while running:
            if waiting == set(running):
                raise Deadlock(f"block {x}: groups {sorted(waiting)} wait at a barrier")
            b = list(running)[rng.integers(len(running))]
            try:
                state = next(running[b])
            except StopIteration:
                del running[b]
                waiting.discard(b)
                continue
            (waiting.add if state == "wait" else waiting.discard)(b)
    return out


def _ragged(arrays):
    """Unequal substep counts, one member with none."""
    s, Fx, Fy, q, dts_pv, _ = arrays
    B = s.shape[0]
    n_sub = np.array([5, 0, 9, 2, 7, 1, 4][:B], np.int32)
    return s, Fx, Fy, q, dts_pv, n_sub


@pytest.mark.parametrize("members,strip,seed", [(3, 2, 0), (4, 1, 1), (7, 4, 2), (2, 2, 3)])
def test_grouped_schedule_matches_plain_f64(members, strip, seed):
    """Float64: members resident together, each on its own barrier, each
    looping over its own substep count: the plain version's saturations
    bit for bit, the members of the batch's largest count not holding the
    others back; one barrier shared by several members deadlocks."""
    Nx, Ny = 6, 5
    arrays = _ragged(_inputs(15, 7, Nx, Ny, np.float64))
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, arrays)
    fluid = (0.3, 3.0, 0.1, 0.2)
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    got = grouped_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, members, strip, seed)
    assert torch.equal(got, ref) and not torch.equal(ref, s)
    with pytest.raises(Deadlock):
        grouped_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, members, strip, seed,
                         barrier="block")


def test_grouped_schedule_matches_pallas_interpret_f32():
    """Float32: the grouped schedule bit for bit against the plain version
    and against the Pallas kernel in interpret mode (atol 1e-6)."""
    Nx, Ny = 6, 5
    fl = default_model(Nx=Nx, Ny=Ny).fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    arrays = _ragged(_inputs(16, 4, Nx, Ny, np.float32))
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, arrays)
    got = grouped_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, 3)
    assert torch.equal(got, transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid))
    for b in range(4):
        ref = transport_substeps_pallas(*(jnp.asarray(x[b]) for x in arrays[:3]),
                                        jnp.asarray(arrays[3]), arrays[4][b], arrays[5][b],
                                        fluid, interpret=True)
        assert np.allclose(got[b].numpy(), np.asarray(ref), atol=1e-6), b
