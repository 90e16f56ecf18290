"""What the CPU can check of K-gm, kernel K on a member spread over a band
of co-resident blocks (csrc/transport_upwind.cu `transport_upwind_gm_kernel`):
its band plans (`ops/transport.gm_bands` for one strip shape, `gm_plan`
over strips of 4 to 16 rows and one or more columns a thread), the routes
around it, the capacity past which K-gm1 (one block a member) takes a
grid, and the halo protocol between bands, in a plain emulation held to
the plain version and to the JAX package's Pallas kernel.

The emulation (`banded_substeps`) runs each band of a member as its own
coroutine: a band sees only its own rows, computes their fw, writes its
first and last fw rows into the member's halo buffer at the kernel's
offsets (slot k & 1), column group by column group (a thread's columns),
publishes k + 1 on its flag, and reads a
neighbour's edge row only once the neighbour's flag has passed k. A seeded
scheduler interleaves the bands as far as those waits allow, so a band may
run a substep ahead of its neighbours and overwrite a slot they have not
yet read if the protocol let it. The halo starts as NaN, so a read of a
slot nobody wrote shows.

Tolerances: float64 against `transport_substeps_torch` bit for bit (the
same operations in the same order); float32 against
`transport_substeps_pallas` in interpret mode at atol 1e-6, the tolerance
tests/test_torch_transport.py holds the plain version to. The kernel runs
only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from historymatching_tpu.ops.transport_pallas import transport_substeps_pallas
from historymatching_tpu_torch.ops import transport
from historymatching_tpu_torch.ops._build import SMEM_LIMIT
from historymatching_tpu_torch.ops.transport import (
    BAND_CELLS,
    GM_MAX_BANDS,
    GM_STRIP,
    GM_THREADS,
    MAX_STRIP,
    MIN_STRIP,
    gm_bands,
    gm_bytes,
    gm_plan,
    gm_slots,
    gm_threads,
    transport_substeps_cuda,
    transport_substeps_torch,
)
from tests.test_sim import default_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# Grids past one block (K-gm's own and K-cl's, where K-gm is forced), small
# grids (one band), and grids at the edge of the plan.
PLAN_GRIDS = [(120, 440), (171, 171), (130, 440), (192, 192), (256, 256), (128, 128),
              (60, 220), (64, 64), (5000, 8), (97, 300), (1056, 440), (528, 1024), (7, 1)]


@pytest.mark.parametrize("Nx,Ny", PLAN_GRIDS)
def test_gm_bands_cover_every_row_once(Nx, Ny):
    """The bands cover every row once, in order; none exceeds a block (its
    strips of GM_STRIP rows, one column a thread, at most GM_THREADS threads;
    so at most BAND_CELLS cells); the first Nx mod G take one row more; G is
    the fewest that fit, and at most GM_MAX_BANDS."""
    bands = gm_bands(Nx, Ny)
    G = len(bands)
    assert [i for f, h in bands for i in range(f, f + h)] == list(range(Nx))
    rows = [h for _, h in bands]
    assert rows == sorted(rows, reverse=True) and rows[0] - rows[-1] <= 1
    assert rows.count(rows[-1] + 1) == Nx % G
    assert -(-rows[0] // GM_STRIP) * Ny <= GM_THREADS and rows[0] * Ny <= BAND_CELLS
    assert G <= GM_MAX_BANDS and G <= Nx
    assert G == 1 or -(-(-(-Nx // (G - 1))) // GM_STRIP) * Ny > GM_THREADS


def test_plan_constants_match_the_cuda_source():
    """`gm_bands` and `gm_plan` plan with the kernel's first strip, its
    largest strip, its thread limit and its slots a thread (`gm_slots`,
    csrc `GmSlots::COUNT`; a thread's columns share their inner faces along
    j); the strip body's slots (`rt_bytes`) are its `KGeo::SLOTS`."""
    import os
    import re

    from historymatching_tpu_torch.ops._build import CSRC
    from historymatching_tpu_torch.ops.transport import rt_bytes

    with open(os.path.join(CSRC, "transport_upwind.cu")) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kStrip = (\d+);", text).group(1)) == GM_STRIP
    assert int(re.search(r"constexpr int kMaxStrip = (\d+);", text).group(1)) == MAX_STRIP
    assert int(re.search(r"constexpr int kGmThreads = (\d+);", text).group(1)) == GM_THREADS
    count = re.search(r"static constexpr int COUNT = ([^;]+);", text).group(1)
    slots = re.search(r"static constexpr int SLOTS = SHARED \? ([^:]+) :", text).group(1)
    for S in range(MIN_STRIP, MAX_STRIP + 1):
        for W in (1, 2, 3, 4):
            assert eval(count, {"S": S, "W": W}) == gm_slots(S, W)
        assert rt_bytes(S, 7, S, "shared") == 4 * (2 * S * 7 + eval(slots, {"S": S}) * 7)
    assert gm_slots(GM_STRIP, 1) == 17  # the first plan's: 4 S + 1


# (grid, bands, rows of each). 120x440 and 171x171, the grids the route
# sends to K-gm, split evenly (15 bands of 8 rows, 880 threads; 9 of 19,
# 855 threads); 130x440 and 192x192 unequally.
BAND_PLANS = {
    (120, 440): [8] * 15,
    (171, 171): [19] * 9,
    (130, 440): [8] * 11 + [7] * 6,
    (192, 192): [20] * 2 + [19] * 8,
    (256, 256): [16] * 16,
}


@pytest.mark.parametrize("grid", list(BAND_PLANS))
def test_gm_band_plans(grid):
    assert [h for _, h in gm_bands(*grid)] == BAND_PLANS[grid]


# K's route at chip_smoke.py's grids ([18]'s K_RT_GRIDS, [23]'s LARGE_GRIDS
# and its device-memory path 120x440) and at 171x171, as they were before K-gm's redesign.
ROUTES = {
    (15, 15): "rt1", (12, 9): "rt1", (10, 10): "rt1", (12, 12): "rt1", (24, 16): "rt1",
    (80, 80): "cl", (60, 60): "rt", (88, 88): "cl", (96, 96): "cl", (100, 100): "cl",
    (128, 128): "cl", (60, 220): "cl", (192, 192): "cl", (256, 256): "cl",
    (120, 440): "gm", (171, 171): "gm",
}


@pytest.mark.parametrize("grid", list(ROUTES))
def test_transport_route_unchanged(grid):
    """K-gm's redesigns move no grid between these routes: K-cl keeps its
    grids, K-gm 120x440 and 171x171 (on their first plan). The runtime-grid
    body, named "rt1" since the strip body built for a grid took "rt"
    (K-rt; tests/test_torch_transport_strip.py), keeps the grids of up to
    1,024 cells (RT1_CELLS), where it ran faster; 60x60 moved to K-rt."""
    assert transport.route(*grid) == ROUTES[grid]


# Past K-gm's capacity (a row wider than 2,048 cells; more than
# GM_MAX_BANDS bands of a block's load, ~0.9-1.08 M cells a member), and
# at its edge. Before `gm_plan` (strips of 4 rows and one column only) the
# first five took K-gm1: 1,088 columns exceed a block's threads, and
# 600x600, 1000x1000 and 1057x440 needed 150, 250 and 133 bands.
CAPACITY = {
    (32, 1088): "gm",    # 8 bands of 4 rows, 2 columns a thread
    (600, 600): "gm",    # 120 bands of 5 rows, strips of 5
    (1000, 1000): "gm",  # 125 bands of 8 rows, strips of 4 rows x 2 columns
    (1057, 440): "gm",   # 106 bands of 10 rows, strips of 5
    (1024, 1024): "gm",  # the largest square, 128 bands
    (8, 5000): "gm1",    # a band of 4 rows of 5,000 cells exceeds a block
    (16, 2056): "gm1",   # past the widest row
    (1090, 1090): "gm1",
    (2000, 2000): "gm1",
    (1056, 440): "gm",   # 132 bands of 8 rows, the first plan
    (528, 1024): "gm",   # 132 bands of 4 rows of 1,024 columns, the first plan
}


@pytest.mark.parametrize("grid", list(CAPACITY))
def test_capacity_route(grid):
    """Past its capacity `gm_plan` gives no plan and the route takes K-gm1
    before any launch; K-gm forced there is refused, K-gm1 forced anywhere
    reaches the wrappers' refusal of CPU tensors (nothing falls back)."""
    Nx, Ny = grid
    assert transport.route(Nx, Ny) == CAPACITY[grid]
    assert (gm_plan(Nx, Ny) is None) == (CAPACITY[grid] == "gm1")
    z = torch.zeros(1, Nx, Ny)
    args = (z, torch.zeros(1, Nx + 1, Ny), torch.zeros(1, Nx, Ny + 1), z, torch.ones(1),
            torch.ones(1, dtype=torch.int32), (1.0, 1.0, 0.0, 0.0))
    if CAPACITY[grid] == "gm1":
        with pytest.raises(ValueError, match="no band plan"):
            transport_substeps_cuda(*args, force="gm")
    for force in (None, "gm1"):
        with pytest.raises(ValueError, match="need float32 CUDA"):
            transport_substeps_cuda(*args, force=force)
    assert transport.NAMES["gm1"] == "transport_upwind_gm1"


# `gm_plan`'s grids: PLAN_GRIDS, the capacity grids K-gm takes, and grids
# of odd sizes (a short last column group, rows wider than a block).
GM_PLAN_GRIDS = sorted(set(PLAN_GRIDS) | {g for g, rt in CAPACITY.items() if rt == "gm"}
                       | {(33, 1025), (1001, 999), (5, 2040), (77, 1500), (3, 2001),
                          (2112, 440), (1320, 700)})


@pytest.mark.parametrize("Nx,Ny", GM_PLAN_GRIDS)
def test_gm_plan_covers_every_cell_once(Nx, Ny):
    """The plan's bands cover every row once, in order, the first Nx mod G
    one row more; in each band the strips of `strip` rows (the last may
    hold fewer) and the column groups of `cols` (the last may hold fewer)
    cover every cell of the band once, each cell one thread's; one block
    holds the largest band (threads, bytes: `gm_threads`, `gm_bytes`);
    at most GM_MAX_BANDS bands; no plan has fewer cells a thread; and
    where the first plan (strips of GM_STRIP rows, one column) fits, it is
    the plan."""
    bands, strip, cols = gm_plan(Nx, Ny)
    G = len(bands)
    assert [i for f, h in bands for i in range(f, f + h)] == list(range(Nx))
    rows = [h for _, h in bands]
    assert rows == sorted(rows, reverse=True) and rows[0] - rows[-1] <= 1
    assert rows.count(rows[-1] + 1) == Nx % G and G <= GM_MAX_BANDS
    assert MIN_STRIP <= strip <= MAX_STRIP and strip * cols <= MAX_STRIP
    threads = gm_threads(Ny, rows[0], strip, cols)
    assert threads <= GM_THREADS and gm_bytes(Ny, rows[0], strip, cols) <= SMEM_LIMIT
    for h in set(rows):
        owner = {}
        for t in range(threads):
            i0, j0 = t // -(-Ny // cols) * strip, t % -(-Ny // cols) * cols
            for i in range(i0, min(i0 + strip, h)):
                for j in range(j0, min(j0 + cols, Ny)):
                    assert (i, j) not in owner
                    owner[i, j] = t
        assert len(owner) == h * Ny
    assert all(gm_bands(Nx, Ny, a, c) is None for a in range(MIN_STRIP, MAX_STRIP + 1)
               for c in range(1, MAX_STRIP // a + 1) if a * c < strip * cols)
    first = gm_bands(Nx, Ny)
    assert first is None or (bands, strip, cols) == (first, GM_STRIP, 1)


def banded_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid, sizes, seed=0, strip=GM_STRIP, cols=1):
    """K-gm's schedule in plain torch: each member's rows in bands of
    `sizes` rows, strips of `strip` rows inside a band (the last may hold
    fewer), each strip's columns in groups of `cols` (a thread's; the last
    may hold fewer), the bands run as coroutines interleaved at random
    (`seed`) as far as their waits allow. A group's neighbours along j
    inside it are its own fw, outside it the band's tile. Same arguments
    as `transport_substeps_torch`, `q` with one member or B."""
    vw, vo, swc, sor = fluid
    B, Nx, Ny = s.shape
    G = len(sizes)
    firsts = [sum(sizes[:r]) for r in range(G)]
    groups = [slice(j0, min(j0 + cols, Ny)) for j0 in range(0, Ny, cols)]
    rng = np.random.default_rng(seed)
    out = s.clone()
    for b in range(B):
        halo = torch.full((G * 4 * Ny,), float("nan"), dtype=s.dtype)  # [band][slot][first, last]
        flags = [0] * G
        qb = q[b if q.shape[0] > 1 else 0]

        def band(r):
            """Band r of member b: yields at its publication and while it
            waits; its rows' new saturations go to `out` at the end."""
            first, h = firsts[r], sizes[r]
            sb = s[b, first:first + h]
            fx = Fx[b, first:first + h + 1]
            xp, xn = fx.clamp_min(0.0), fx.clamp_max(0.0)
            yp, yn = Fy[b, first:first + h].clamp_min(0.0), Fy[b, first:first + h].clamp_max(0.0)
            fi, fp = qb[first:first + h].clamp_min(0.0), qb[first:first + h].clamp_max(0.0)
            for k in range(int(n_sub[b])):
                S = (sb - swc) / (1.0 - swc - sor)
                Mw = S * S / vw
                Mo = (1.0 - S) * (1.0 - S) / vo
                fw = Mw / (Mw + Mo)
                slot = ((r * 4) + (k & 1) * 2) * Ny
                for js in groups:  # each thread its columns of the edge rows
                    if r > 0:
                        halo[slot + js.start:slot + js.stop] = fw[0, js]
                    if r < G - 1:
                        halo[slot + Ny + js.start:slot + Ny + js.stop] = fw[h - 1, js]
                flags[r] = k + 1
                yield
                new = torch.empty_like(sb)
                for i0 in range(0, h, strip):
                    hs = min(strip, h - i0)
                    g0 = first + i0
                    top, bot = i0 == 0 and r > 0, i0 + hs == h and r < G - 1
                    while (top and flags[r - 1] <= k) or (bot and flags[r + 1] <= k):
                        yield
                    st = slice(i0, i0 + hs)
                    for js in groups:
                        zero = torch.zeros(js.stop - js.start, dtype=s.dtype)
                        f_up = (zero if g0 == 0 else halo[slot - 3 * Ny + js.start:
                                                          slot - 3 * Ny + js.stop]
                                if top else fw[i0 - 1, js])
                        f_dn = (zero if g0 + hs == Nx else halo[slot + 4 * Ny + js.start:
                                                                slot + 4 * Ny + js.stop]
                                if bot else fw[i0 + hs, js])
                        fws = fw[st, js]
                        fwx = torch.cat([f_up[None], fws, f_dn[None]])
                        Fw_x = xp[i0:i0 + hs + 1, js] * fwx[:-1] + xn[i0:i0 + hs + 1, js] * fwx[1:]
                        edge = torch.zeros(hs, 1, dtype=s.dtype)
                        left = fw[st, js.start - 1:js.start] if js.start > 0 else edge
                        right = fw[st, js.stop:js.stop + 1] if js.stop < Ny else edge
                        fwy = torch.cat([left, fws, right], dim=1)
                        faces = slice(js.start, js.stop + 1)
                        Fw_y = yp[st, faces] * fwy[:, :-1] + yn[st, faces] * fwy[:, 1:]
                        div = (Fw_x[1:] - Fw_x[:-1]) + (Fw_y[:, 1:] - Fw_y[:, :-1])
                        new[st, js] = torch.clamp(
                            sb[st, js] + dts_pv[b] * (fi[st, js] + fp[st, js] * fws - div),
                            swc, 1.0 - sor)
                sb = new
            out[b, first:first + h] = sb

        running = [band(r) for r in range(G)]
        while running:
            co = running[rng.integers(len(running))]
            try:
                next(co)
            except StopIteration:
                running.remove(co)
    return out


def _inputs(seed, B, Nx, Ny, dtype):
    rng = np.random.default_rng(seed)
    s = np.clip(0.4 + 0.2 * rng.normal(size=(B, Nx, Ny)), 0, 1)
    Fx = 0.1 * rng.normal(size=(B, Nx + 1, Ny))
    Fx[:, 0] = Fx[:, -1] = 0
    Fy = 0.1 * rng.normal(size=(B, Nx, Ny + 1))
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = np.zeros((Nx, Ny))
    q[Nx // 2, Ny // 2] = 1.0
    q[1, 1] = -1.0
    dts_pv = np.linspace(0.005, 0.02, B)
    n_sub = np.array([7, 0, 12, 1], np.int32)[:B]  # ragged, one member none
    return tuple(x.astype(dtype) for x in (s, Fx, Fy, q, dts_pv)) + (n_sub,)


# (grid, band rows): 3 bands with one of a single row, and 4 bands as
# gm_bands splits (the first Nx mod 4 one row more); bands past a strip's
# rows (5, 6) hold a partial strip.
SPLITS = [((12, 10), [5, 1, 6]), ((12, 10), [3, 3, 3, 3]), ((12, 10), [6, 2, 2, 2]),
          ((9, 7), [1, 6, 2]), ((9, 7), [3, 2, 2, 2])]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("grid,sizes", SPLITS)
def test_banded_schedule_matches_plain_f64(grid, sizes, seed):
    """Float64: the bands, each seeing only its rows and its neighbours'
    published edge rows, give the plain version's saturations bit for bit,
    however the scheduler interleaves them."""
    Nx, Ny = grid
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, _inputs(3, 4, Nx, Ny, np.float64))
    fluid = (0.3, 3.0, 0.1, 0.2)
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    got = banded_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, sizes, seed)
    assert torch.equal(got, ref)
    assert not torch.equal(ref, s)


@pytest.mark.parametrize("grid,sizes", SPLITS)
def test_banded_schedule_matches_pallas_interpret_f32(grid, sizes):
    """Float32: the bands against the JAX package's Pallas kernel in
    interpret mode (atol 1e-6), member by member, on the fluid of the JAX
    package's default model; and bit for bit against the plain version."""
    Nx, Ny = grid
    fl = default_model(Nx=Nx, Ny=Ny).fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    arrays = _inputs(4, 4, Nx, Ny, np.float32)
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, arrays)
    got = banded_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, sizes, seed=2)
    assert got.dtype == torch.float32
    assert torch.equal(got, transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid))
    for b in range(4):
        ref = transport_substeps_pallas(*(jnp.asarray(x[b]) for x in arrays[:3]),
                                        jnp.asarray(arrays[3]), arrays[4][b], arrays[5][b],
                                        fluid, interpret=True)
        assert np.allclose(got[b].numpy(), np.asarray(ref), atol=1e-6), b


# (grid, band rows, strip rows, columns a thread): taller strips, several
# columns a thread, short last strips and column groups, one band.
WIDE_SPLITS = [((12, 10), [5, 1, 6], 5, 2), ((12, 10), [6, 6], 4, 3),
               ((9, 7), [3, 2, 2, 2], 6, 4), ((12, 10), [12], 8, 1), ((13, 11), [7, 6], 16, 2)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("grid,sizes,strip,cols", WIDE_SPLITS)
def test_wide_banded_schedule_matches_plain_f64(grid, sizes, strip, cols, seed):
    """Float64: bands of taller strips and several columns a thread give the
    plain version's saturations bit for bit, however the bands interleave."""
    Nx, Ny = grid
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, _inputs(5, 4, Nx, Ny, np.float64))
    fluid = (0.3, 3.0, 0.1, 0.2)
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    got = banded_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, sizes, seed, strip, cols)
    assert torch.equal(got, ref)
    assert not torch.equal(ref, s)


@pytest.mark.parametrize("grid,sizes,strip,cols", WIDE_SPLITS)
def test_wide_banded_schedule_matches_pallas_interpret_f32(grid, sizes, strip, cols):
    """Float32: the widened schedule against the Pallas kernel in interpret
    mode (atol 1e-6) and bit for bit against the plain version."""
    Nx, Ny = grid
    fl = default_model(Nx=Nx, Ny=Ny).fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    arrays = _inputs(6, 4, Nx, Ny, np.float32)
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, arrays)
    got = banded_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, sizes, 3, strip, cols)
    assert torch.equal(got, transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid))
    for b in range(4):
        ref = transport_substeps_pallas(*(jnp.asarray(x[b]) for x in arrays[:3]),
                                        jnp.asarray(arrays[3]), arrays[4][b], arrays[5][b],
                                        fluid, interpret=True)
        assert np.allclose(got[b].numpy(), np.asarray(ref), atol=1e-6), b
