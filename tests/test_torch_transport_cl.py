"""What the CPU can check of K-cl, kernel K on a thread-block cluster a
member (csrc/transport_upwind.cu `transport_upwind_cl_kernel` under
-DHM_KCL_*): its plans (`ops/transport.cl_plans`, `cl_plan`), their
threads, bytes and registers against the H100 and the CUDA source, and its
schedule in a plain emulation held to the plain version and to the JAX
package's Pallas kernel.

The emulation (`cl_substeps`) runs each rank of a member as its own
coroutine. A rank holds its band of Nx / c rows in strips of `strip` rows.
Each substep k it computes its band's fw, pushes its first row into rank
r - 1's halo slot (k & 1, from below) and its last into rank r + 1's (k &
1, from above), computes what needs only its own band, waits until both
neighbours' pushes of substep k have landed in its own slots, reads them,
and updates its band, strip by strip (a strip's rows above and below it
from the band's tile or, at the band's edge, from the slot). A seeded
scheduler interleaves the ranks as far as those waits allow, so a rank
may run ahead of a neighbour. The slots start as NaN, so a read of a slot
nobody wrote shows, and each push asserts that the slot's previous
content was read: the protocol of two slots and no explicit release (a
rank's push of substep k + 2 into a neighbour follows its wait for the
neighbour's push of k + 1, which the neighbour's edge strip makes after
it read substep k's slot).

Tolerances: float64 and float32 against `transport_substeps_torch` bit for
bit (the same operations in the same order); float32 against
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
from historymatching_tpu_torch.ops import transport
from historymatching_tpu_torch.ops._build import CSRC, SMEM_LIMIT
from historymatching_tpu_torch.ops.transport import (
    BAND_CELLS,
    CL_CLUSTERS,
    CL_MAX_RANKS,
    CL_REGS,
    MAX_STRIP,
    MAX_THREADS,
    ClPlan,
    cl_bytes,
    cl_plan,
    cl_plans,
    cl_ranks,
    cl_threads,
    transport_substeps_torch,
)
from tests.test_sim import default_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class SlotRace(AssertionError):
    """A push into a halo slot whose previous content was not read yet."""


def cl_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid, c, strip, seed=0, parities=2):
    """K-cl's schedule in plain torch: c ranks a member, strips of `strip`
    rows, `parities` halo slots a side (the kernel's two; one shows the
    race the second prevents). Same arguments as `transport_substeps_torch`,
    `q` with one member or B."""
    vw, vo, swc, sor = fluid
    B, Nx, Ny = s.shape
    H = Nx // c
    assert Nx % c == 0
    rng = np.random.default_rng(seed)
    out = s.clone()
    for b in range(B):
        nsub = int(n_sub[b])
        # [rank][parity][from above, from below]: a row, the substep that
        # wrote it and the substep whose reader has read it
        slots = torch.full((c, parities, 2, Ny), float("nan"), dtype=s.dtype)
        written = np.full((c, parities, 2), -1)
        read = np.full((c, parities, 2), -1)
        qb = q[b if q.shape[0] > 1 else 0]

        def push(dst, side, k, row):
            p = k % parities
            if written[dst, p, side] != read[dst, p, side]:
                raise SlotRace(f"substep {k} into rank {dst}'s slot {p}, side {side}, "
                               f"before substep {written[dst, p, side]}'s was read")
            slots[dst, p, side] = row
            written[dst, p, side] = k

        def rank(r):
            """Rank r of member b: yields after its pushes and while it
            waits; its band's new saturations go to `out` at the end."""
            lo, hi = r * H, (r + 1) * H
            sb = s[b, lo:hi].clone()
            xp, xn = Fx[b, lo:hi + 1].clamp_min(0.0), Fx[b, lo:hi + 1].clamp_max(0.0)
            yp, yn = Fy[b, lo:hi].clamp_min(0.0), Fy[b, lo:hi].clamp_max(0.0)
            fi, fp = qb[lo:hi].clamp_min(0.0), qb[lo:hi].clamp_max(0.0)
            zero = torch.zeros(Ny, dtype=s.dtype)
            for k in range(nsub):
                S = (sb - swc) / (1.0 - swc - sor)
                Mw = S * S / vw
                Mo = (1.0 - S) * (1.0 - S) / vo
                fw = Mw / (Mw + Mo)
                if r > 0:
                    push(r - 1, 1, k, fw[0])
                if r < c - 1:
                    push(r + 1, 0, k, fw[-1])
                yield
                p = k % parities
                sides = [side for side, there in ((0, r > 0), (1, r < c - 1)) if there]
                while any(written[r, p, side] != k for side in sides):
                    yield
                new = torch.empty_like(sb)
                for i0 in range(0, H, strip):
                    hs = min(strip, H - i0)
                    st = slice(i0, i0 + hs)
                    f_up = fw[i0 - 1] if i0 > 0 else slots[r, p, 0].clone() if r > 0 else zero
                    f_dn = (fw[i0 + hs] if i0 + hs < H else slots[r, p, 1].clone()
                            if r < c - 1 else zero)
                    fwx = torch.cat([f_up[None], fw[st], f_dn[None]])
                    Fw_x = xp[i0:i0 + hs + 1] * fwx[:-1] + xn[i0:i0 + hs + 1] * fwx[1:]
                    edge = torch.zeros(hs, 1, dtype=s.dtype)
                    fwy = torch.cat([edge, fw[st], edge], dim=1)
                    Fw_y = yp[st] * fwy[:, :-1] + yn[st] * fwy[:, 1:]
                    div = (Fw_x[1:] - Fw_x[:-1]) + (Fw_y[:, 1:] - Fw_y[:, :-1])
                    new[st] = torch.clamp(sb[st] + dts_pv[b] * (fi[st] + fp[st] * fw[st] - div),
                                          swc, 1.0 - sor)
                for side in sides:
                    read[r, p, side] = k
                sb = new
            out[b, lo:hi] = sb

        live = {r: rank(r) for r in range(c)}
        while live:
            r = list(live)[rng.integers(len(live))]
            try:
                next(live[r])
            except StopIteration:
                del live[r]
    return out


def _inputs(seed, B, Nx, Ny, dtype, n_sub):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.1, 0.8, (B, Nx, Ny))
    Fx = 0.1 * rng.standard_normal((B, Nx + 1, Ny))
    Fy = 0.1 * rng.standard_normal((B, Nx, Ny + 1))
    Fx[:, 0] = Fx[:, -1] = 0
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = np.zeros((Nx, Ny))
    q[Nx // 2, Ny // 2], q[0, 0] = 1.0, -1.0
    n_sub = np.asarray(n_sub, dtype=np.int32)
    dts_pv = 0.3 / np.maximum(n_sub, 1)
    return tuple(np.asarray(x, dtype=dtype) for x in (s, Fx, Fy, q, dts_pv)) + (n_sub,)


# (grid, ranks, strip rows, each member's substeps): members with no
# substep, a strip taller than the band, short last strips, one-row bands.
SCHEDULES = [((16, 16), 4, 4, [0, 3, 4, 9, 13, 1, 8, 6]),
             ((16, 12), 2, 3, [7, 0, 2, 12]),
             ((12, 10), 2, 4, [5, 1, 3, 10, 0, 7]),
             ((16, 16), 4, 5, [9, 2, 1, 0, 5]),
             ((8, 8), 4, 2, [3, 4, 5, 0]),
             ((10, 7), 2, 1, [4, 0, 1, 6]),
             ((12, 16), 4, 2, [2, 7, 0]),
             ((16, 9), 16, 4, [16, 3, 0, 1, 2])]


@pytest.mark.parametrize("grid,c,strip,n_sub", SCHEDULES)
def test_cl_schedule_matches_plain_f64(grid, c, strip, n_sub):
    """Float64: the ranks, each computing its band from its own fw and its
    neighbours' pushed edge rows, give the plain version's saturations bit
    for bit, under three interleavings."""
    s, Fx, Fy, q, dts_pv, n = map(torch.as_tensor, _inputs(3, len(n_sub), *grid, np.float64,
                                                           n_sub))
    fluid = (0.3, 3.0, 0.1, 0.2)
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n, fluid)
    for seed in range(3):
        assert torch.equal(cl_substeps(s, Fx, Fy, q[None], dts_pv, n, fluid, c, strip, seed),
                           ref)
    assert not torch.equal(ref, s)


@pytest.mark.parametrize("grid,c,strip,n_sub", SCHEDULES)
def test_cl_schedule_matches_pallas_interpret_f32(grid, c, strip, n_sub):
    """Float32: the schedule bit for bit against the plain version, and
    against the JAX package's Pallas kernel in interpret mode (atol 1e-6),
    member by member."""
    Nx, Ny = grid
    fl = default_model(Nx=Nx, Ny=Ny).fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    arrays = _inputs(5, len(n_sub), Nx, Ny, np.float32, n_sub)
    s, Fx, Fy, q, dts_pv, n = map(torch.as_tensor, arrays)
    got = cl_substeps(s, Fx, Fy, q[None], dts_pv, n, fluid, c, strip, seed=1)
    assert torch.equal(got, transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n, fluid))
    for b in range(len(n_sub)):
        ref = transport_substeps_pallas(*(jnp.asarray(x[b]) for x in arrays[:3]),
                                        jnp.asarray(arrays[3]), arrays[4][b], arrays[5][b],
                                        fluid, interpret=True)
        assert np.allclose(got[b].numpy(), np.asarray(ref), atol=1e-6), b


def test_cl_schedule_per_member_sources_f64():
    """A source field for each member, read at each member's stride."""
    s, Fx, Fy, q, dts_pv, n = map(torch.as_tensor, _inputs(8, 3, 12, 8, np.float64, [6, 2, 5]))
    q = torch.stack([q, -q, 2 * q])
    fluid = (0.3, 3.0, 0.1, 0.2)
    assert torch.equal(cl_substeps(s, Fx, Fy, q, dts_pv, n, fluid, 2, 3),
                       transport_substeps_torch(s, Fx, Fy, q, dts_pv, n, fluid))


def test_one_slot_a_side_races():
    """The check the protocol is held to bites: with one slot a side, some
    interleaving pushes substep k + 1's row into a slot its reader has not
    read at substep k; with the kernel's two, none does (the tests above)."""
    s, Fx, Fy, q, dts_pv, n = map(torch.as_tensor, _inputs(2, 1, 16, 8, np.float64, [24]))
    fluid = (0.3, 3.0, 0.1, 0.2)
    raced = 0
    for seed in range(12):
        try:
            cl_substeps(s, Fx, Fy, q[None], dts_pv, n, fluid, 4, 2, seed, parities=1)
        except SlotRace:
            raced += 1
    assert raced > 0


# K-cl's route grids (the grids the JAX package simulates past one block of
# 4,096 cells that a cluster takes) and other grids at the plan's edges.
ROUTE_GRIDS = [(80, 80), (88, 88), (96, 96), (100, 100), (128, 128), (60, 220), (192, 192),
               (256, 256)]
EDGE_GRIDS = [(65, 64), (4098, 1), (17, 1000), (300, 300), (66, 66)]


# K-cl's route plans: (ranks, strip rows, ranks an SM): two ranks in
# strips of 4 where two hold the grid, one strip a band where a band has at
# most 16 rows, else strips of 4 (100x100).
ROUTE_PLANS = {(80, 80): (2, 4, 1), (88, 88): (2, 4, 1), (96, 96): (8, 12, 4),
               (100, 100): (4, 4, 1), (128, 128): (8, 16, 2), (60, 220): (4, 15, 1),
               (192, 192): (16, 12, 2), (256, 256): (16, 16, 1)}


@pytest.mark.parametrize("Nx,Ny", ROUTE_GRIDS + EDGE_GRIDS)
def test_cl_plans_tile_the_grid_and_fit_the_card(Nx, Ny):
    """Every plan: equal bands of at most BAND_CELLS cells, a cluster of
    `CL_CLUSTERS`, cover each row once; the band's strips (the last may
    hold fewer rows) cover each band row once; the rank's threads (one column of a strip a thread) fit a
    block; its registers (`CL_REGS`) fit the H100's 65,536 for each of its
    ranks an SM, and its shared bytes those of one block and, for each of
    its ranks, the SM's. The route's plan: on two ranks where two hold the
    grid, with the shortest strips; else on one strip a band where a plan
    has one, with the most members an SM, then the fewest ranks; else on
    the fewest ranks and shortest strips."""
    plans = cl_plans(Nx, Ny)
    for plan in plans:
        c, strip = plan
        h = Nx // c
        bands = [range(r * h, (r + 1) * h) for r in range(c)]
        assert [i for band in bands for i in band] == list(range(Nx))
        assert h * Ny <= BAND_CELLS and c in CL_CLUSTERS and strip <= MAX_STRIP
        strips = [range(i, min(i + strip, h)) for i in range(0, h, strip)]
        assert [i for st in strips for i in st] == list(range(h))
        threads = cl_threads(Nx, Ny, c, strip)
        assert threads == len(strips) * Ny <= MAX_THREADS
        ranks = cl_ranks(Nx, Ny, plan)
        a, b0 = CL_REGS
        regs = -(-(a * strip + b0) // 8) * 8
        assert 1 <= ranks <= CL_MAX_RANKS and ranks * threads <= 2048
        assert ranks * -(-threads // 32) * 32 * regs <= 65536
        assert cl_bytes(Nx, Ny, plan) <= SMEM_LIMIT
        assert ranks * (cl_bytes(Nx, Ny, plan) + transport.BLOCK_RESERVED) <= transport.SM_SHARED
    plan = cl_plan(Nx, Ny)
    assert (plan is None) == (not plans) and (plan is None or plan in plans)
    if plan is not None:
        one = [p for p in plans if p.strip == Nx // p.c]
        if plan.c == 2 or not one:
            assert plan == min(plans)
        else:
            assert plan.strip == Nx // plan.c and not any(p.c == 2 for p in plans)
            most = max(cl_ranks(Nx, Ny, p) / p.c for p in one)
            assert cl_ranks(Nx, Ny, plan) / plan.c == most
    if (Nx, Ny) in ROUTE_GRIDS:
        c, strip, ranks = ROUTE_PLANS[(Nx, Ny)]
        assert plan == (c, strip)
        assert cl_ranks(Nx, Ny, plan) == ranks and transport.route(Nx, Ny) == "cl"


def test_cl_plan_constants_match_the_cuda_source():
    """`cl_threads` and `cl_bytes` count what csrc `KClGeo` lays out: its
    threads and its bytes (two mbarriers, four halo rows, two fw tiles);
    its bounds are the plans'."""
    with open(os.path.join(CSRC, "transport_upwind.cu")) as f:
        text = f.read()
    geo = text[text.index("struct KClGeo"):]
    geo = geo[:geo.index("};")]
    defs = dict(re.findall(r"static constexpr int (\w+) = ([^;]+);", geo))
    assert "C >= 2 && C <= 16" in geo and f"THREADS <= {MAX_THREADS}" in geo
    assert f"H * NY <= {BAND_CELLS}" in geo and f"BYTES <= {SMEM_LIMIT}" in geo
    assert int(re.search(r"constexpr int kMaxStrip = (\d+);", text).group(1)) == MAX_STRIP
    for Nx, Ny in ROUTE_GRIDS + [(12, 10), (16, 9)]:
        for plan in cl_plans(Nx, Ny) or [ClPlan(2, 3)]:
            env = dict(NX=Nx, NY=Ny, C=plan.c, S=plan.strip)
            for name in ("H", "NB", "LAST", "THREADS", "HALO", "TILE", "BYTES"):
                expr = defs[name].replace("(int)sizeof(float)", "4").replace("/", "//")
                env[name] = eval(expr, {}, env)
            assert env["THREADS"] == cl_threads(Nx, Ny, plan.c, plan.strip)
            assert env["BYTES"] == cl_bytes(Nx, Ny, plan)
