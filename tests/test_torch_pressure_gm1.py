"""What the CPU can check of P-gm1, kernel P on one block a member with its
arrays split between shared memory and a device workspace
(csrc/pressure_pcg_gm1.cu): its plan (`ops/pressure.gm1_plan` and the table
the C entry reads), the constants the plan shares with the CUDA source, and
the ring that streams the coarsest inverse through shared memory, in a
plain emulation of the kernel's stream and coarse product.

The emulation mirrors the kernel's `stream_of`, `fill`, `refill` and
`coarse_solve` on a flat array of B members' inverses (a tensor that starts
on a 16-byte boundary, so member b starts at float phase (b nc^2) mod 4).
The copying thread writes a stage's plain ends when it issues the stage;
the bulk copy's floats land later, when a seeded scheduler completes the
copy, and a copy asserts that it is 16-byte aligned at both ends and reads
nothing outside the member's inverse. Each warp runs as its own coroutine
and waits for a slot's fill to have landed; the copying thread waits
until every warp has arrived on the slot's empty barrier; the scheduler
interleaves warps and landings as far as those waits allow. Each slot
carries the stage it holds, and a read asserts it is the stage expected.
Over two V-cycles (the second on a ring refilled ahead during the first)
the product equals Ainv @ b in float64, and in float32 equals a reference
that sums each row a warp in the kernel's order (each lane its columns
lane, lane + 32, ... in order, then the butterfly `warp_sum`)."""

import os
import random
import re

import numpy as np
import pytest

from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.multigrid import n_levels
from historymatching_tpu_torch.ops.pressure import (
    CG_KEYS,
    GM1_MAX_STAGES,
    GM1_MAX_THREADS,
    GM1_MIN_STAGES,
    GM1_RING_MIN_BYTES,
    GM1_SMEM_BYTES,
    GM1_STAGE_BYTES,
    LEVEL_KEYS,
    gm1_arrays,
    gm1_plan,
    gm1_table,
)

# The grids P-gm1 runs or is forced at: chip_smoke.py [18] (P built for new
# grids), [23] (the grids past one block, the 120x440 and 32x1088 paths),
# [24b] (60x220, 100x100), and the long 8x5000 of the route test.
PLAN_GRIDS = [(8, 8), (10, 10), (12, 12), (24, 16), (80, 80), (60, 60), (88, 88), (96, 96),
              (100, 100), (128, 128), (60, 220), (192, 192), (256, 256), (120, 440),
              (32, 1088), (8, 5000), (64, 64)]


# (shared bytes at most, ring held back, least stage): the route's plan,
# and the plan of a whole block that bench_routes.py --kernel gm1 times
# beside it.
PLANS = {"route": (GM1_SMEM_BYTES, GM1_RING_MIN_BYTES, GM1_STAGE_BYTES),
         "whole block": (_build.SMEM_LIMIT, 131_072, 65_536)}


def _r4(v):
    return (v + 3) // 4 * 4


def _nc(Nx, Ny):
    lc = n_levels(Nx, Ny) - 1
    return (Nx >> lc) * (Ny >> lc)


@pytest.mark.parametrize("which", list(PLANS))
@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", PLAN_GRIDS)
def test_gm1_plan_fits_and_places_each_array_once(Nx, Ny, unit_diag, which):
    """Each plan (the route's, and a whole block's) fits its shared memory
    and so one block's; every array of the hierarchy and the CG
    vectors is placed exactly once, in shared memory or in the workspace,
    4-aligned, and no two spans overlap in either (the head's barriers,
    reduction slots and ends, the arrays, the ring); the coarsest level's
    vectors are in shared memory; the ring has GM1_MIN_STAGES to
    GM1_MAX_STAGES stages of a multiple of 16 bytes, each no larger than a
    member's stream cut in as many, and at least the plan's least stage
    where its shared memory left that much."""
    smem, _, least = PLANS[which]
    plan = gm1_plan(Nx, Ny, unit_diag, *PLANS[which])
    assert (which != "route") or plan == gm1_plan(Nx, Ny, unit_diag)
    ranked, rest = gm1_arrays(Nx, Ny, unit_diag)
    sizes = dict(ranked + rest)
    assert len(sizes) == len(ranked) + len(rest)
    assert set(plan.shared).isdisjoint(plan.device)
    assert set(plan.shared) | set(plan.device) == set(sizes)
    lc = n_levels(Nx, Ny) - 1
    assert ("B", lc) in plan.shared and ("X", lc) in plan.shared
    assert plan.smem_bytes <= smem <= _build.SMEM_LIMIT
    assert GM1_MIN_STAGES <= plan.stages <= GM1_MAX_STAGES
    assert plan.stage > 0 and (4 * plan.stage) % 16 == 0 and plan.ring % 4 == 0
    stream = _r4(_nc(Nx, Ny) ** 2 + 3)
    assert plan.stage <= _r4(-(-stream // plan.stages))
    left = smem // 4 - plan.ring
    assert plan.stage == min(left // plan.stages // 4 * 4, _r4(-(-stream // plan.stages)))
    if left >= GM1_MIN_STAGES * least // 4:
        assert plan.stage >= min(least // 4, _r4(-(-stream // plan.stages))), plan
    head = [("bars", plan.bars, plan.bars + 4 * GM1_MAX_STAGES),
            ("red", plan.red, plan.red + 4 * (GM1_MAX_THREADS // 32)),
            ("ends", plan.ends, plan.ends + 8),
            ("ring", plan.ring, plan.ring + plan.stages * plan.stage)]
    for space, total, extra in ((plan.shared, plan.smem_bytes // 4, head),
                                (plan.device, plan.ws_floats, [])):
        spans = sorted(extra + [(k, o, o + sizes[k]) for k, o in space.items()],
                       key=lambda s: s[1])
        assert all(o % 4 == 0 and 0 <= o < e <= total for _, o, e in spans), spans
        assert all(e1 <= o2 for (_, _, e1), (_, o2, _) in zip(spans, spans[1:])), spans
    assert plan.threads == min(GM1_MAX_THREADS, -(-(Nx // 2) * (Ny // 2) // 32) * 32)


@pytest.mark.parametrize("which", list(PLANS))
@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", [(100, 100), (60, 220), (32, 1088), (64, 64)])
def test_gm1_table_carries_the_plan(Nx, Ny, unit_diag, which):
    """The C entry's table, of the grid's plan or the plan given: the
    head's fields, then per level its sides and each array's offset (the
    workspace float, or -1 - the shared float; 0 for an array the level
    does not have)."""
    plan = gm1_plan(Nx, Ny, unit_diag, *PLANS[which])
    table = gm1_table(Nx, Ny, unit_diag, None if which == "route" else plan)
    levels = n_levels(Nx, Ny)
    where = lambda k: (-1 - plan.shared[k] if k in plan.shared  # noqa: E731
                       else plan.device.get(k, 0))
    assert table[:10] == [levels, plan.ws_floats, plan.smem_bytes, plan.threads, plan.stages,
                          plan.stage, plan.ring, plan.bars, plan.red, plan.ends]
    assert table[10:14] == [plan.device[(k, None)] for k in CG_KEYS]
    assert len(table) == 14 + 9 * levels
    for lvl in range(levels):
        row = table[14 + 9 * lvl:14 + 9 * (lvl + 1)]
        assert row[:2] == [Nx >> lvl, Ny >> lvl]
        assert row[2:] == [where((k, lvl)) for k in LEVEL_KEYS[2:]]
    # the placed arrays are exactly those the table points into shared memory
    assert sum(1 for v in table[14:] if v < 0) == len(plan.shared)


def test_gm1_plan_constants_match_the_cuda_source():
    """The plan uses the kernel's thread cap, stage bounds and shared-memory
    limit, and the C entry reads the table in the plan's order."""
    with open(os.path.join(_build.CSRC, "pressure_pcg_gm1.cu")) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kMaxThreads = (\d+);", text).group(1)) == GM1_MAX_THREADS
    got = re.search(r"constexpr int kMinStages = (\d+), kMaxStages = (\d+);", text)
    assert tuple(map(int, got.groups())) == (GM1_MIN_STAGES, GM1_MAX_STAGES)
    assert int(re.search(r"constexpr int kSmemLimit = (\d+);", text).group(1)) == _build.SMEM_LIMIT
    fields = re.findall(r"a\.(\w+) = table\[(\d+)\];", text)
    assert [int(i) for _, i in fields] == list(range(14))
    assert [f for f, _ in fields] == ["L", "floats", "smem", "threads", "stages", "stage", "ring",
                                      "bars", "red", "ends", "xv", "pv", "zv", "apv"]


# ----------------------------------------------------------- the emulation


def _stream(base, n2, stage):
    """The kernel's `stream_of` for a member whose inverse starts at float
    `base` of a 16-byte-aligned tensor: (phase, he, be, K)."""
    phase = base & 3
    lead = (4 - phase) & 3
    he = phase + min(lead, n2)
    be = max(he, (phase + n2) & ~3)
    return phase, he, be, -(-_r4(phase + n2) // stage)


class _Ring:
    """A member's ring: the slots, the stage each holds, the fills issued
    and landed and the empty arrivals, by slot; copies in flight."""

    def __init__(self, flat, base, n2, stages, stage, warps):
        self.flat, self.base, self.n2 = flat, base, n2
        self.stages, self.stage, self.warps = stages, stage, warps
        self.phase, self.he, self.be, self.K = _stream(base, n2, stage)
        src = flat[base:base + n2]
        self.ends = np.zeros(8, flat.dtype)
        self.ends[:self.he - self.phase] = src[:self.he - self.phase]
        self.ends[4:4 + self.phase + n2 - self.be] = src[self.be - self.phase:]
        self.slots = np.full((stages, stage), np.nan, flat.dtype)
        self.holds = [None] * stages
        self.landed = [0] * stages   # fills of each slot that have landed
        self.arrived = [0] * stages  # empty arrivals of each slot
        self.flight = []             # (slot, dst offset, values, stage) of copies in flight

    def fill(self, gg):
        """The kernel's `fill`: the plain ends now, the bulk middle in flight."""
        slot, lo = gg % self.stages, (gg % self.K) * self.stage
        hi = lo + self.stage
        assert self.landed[slot] == gg // self.stages, "a slot refilled before it landed"
        for i in range(self.phase, self.he):
            if lo <= i < hi:
                self.slots[slot, i - lo] = self.ends[i - self.phase]
        for i in range(self.be, self.phase + self.n2):
            if lo <= i < hi:
                self.slots[slot, i - lo] = self.ends[4 + i - self.be]
        b0, b1 = max(lo, self.he), min(hi, self.be)
        src0 = self.base - self.phase  # the stream's first float in the tensor
        vals = None
        if b1 > b0:
            assert (src0 + b0) % 4 == 0 and (b1 - b0) % 4 == 0 and (b0 - lo) % 4 == 0
            assert self.base <= src0 + b0 and src0 + b1 <= self.base + self.n2
            vals = self.flat[src0 + b0:src0 + b1].copy()
        self.flight.append((slot, b0 - lo, vals, gg))

    def land(self, i):
        slot, o, vals, gg = self.flight.pop(i)
        if vals is not None:
            self.slots[slot, o:o + len(vals)] = vals
        self.holds[slot] = gg
        self.landed[slot] += 1


def _warp_sum(v):
    """The kernel's butterfly `warp_sum` over 32 lanes, in float32."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(v.dtype)
    return v


def _lanes(acc, row, b, c0, c1):
    """Each lane's columns of [c0, c1) in order into its sum: lane l takes
    c0 + ((l - c0) & 31), then every 32nd."""
    first = c0 + ((np.arange(32) - c0) & 31)
    for t in range(-(-(c1 - c0) // 32) + 1):
        idx = first + 32 * t
        on = idx < c1
        if not on.any():
            break
        acc[on] = (acc[on] + (row[idx[on]] * b[idx[on]]).astype(acc.dtype)).astype(acc.dtype)
    return acc


def _warp(ring, w, b, x, nc, g, copier):
    """One warp of the kernel's `coarse_solve`: yields a predicate whenever
    it must wait (a slot's fill to land, every warp's arrival on a slot)."""
    acc = np.zeros(32, ring.flat.dtype)
    warps = ring.warps
    for k in range(ring.K):
        gg = g + k
        slot = gg % ring.stages
        yield lambda s=slot, n=gg // ring.stages + 1: ring.landed[s] >= n
        assert ring.holds[slot] == gg
        if copier and k > 0:  # the previous slot refilled before the product
            yield from _refill(ring, gg - 1)
        st = ring.slots[slot]
        base = k * ring.stage - ring.phase
        p0, p1 = max(base, 0), min(base + ring.stage, ring.n2)
        if p0 < p1:
            r0, r1 = p0 // nc, (p1 - 1) // nc
            for r in range(r0 + (w - r0 % warps + warps) % warps, r1 + 1, warps):
                c0, c1 = max(0, p0 - r * nc), min(nc, p1 - r * nc)
                if c0 == 0:
                    acc[:] = 0
                o = r * nc - base
                seg = np.full(nc, np.nan, st.dtype)
                seg[c0:c1] = st[o + c0:o + c1]
                assert not np.isnan(seg[c0:c1]).any(), "read a float before it landed"
                acc = _lanes(acc, seg, b, c0, c1)
                if c1 == nc:
                    x[r] = _warp_sum(acc)[0]
        ring.arrived[slot] += 1
    if copier:
        yield from _refill(ring, g + ring.K - 1)


def _refill(ring, gg):
    slot = gg % ring.stages
    need = (gg // ring.stages + 1) * ring.warps
    yield lambda: ring.arrived[slot] >= need
    ring.fill(gg + ring.stages)


def _coarse_solve(ring, b, nc, g, rng):
    """Every warp's coroutine and the copies' landings, interleaved by `rng`
    as far as the waits allow; returns x."""
    x = np.full(nc, np.nan, b.dtype)
    procs = [[_warp(ring, w, b, x, nc, g, w == 0), None] for w in range(ring.warps)]
    while procs or ring.flight:
        ready = [p for p in procs if p[1] is None or p[1]()]
        moves = len(ready) + len(ring.flight)
        assert moves, "deadlock: every warp waits and no copy is in flight"
        i = rng.randrange(moves)
        if i >= len(ready):
            ring.land(i - len(ready))
            continue
        p = ready[i]
        try:
            p[1] = next(p[0])
        except StopIteration:
            procs.remove(p)
        if not procs:  # the block's barrier after the product: copies may stay in flight
            break
    return x


def _reference_f32(A, b):
    """x = A b a row a warp in the kernel's order of summation."""
    nc = len(b)
    x = np.empty(nc, np.float32)
    for r in range(nc):
        x[r] = _warp_sum(_lanes(np.zeros(32, np.float32), A[r], b, 0, nc))[0]
    return x


# (nc, stages, stage floats, warps): rows cut by stage boundaries (a stage
# shorter than a row, and longer), a ring of 2, 3 and 4 stages, a stream of
# as many stages as the ring (44, 7) and of fewer (9: one stage, a ring of
# 2; 7 on 3), more warps than a stage's rows and fewer.
RING_CASES = [(45, 2, 32, 4), (45, 3, 104, 16), (44, 2, 1024, 4), (45, 4, 516, 2),
              (21, 2, 236, 8), (45, 2, 1016, 16), (7, 2, 28, 1), (9, 2, 84, 2), (7, 3, 28, 2)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nc,stages,stage,warps", RING_CASES)
def test_ring_product_matches_two_v_cycles(nc, stages, stage, warps, dtype):
    """Members 0-5 of a batch of 6 (each phase mod 4 where nc^2 is odd, the
    last member's tail not a whole 16 bytes) through the ring over two
    V-cycles: every read is of a landed float of the stage expected, no
    copy leaves the member or breaks 16-byte alignment, and the product is
    Ainv @ b (float64, to rounding) or the warp-row-order sum (float32,
    exactly)."""
    B = 6
    rng = np.random.default_rng(nc * 1000 + stage)
    n2 = nc * nc
    flat = rng.standard_normal(B * n2).astype(dtype)
    sched = random.Random(stage * 7 + warps)
    for member in range(B):
        ring = _Ring(flat, member * n2, n2, stages, stage, warps)
        assert ring.phase == (member * n2) % 4
        for k in range(stages):
            ring.fill(k)
        A = flat[member * n2:(member + 1) * n2].reshape(nc, nc)
        g = 0
        for _ in range(2):
            b = rng.standard_normal(nc).astype(dtype)
            x = _coarse_solve(ring, b, nc, g, sched)
            g += ring.K
            if dtype == np.float64:
                np.testing.assert_allclose(x, A @ b, rtol=1e-12, atol=1e-12 * np.abs(A).sum())
            else:
                np.testing.assert_array_equal(x, _reference_f32(A, b))
        assert len(ring.flight) <= stages  # one fill a slot in flight at most
        while ring.flight:  # the kernel's drain before the block ends
            ring.land(0)
        assert ring.landed == [(g + stages - 1 - s) // stages + 1 for s in range(stages)]
    if n2 % 4:
        assert (B * n2) % 4, "the last member's tail is not a whole 16 bytes"
