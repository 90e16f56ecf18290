"""P-cl's schedule on the CPU: an emulation of the cluster's phases.

`cl_phases` lists the phases of one CG iteration of P-cl
(csrc/pressure_pcg_cl.cu) and the barrier after each: "cluster" (every
tile, then a cluster barrier), "block" / "warp" (a gathered level, which
every rank runs alone on its copy) or "none". Here every rank
runs those phases, two CG iterations, a window's end and its first
V-cycle, and one more iteration, at the row level: each tile row of a
level reads rows of its arrays (a gathered vector the row above and below,
a halo where the band ends), writes its own rows, and stores its band's
first and last rows into the neighbours' halos (the last split level's
restriction into every rank's copy, the coarse product's results into the
ranks that read them, a reduction's rank total into every rank's slot).
The addresses are those of `ops/pressure.layout` for the plan, so the
arrays that alias (the coarse levels' temporaries inside the fine one, the
V-cycle's fine vectors in the CG's) alias here too.

The ranks advance at random speeds, or one of them as far ahead as it can,
and within a rank the tiles of a phase run in any order, as the threads of
a block do (after a phase with no barrier, a thread's tile of the next
phase after its own of this one); an arrival waits for the rank's tiles, a
wait for every rank's arrival. Every read must see the value that the phase writing
it last in program order left (a reference run, phase by phase, says
which): an older value is a halo read before its wait, a newer one a store
that overwrote a value a rank still had to read.

On the card, the kernel's probe build (-DHM_CL_PROBE) holds the emulation
to the source: the cluster barriers it counts in one CG iteration are
`cl_barriers`', and the layout its `Geo` places is `ops/pressure.layout`'s
(`test_probe_build_matches_the_emulated_plan`, skipped without CUDA)."""

import os
import re

import numpy as np
import pytest
import torch

from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.multigrid import n_levels
from historymatching_tpu_torch.ops.pressure import (
    INV_PLACES,
    LEVEL_KEYS,
    SPLIT_MIN_CELLS,
    cl_bands,
    cl_inverse_rows,
    cl_plan,
    cl_split,
    cl_threads,
    layout,
)

# [23]'s grids of P-cl (chip_smoke.LARGE_GRIDS), and the cluster barriers of
# one CG iteration on each one's plan, scaled and unscaled (the first where
# the two differ); with the gathered levels run on the first rank alone and
# spread from there, one more where the inverse is shared, two more in place.
GRIDS = [(60, 60), (88, 88), (96, 96), (100, 100), (128, 128), (60, 220), (192, 192),
         (256, 256)]
BARRIERS = {(60, 60): 8, (88, 88): (8, 11), (96, 96): 15, (100, 100): 12, (128, 128): 15,
            (60, 220): 12, (192, 192): 15, (256, 256): 19}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cl_phases(Nx, Ny, c, place="shared"):
    """P-cl's phases over the ranks in one CG iteration (the inner loop's:
    the p.Ap reduction, the x and r update, a V-cycle, the r.z reduction,
    the p update), as (phase, level, barrier) in the kernel's order. The
    barrier follows the phase: "cluster" (every split level's phase, the
    reductions, the fine updates, a coarse product spread over the ranks),
    "block" or "warp" (a gathered level or the coarse solve, which every
    rank runs alone on its copy), or "none" (the last sweep, whose z each
    thread reads back on its own tiles)."""
    levels = n_levels(Nx, Ny)
    ls, lc = cl_split(Nx, Ny, levels, c, place), levels - 1
    nc = (Nx >> lc) * (Ny >> lc)
    # with the inverse whole in shared memory and small, the levels from the
    # first of <= 64 cells and the coarse solve run on warp 0
    lw = lc
    if place == "shared" and nc <= 64:
        lw = next(lvl for lvl in range(ls, levels) if lvl == lc or (Nx >> lvl) * (Ny >> lvl) <= 64)
    gathered = range(ls, lc)
    vc = [(ph, lvl, "cluster") for lvl in range(ls) for ph in ("smooth_down", "restrict")]
    vc += [(ph, lvl, "block" if lvl < lw else "warp") for lvl in gathered
           for ph in ("smooth_down", "restrict")]
    vc.append(("coarse", lc, "cluster" if place != "shared" else "warp" if nc <= 64 else "block"))
    vc += [(ph, lvl, "block" if lvl < lw else "warp") for lvl in reversed(gathered)
           for ph in ("smooth_up_first", "smooth_up_second")]
    vc += [(ph, lvl, "cluster") for lvl in reversed(range(1, ls))
           for ph in ("smooth_up_first", "smooth_up_second")]
    vc += [("smooth_up_first", 0, "cluster"), ("smooth_up_second", 0, "none")]
    return ([("pAp", 0, "cluster"), ("update_xr", 0, "cluster")] + vc
            + [("rz", 0, "cluster"), ("update_p", 0, "cluster")])


def cl_barriers(Nx, Ny, c, place="shared"):
    """P-cl's cluster barriers in one CG iteration (`cl_phases`)."""
    return sum(k == "cluster" for _, _, k in cl_phases(Nx, Ny, c, place))


class Plan:
    """A plan's geometry as the kernel's `Geo` places it: bands, rows and
    the address of each array's row (rows of a split level counted from
    the band's first, -1 and the band's height its halo rows)."""

    def __init__(self, Nx, Ny, unit, c, place):
        self.Nx, self.Ny, self.unit, self.c, self.place = Nx, Ny, unit, c, place
        self.levels = n_levels(Nx, Ny)
        self.lc = self.levels - 1
        self.ls = cl_split(Nx, Ny, self.levels, c, place)
        self.bands = cl_bands(Nx, Ny, self.levels, c, place)
        self.ranks = sum(1 for _, h in self.bands if h)
        self.lv, self.extra, self.floats = layout(Nx, Ny, self.levels, unit, cl=c, place=place)
        self.warps = cl_threads(Nx, Ny, c, place) // 32
        self.nc = (Nx >> self.lc) * (Ny >> self.lc)

    def m(self, lvl):
        return self.Ny >> lvl

    def split(self, lvl):
        return lvl < self.ls

    def rows_of(self, q, lvl):
        return self.bands[q][1] >> lvl if self.split(lvl) else self.Nx >> lvl

    def first(self, q, lvl):
        return self.bands[q][0] >> lvl if self.split(lvl) else 0

    def below(self, q):
        return q < self.ranks - 1

    def row(self, lvl, key, i):
        """(address, floats) of row i of a level's array."""
        m = self.m(lvl)
        return self.lv[lvl][key] + (i + (1 if self.split(lvl) else 0)) * m, m


class Tile:
    """One tile row's accesses: reads (address, floats) of its own rank and
    writes (rank, address, floats)."""

    def __init__(self, rank, row=None):
        self.rank, self.row, self.reads, self.writes = rank, row, [], []


def gather(pl, t, lvl, key, i, r):
    """Rows 2I-1..2I+2 of a vector (the rows that exist)."""
    ti = pl.rows_of(r, lvl) // 2
    up = i > 0 or (pl.split(lvl) and r > 0)
    dn = i < ti - 1 or (pl.split(lvl) and pl.below(r))
    rows = [2 * i, 2 * i + 1] + ([2 * i - 1] if up else []) + ([2 * i + 2] if dn else [])
    t.reads += [pl.row(lvl, key, k) for k in rows]
    return up, dn


def faces(pl, t, lvl, i, up, dn, unit_level):
    t.reads += [pl.row(lvl, "TX", k) for k in [2 * i] + ([2 * i - 1] if up else [])
                + ([2 * i + 1] if dn else [])]
    t.reads += [pl.row(lvl, "TY", k) for k in (2 * i, 2 * i + 1)]
    if not unit_level:
        t.reads += [pl.row(lvl, k, j) for k in ("D", "RD") for j in (2 * i, 2 * i + 1)]


def own(pl, t, lvl, key, i):
    t.reads += [pl.row(lvl, key, k) for k in (2 * i, 2 * i + 1)]


def put_band(pl, t, lvl, key, i, r):
    """Own rows 2I, 2I+1; on a split level the band's first row into the
    rank above's lower halo and its last into the rank below's upper one."""
    t.writes += [(r, *pl.row(lvl, key, k)) for k in (2 * i, 2 * i + 1)]
    if pl.split(lvl):
        if i == 0 and r > 0:
            t.writes.append((r - 1, *pl.row(lvl, key, pl.rows_of(r - 1, lvl))))
        if i == pl.rows_of(r, lvl) // 2 - 1 and pl.below(r):
            t.writes.append((r + 1, *pl.row(lvl, key, -1)))


def parent_row(pl, lvl, i, r):
    """Level l+1's row under tile row I of rank r (`Parent::at`)."""
    gathered = pl.split(lvl) and not pl.split(lvl + 1)
    return (pl.first(r, lvl) // 2 if gathered else 0) + i


def parent_reads(pl, t, lvl, i, r, rows):
    t.reads += [pl.row(lvl + 1, "X", parent_row(pl, lvl, i, r) + d) for d in rows]


def parent_store(pl, t, lvl, i, r):
    """A restricted row into level l+1's right-hand side: every rank's copy
    where l+1 is gathered below a split level, else the rank's own, and
    the neighbours' halos where l+1 is split."""
    a = pl.row(lvl + 1, "B", parent_row(pl, lvl, i, r))
    if pl.split(lvl) and not pl.split(lvl + 1):
        t.writes += [(q, *a) for q in range(pl.c)]
        return
    t.writes.append((r, *a))
    if pl.split(lvl + 1):
        if i == 0 and r > 0:
            t.writes.append((r - 1, *pl.row(lvl + 1, "B", pl.rows_of(r - 1, lvl + 1))))
        if i == pl.rows_of(r, lvl) // 2 - 1 and pl.below(r):
            t.writes.append((r + 1, *pl.row(lvl + 1, "B", -1)))


def level_tiles(pl, name, lvl, r):
    """The tiles of one V-cycle phase of level l (or a CG phase on the fine
    level) on rank r: a tile row each."""
    out = []
    unit_level = lvl == 0 and pl.unit
    for i in range(pl.rows_of(r, lvl) // 2):
        t = Tile(r, i)
        if name == "smooth_down":
            up, dn = gather(pl, t, lvl, "B", i, r)
            if not unit_level:
                gather(pl, t, lvl, "RD", i, r)
            faces(pl, t, lvl, i, up, dn, unit_level)
            put_band(pl, t, lvl, "X", i, r)
        elif name == "restrict":
            up, dn = gather(pl, t, lvl, "X", i, r)
            faces(pl, t, lvl, i, up, dn, unit_level)
            own(pl, t, lvl, "B", i)
            parent_store(pl, t, lvl, i, r)
        elif name == "smooth_up_first":
            up, dn = gather(pl, t, lvl, "X", i, r)
            parent_reads(pl, t, lvl, i, r, [0] + ([-1] if up else []) + ([1] if dn else []))
            faces(pl, t, lvl, i, up, dn, unit_level)
            own(pl, t, lvl, "B", i)
            put_band(pl, t, lvl, "T", i, r)
        elif name == "smooth_up_second":  # with the Chebyshev sweep's reads
            up, dn = gather(pl, t, lvl, "T", i, r)
            faces(pl, t, lvl, i, up, dn, unit_level)
            own(pl, t, lvl, "B", i)
            own(pl, t, lvl, "X", i)
            parent_reads(pl, t, lvl, i, r, [0])
            if lvl > 0:
                put_band(pl, t, lvl, "X", i, r)
            else:  # z over the fine iterate's own rows
                t.writes += [(r, *pl.row(0, "X", k)) for k in (2 * i, 2 * i + 1)]
        elif name == "pAp":  # A p into T, the rank's own rows
            up, dn = gather(pl, t, 0, "X", i, r)
            faces(pl, t, 0, i, up, dn, pl.unit)
            t.writes += [(r, *pl.row(0, "T", k)) for k in (2 * i, 2 * i + 1)]
        elif name == "update_xr":
            own(pl, t, 0, "B", i)
            own(pl, t, 0, "T", i)
            put_band(pl, t, 0, "B", i, r)
        elif name == "rz":  # r and z
            own(pl, t, 0, "B", i)
            own(pl, t, 0, "X", i)
        elif name in ("update_p", "restart_p"):  # z, then p over it (the restart's r.z too)
            if name == "restart_p":
                own(pl, t, 0, "B", i)
            own(pl, t, 0, "X", i)
            put_band(pl, t, 0, "X", i, r)
        elif name == "put_x":  # the window's iterate into T
            put_band(pl, t, 0, "T", i, r)
        elif name == "residual":
            up, dn = gather(pl, t, 0, "T", i, r)
            faces(pl, t, 0, i, up, dn, pl.unit)
            put_band(pl, t, 0, "B", i, r)
        else:
            raise ValueError(name)
        out.append(t)
    return out


def coarse_tiles(pl, r):
    """The coarsest solve on rank r: whole on each rank where the inverse is
    in its shared memory; else the rows of the product split over the
    ranks (rank-major blocks of its warps' rows in place, a block of rows
    where distributed), each result stored into the ranks that read it."""
    lc, nc, mc = pl.lc, pl.nc, pl.m(pl.lc)
    t = Tile(r)
    x = pl.lv[lc]["X"]
    t.reads.append((pl.lv[lc]["B"], nc))
    if pl.place == "shared":
        t.reads.append((pl.extra["inverse"], nc * nc))
        t.writes.append((r, x, nc))
        return [t]
    if pl.place == "device":
        mine = [k for k in range(nc) if (k // pl.warps) % pl.c == r]
        t.writes += [(q, x + k, 1) for k in mine for q in range(pl.c)]
        return [t]
    k0, k1 = cl_inverse_rows(nc, pl.c)[r]
    t.reads.append((pl.extra["inverse"], (k1 - k0) * nc + 3))
    for k in range(k0, k1):
        for q in range(pl.c):
            f, h = pl.first(q, lc - 1) // 2, pl.rows_of(q, lc - 1) // 2
            if h and f - 1 <= k // mc <= f + h:
                t.writes.append((q, x + k, 1))
    return [t]


def sequence(pl):
    """The phases emulated: two inner CG iterations (`cl_phases`), a window's
    end (the iterate into T, the true residual and its sum), the V-cycle and
    the restart's r.z with p stored, and one more iteration."""
    inner = cl_phases(pl.Nx, pl.Ny, pl.c, pl.place)
    names = [n for n, _, _ in inner]
    assert names[:2] == ["pAp", "update_xr"] and names[-2:] == ["rz", "update_p"]
    vcyc = inner[2:-2]
    outer = ([("put_x", 0, "cluster"), ("residual", 0, "cluster")] + vcyc
             + [("restart_p", 0, "cluster")])
    return inner + inner + outer + inner


REDUCING = ("pAp", "rz", "residual", "restart_p")


def span(ranges):
    return np.concatenate([np.arange(o, o + n) for o, n in ranges]) if ranges else np.zeros(
        0, dtype=np.int64)


def build(pl):
    """Each rank's actions and their order within the rank: acts[r] is a
    list of (kind, payload, deps), deps indices into the same list. A tile's
    payload is (key, reads, writes): the key orders the writes (three times
    the phase's index; a reduction's rank total one more, its read of the
    totals two more), the reads an index array of the rank's floats, the
    writes (rank, index array) pairs. An arrival and a wait carry their
    barrier's number."""
    acts = [[] for _ in range(pl.c)]
    frontier = [[] for _ in range(pl.c)]  # what the next actions follow
    pending = [[] for _ in range(pl.c)]  # tiles the next barrier follows
    # after a phase with no barrier, its tiles by row: a thread runs the
    # same tiles of the next fine phase after its own of this one
    same = [{} for _ in range(pl.c)]
    red_set, barrier = 0, 0
    slots = 2 * (pl.warps + pl.c)  # a set: the warps' pairs, then the ranks' totals

    def tile(key, t):
        by = {}
        for q, o, n in t.writes:
            assert 0 <= o and o + n <= pl.floats, (key, q, o, n)
            by.setdefault(q, []).append((o, n))
        return key, span(t.reads), [(q, span(w)) for q, w in by.items()]

    for ph, (name, lvl, kind) in enumerate(sequence(pl)):
        for r in range(pl.c):
            a = acts[r]

            def add(kind_, payload, deps, a=a):
                a.append((kind_, payload, list(deps)))
                return len(a) - 1

            tiles = coarse_tiles(pl, r) if name == "coarse" else level_tiles(pl, name, lvl, r)
            ids = [add("tile", tile(3 * ph, t), frontier[r] + (
                [same[r][t.row]] if t.row in same[r] else [])) for t in tiles]
            same[r] = {t.row: i for t, i in zip(tiles, ids)} if kind == "none" else {}
            if kind == "none":
                pending[r] += ids
                continue
            done = ids + pending[r]
            pending[r] = []
            base = pl.extra["reduction"] + red_set * slots
            if name in REDUCING:
                # each warp's pair into its slot, a block barrier, thread 0's
                # total of them into this rank's slot on every rank
                t = Tile(r)
                t.writes.append((r, base, 2 * pl.warps))
                sync = add("sync", None, [add("tile", tile(3 * ph, t), done + frontier[r])])
                t = Tile(r)
                t.reads.append((base, 2 * pl.warps))
                t.writes += [(q, base + 2 * (pl.warps + r), 2) for q in range(pl.c)]
                done = [add("tile", tile(3 * ph + 1, t), [sync])]
            # a rank with no rows of a level still passes its barriers in order
            if kind in ("block", "warp"):
                frontier[r] = [add("sync", None, done + frontier[r])]
                continue
            arrive = add("arrive", barrier, done + frontier[r])
            frontier[r] = [add("wait", barrier, [arrive])]
            if name in REDUCING:  # every thread adds the ranks' totals
                t = Tile(r)
                t.reads.append((base + 2 * pl.warps, 2 * pl.c))
                frontier[r] = [add("tile", tile(3 * ph + 2, t), frontier[r])]
        if kind not in ("none", "block", "warp"):
            barrier += 1
        if name in REDUCING:
            red_set ^= 1
    return acts, barrier


def reference(pl, acts):
    """In the order of the keys, every read of a key before its writes: the
    value each read must see (the key that wrote each float last). Also: no
    two tiles of one key write one float."""
    mem = np.full((pl.c, pl.floats), -1, dtype=np.int64)
    by_key = {}
    for r, a in enumerate(acts):
        for j, (kind, payload, _) in enumerate(a):
            if kind == "tile":
                by_key.setdefault(payload[0], []).append((r, j, payload))
    expect = {}
    for key in sorted(by_key):
        for r, j, (_, reads, _) in by_key[key]:
            expect[r, j] = mem[r, reads].copy()
        seen = np.zeros((pl.c, pl.floats), dtype=bool)
        for r, j, (_, _, writes) in by_key[key]:
            for q, idx in writes:
                assert not seen[q, idx].any(), ("two writes of one float in one phase", key, q)
                seen[q, idx] = True
                mem[q, idx] = key
    return expect


def emulate(pl, acts, n_barriers, expect, rng, lead=None):
    """Run the ranks' actions in an order that the barriers allow, checking
    each tile's reads against `expect`: the next action is drawn from the
    ready ones of rank r with weight speed[r], or of rank `lead` whenever
    it has one."""
    mem = np.full((pl.c, pl.floats), -1, dtype=np.int64)
    need = [[len(deps) for _, _, deps in a] for a in acts]
    after = [[[] for _ in a] for a in acts]
    for r, a in enumerate(acts):
        for j, (_, _, deps) in enumerate(a):
            for d in deps:
                after[r][d].append(j)
    ready = [[j for j, n in enumerate(need[r]) if n == 0] for r in range(pl.c)]
    arrived = np.zeros(n_barriers, dtype=np.int64)
    speed = rng.lognormal(0.0, 1.5, pl.c)
    left = sum(len(a) for a in acts)

    def movable(r):  # a ready action that is not a wait on a barrier still open
        return [j for j in ready[r] if acts[r][j][0] != "wait" or arrived[acts[r][j][1]] == pl.c]

    while left:
        can = {r: m for r in range(pl.c) if (m := movable(r))}
        assert can, "deadlock: no rank can move"
        if lead in can:
            r = lead
        else:
            rs = list(can)
            w = speed[rs]
            r = rs[rng.choice(len(rs), p=w / w.sum())]
        j = can[r][rng.integers(len(can[r]))]
        ready[r].remove(j)
        kind, payload, _ = acts[r][j]
        if kind == "arrive":
            arrived[payload] += 1
        elif kind == "tile":
            key, reads, writes = payload
            got, want = mem[r, reads], expect[r, j]
            if not np.array_equal(got, want):
                bad = got != want
                raise AssertionError(
                    f"key {key} rank {r}: "
                    + ("a store overwrote a value before this read" if (got > want)[bad].any()
                       else "read before the store it needs")
                    + f" (floats {reads[bad][:4]}, saw {got[bad][:4]}, wanted {want[bad][:4]})")
            for q, idx in writes:
                mem[q, idx] = key
        for k in after[r][j]:
            need[r][k] -= 1
            if need[r][k] == 0:
                ready[r].append(k)
        left -= 1


def plans():
    for Nx, Ny in GRIDS:
        for unit in (True, False):
            yield Nx, Ny, unit


@pytest.mark.parametrize("Nx,Ny,unit", list(plans()))
def test_cluster_barriers_of_each_plan(Nx, Ny, unit):
    """Each plan of [23]'s grids takes the cluster barriers an iteration
    that `cl_barriers` counts: one after each phase of a split level, the
    two reductions, the fine updates and a coarse product spread over the
    ranks; none for the gathered levels and a coarse solve in one rank's
    shared memory."""
    c, place = cl_plan(Nx, Ny, unit)
    want = BARRIERS[Nx, Ny]
    assert cl_barriers(Nx, Ny, c, place) == (want if isinstance(want, int) else want[not unit])
    kinds = cl_phases(Nx, Ny, c, place)
    ls = cl_split(Nx, Ny, n_levels(Nx, Ny), c, place)
    assert all(lvl < ls for name, lvl, k in kinds if k == "cluster" and name != "coarse")
    assert all(lvl >= ls for name, lvl, k in kinds if k in ("block", "warp"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("Nx,Ny,unit", list(plans()))
def test_schedule_reads_what_the_phase_before_wrote(Nx, Ny, unit, seed):
    """Ranks at random speeds, and each rank in turn running ahead, through
    two CG iterations, a window's end and one more iteration: every read of
    a halo, a gathered level, a reduction slot or a rank's own rows sees the
    value of the phase that wrote it last, on the plan's own layout."""
    c, place = cl_plan(Nx, Ny, unit)
    pl = Plan(Nx, Ny, unit, c, place)
    acts, n_barriers = build(pl)
    expect = reference(pl, acts)
    rng = np.random.default_rng(seed)
    emulate(pl, acts, n_barriers, expect, rng)
    emulate(pl, acts, n_barriers, expect, rng, lead=seed % c)
    emulate(pl, acts, n_barriers, expect, rng, lead=c - 1 - seed % c)


def test_emulation_catches_an_arrival_too_early():
    """The emulation's own check: where a rank arrives at each barrier
    before its tiles, some order reads a halo before the neighbour's store
    lands there."""
    pl = Plan(128, 128, True, 8, "shared")
    acts, n_barriers = build(pl)
    moved = []
    for a in acts:
        for j, (kind, payload, deps) in enumerate(a):
            if kind == "arrive":
                a[j] = (kind, payload, [])
                moved.append(j)
    expect = reference(pl, acts)
    with pytest.raises(AssertionError):
        for seed in range(4):
            emulate(pl, acts, n_barriers, expect, np.random.default_rng(seed), lead=seed)
    assert moved


def test_plan_constants_match_the_cuda_source():
    """The plan's constants are the kernel's: the smallest split level, the
    inverse's places and the shared memory a block may take; every plan's
    library, and its probe build, is built on `cl_threads`' threads a rank."""
    with open(os.path.join(_build.CSRC, "pressure_pcg_cl.cu")) as f:
        text = f.read()

    def num(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert num("kSplitMinCells") == SPLIT_MIN_CELLS
    assert num("kSmemLimit") == _build.SMEM_LIMIT
    got = re.search(r"constexpr int kInvDevice = (\d+), kInvShared = (\d+), "
                    r"kInvDistributed = (\d+);", text)
    assert dict(zip(("device", "shared", "distributed"), map(int, got.groups()))) == INV_PLACES
    assert re.search(r"using GridGeo = Geo<HM_GRID_NX, HM_GRID_NY, HM_CL, HM_CL_INV, "
                     r"HM_CL_THREADS,", text)
    for Nx, Ny, unit in plans():
        c, place = cl_plan(Nx, Ny, unit)
        for probe in (False, True):
            _, stem, flags, _, sigs = _build._cl_specs(Nx, Ny, [(c, place)], probe=probe)[0]
            assert stem == "pressure_pcg_cl" and sigs in _build._SIGNATURES
            assert f"-DHM_CL_THREADS={cl_threads(Nx, Ny, c, place)}" in flags
            assert f"-DHM_CL_INV={INV_PLACES[place]}" in flags and f"-DHM_CL={c}" in flags
            assert ("-DHM_CL_PROBE" in flags) == probe


@pytest.fixture(scope="module")
def probes():
    """The probe builds of every plan of `GRIDS`, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe build runs the kernel")
    _build.prebuild(cl_probes=[(Nx, Ny, *cl_plan(Nx, Ny, unit)) for Nx, Ny, unit in plans()])


@pytest.mark.cuda
@pytest.mark.parametrize("Nx,Ny,unit", list(plans()))
def test_probe_build_matches_the_emulated_plan(probes, Nx, Ny, unit):
    """The emulation above is of the kernel: on each plan of [23]'s grids
    the probe build's `Geo` places every array where `ops/pressure.layout`
    puts it (the addresses the emulation reads and writes), and the kernel
    passes `cl_barriers`' cluster barriers in one CG iteration, counted on
    member 0 of a system of the flagship geometry
    (`chip_smoke.cl_iteration_barriers`)."""
    import ctypes

    import chip_smoke as cs
    from historymatching_tpu_torch.models.ressim import _source_field
    from historymatching_tpu_torch.parallel.runner import set_perm

    c, place = cl_plan(Nx, Ny, unit)
    levels = n_levels(Nx, Ny)
    lib = _build.pressure_cl_lib(Nx, Ny, c, place, True)
    out = (ctypes.c_int * (1 + 9 * levels + 4))()
    _build.check(lib.hm_pressure_cl_layout(int(unit), out), "probe")
    lv, extra, floats = layout(Nx, Ny, levels, unit, cl=c, place=place)
    assert out[0] == levels
    for lvl in range(levels):
        got = dict(zip(LEVEL_KEYS, out[1 + 9 * lvl:10 + 9 * lvl]))
        assert got == {k: lv[lvl][k] for k in LEVEL_KEYS}, (lvl, got, lv[lvl])
    inverse, barrier, reduction, total = out[1 + 9 * levels:]
    assert (reduction, total) == (extra["reduction"], floats)
    assert inverse == extra.get("inverse", inverse)
    assert barrier == extra.get("barrier", barrier)

    dev = torch.device("cuda")
    m = cs.grid_model(torch, Nx, Ny)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
    pre = torch.randn(2, m.Nxy, generator=g, device=dev)
    qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
    args = cs.p_system(set_perm(m, pre if unit else cs.MILD * pre), qf, unit)
    assert cs.cl_iteration_barriers(args, unit, (c, place)) == cl_barriers(Nx, Ny, c, place)
