"""Kernel P: the whole restarted MG-PCG pressure solve, for every member.

Replaces the TPU kernels of `historymatching_tpu/ops/pressure_pallas.py`
(`pressure_solve_pallas`, `_batched`, `_packed`): on the card one thread
block per member runs `ops.cg.pcg`'s algorithm with the V-cycle of
`ops.multigrid.vcycle_apply` inside (`csrc/pressure_pcg.cu`, a template on
the grid and built for any grid with a hierarchy, `_build.pressure_lib`).
On the Jacobi-scaled system, whose fine diagonal is 1
(`models.ressim.scaled_system` states the contract), the kernel takes that
as given and does not read it; with `unit_diag=False` (the unscaled
system) an instantiation that reads it runs. The semantics are those of
the per-member `pcg` (each member stops on its own), not of the TPU's
lockstep `pcg_batched`. Beside it, `pressure_solve_torch` is the plain
PyTorch version, built from the same two modules.

The V-cycle's smoother is a compile-time choice of the kernel: damped
Jacobi (launches counted as "pressure_pcg") or degree-2 Chebyshev
("pressure_pcg_cheb"), both instantiated for every grid; the instantiations
that read the fine diagonal count as "pressure_pcg_diag" and
"pressure_pcg_cheb_diag".

Where a member's layout (`layout`, `smem_bytes`) exceeds one block's
shared memory, P-cl runs instead (`csrc/pressure_pcg_cl.cu`, one library
a grid, cluster size and place of the coarsest inverse): the same solve on
a thread-block cluster of c blocks a member, each holding a band of rows
of the split levels and a copy of the coarse levels, which every block
runs, in the cluster's distributed shared memory (`layout` with `cl`
counts a block's share, `cl_plan` picks c and the inverse's place: whole
on every block, read in place from device memory, or, where neither
leaves room (100x100, a 60x220 layer), a block of its rows on each rank:
P-cl/d, `cl_bands`, `cl_inverse_rows`). Where no cluster of up to 16 holds it, or
the batch is past the grid's `DIST_BATCH_MAX`, P-gm runs
(`csrc/pressure_pcg_gm.cu`, one library a grid and plan): the same solve
on a member spread over G co-resident blocks, each holding a band of rows
of every level but the coarsest and a block of the coarsest inverse's
rows in its shared memory, band edges, the coarse solve's vectors and the
reductions exchanged through L2 (`gm_plan`, `gm_layout`). Where no plan
fits the card (a band wider than one block holds), or the batch is past
the grid's `GM_BATCH_MAX`, P-gm1 runs (`csrc/pressure_pcg_gm1.cu`, one
library for every grid): one block a member, its coarse levels and fine
faces in shared memory as far as they fit, the rest in a per-member
workspace that the wrapper allocates, and the coarsest inverse streamed
through a ring of bulk copies in shared memory (`gm1_plan`). Their launches count
under the same names with "_cl", "_gm" or "_gm1" appended. `route` says
which a grid takes, `force` ("cl", "gm", "gm1") takes one at any grid it
fits, and `plan` a cluster other than `cl_plan`'s. A grid without a
hierarchy is refused before any launch (`check_grid`); `models.ressim`
routes it to the plain Jacobi-PCG.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel, which raises on what it does not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.cg import pcg
from historymatching_tpu_torch.ops.multigrid import SMOOTHERS, n_levels, vcycle_apply
from historymatching_tpu_torch.ops.stencil import stencil_matvec, stencil_residual_ds


def pressure_solve_torch(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                         restart_every=8, smoother="jacobi", unit_diag=True):
    """Plain version. `hier` is the per-level list of (TX, TY, diag), each
    (B, ...); `Ainv` (B, n, n) the coarse inverse; q, p0, w (B, Nx, Ny);
    `smoother` the V-cycle's ("jacobi" or "cheb"). It reads the fine
    diagonal whatever `unit_diag` says.
    Returns (p, iters int32 (B,), rel (B,))."""
    TX, TY, diag = hier[0]
    return pcg(lambda x: stencil_matvec(TX, TY, diag, x), q, x0=p0,
               Minv=lambda r: vcycle_apply(hier, Ainv, r, smoother=smoother), tol=tol,
               maxiter=maxiter, restart_every=restart_every, patience_iters=patience_iters,
               metric_weight=w)


def _r4(v):
    return (v + 3) // 4 * 4


def _kernel_threads(Nx, Ny):
    """Threads of the kernel's block: one per four fine 2x2 tiles at 64x64,
    one per tile (in whole warps) on grids of up to 256 tiles."""
    tiles = Nx * Ny // 4
    return 256 if tiles > 256 else -(-tiles // 32) * 32


LEVEL_KEYS = ("n", "m", "TX", "TY", "D", "RD", "B", "X", "T")


CLUSTERS = (2, 4, 8, 16)  # P-cl's equal-band cluster sizes, smallest first (16: non-portable)
DIST_CLUSTERS = tuple(range(2, 17))  # with the inverse distributed: any size up to 16
SPLIT_MIN_CELLS = 256  # P-cl gathers a level of <= 16x16 cells, whole on every rank
# Where P-cl keeps a member's coarsest inverse: read in place from device
# memory, whole in every rank's shared memory, or a block of its rows in
# each rank's shared memory; the value is the kernel's -DHM_CL_INV.
INV_PLACES = {"device": 0, "shared": 1, "distributed": 2}


def cl_split(Nx, Ny, levels, c, place="shared"):
    """The levels a cluster of `c` splits into row bands, 0..LS-1. With the
    inverse shared or in device memory, the bands are equal: from the fine
    level down while a band is an even number of rows (the 2x2 tiles and
    the restriction stay inside a rank) and the level has more than
    SPLIT_MIN_CELLS cells; the coarsest is never split; 0 where the fine
    level does not split. With the inverse distributed, every level but
    the coarsest (`cl_bands`)."""
    if place == "distributed":
        return levels - 1
    ls = 0
    while (ls < levels - 1 and (Nx >> ls) % (2 * c) == 0
           and (Nx >> ls) * (Ny >> ls) > SPLIT_MIN_CELLS):
        ls += 1
    return ls


def cl_bands(Nx, Ny, levels, c, place="shared"):
    """Each rank's band of fine rows, (first row, rows): units of 2**LS
    rows (LS = `cl_split`, so a band stays even down every split level),
    the first (Nx >> LS) % c ranks one unit more than the others. Equal
    bands where the inverse is shared or in device memory; with it
    distributed, unequal ones, and a rank past the units holds no rows."""
    ls = cl_split(Nx, Ny, levels, c, place)
    base, extra = divmod(Nx >> ls, c)
    rows = [(base + (q < extra)) << ls for q in range(c)]
    return [(sum(rows[:q]), h) for q, h in enumerate(rows)]


def cl_inverse_rows(nc, c):
    """The rows [start, stop) of the coarsest inverse that each rank of a
    cluster of `c` holds where it is distributed: blocks of ceil(nc / c) rows,
    the last ones shorter or empty."""
    k = -(-nc // c)
    return [(min(nc, q * k), min(nc, (q + 1) * k)) for q in range(c)]


def cl_threads(Nx, Ny, c, place="shared"):
    """Threads of a P-cl rank: about one per four fine 2x2 tiles of its
    largest band, in the nearest whole multiple of 128 (the granule the
    registers are allocated in), from 128 to 1024; with the inverse
    distributed or read in place at least 256, eight warps a rank for the
    coarse product's rows (on an H100 the scaled 60x60 and 88x88 ran
    faster so at N=64 and 1000: bench_routes.py, PERF.md)."""
    h = max(rows for _, rows in cl_bands(Nx, Ny, n_levels(Nx, Ny), c, place))
    t = -(-(h * Ny // 4) // 4)
    t = max(128, min(1024, (t + 64) // 128 * 128))
    return t if place == "shared" else max(t, 256)


def layout(Nx, Ny, levels, unit_diag=True, cl=0, place="shared"):
    """Kernel P's arrays for one member (one rank of a cluster of `cl` for
    P-cl), in floats, each rounded up to 4: (per level a dict of its rows
    `n`, its columns `m`, whether it is `split` and the offsets of
    LEVEL_KEYS, the offsets of the extra arrays, the total).

    The fine level holds its faces TX, TY (padded to Ny wide), the vectors
    P (p; the V-cycle's iterate X), R (r; its right-hand side B) and the
    smoothing temporary T, and without `unit_diag` its diagonal D and
    reciprocal diagonal RD; an intermediate level its faces, D, RD, B and
    X, its temporary aliasing the fine T (while the temporaries fit there);
    the coarsest its B and X. Then (`Geo` in csrc/pressure_pcg.cu) the
    coarsest inverse (transposed) and two reduction slots a warp.

    With `cl` (P-cl, `Geo` in csrc/pressure_pcg_cl.cu) a rank holds a band
    of rows of each split level (`cl_split`, `cl_bands`; `n` is the
    largest band, which every rank's layout makes room for), each array
    with a halo row above and below (the offsets are of the halo row above;
    the one below follows the rank's own rows; where levels are gathered a
    coarse temporary aliases only the fine T's own rows), its TX one face
    row a cell
    row (zero past the grid's last face), and every other level whole
    (every rank runs them). `place` puts the coarsest inverse
    (`INV_PLACES`): "shared" whole, "device" nowhere (read in place),
    "distributed" a block of `cl_inverse_rows` and four floats for its
    alignment, then the bulk copy's barrier; then two reduction slots of the
    rank's warps (`cl_threads`) and the cluster's totals."""
    ls = cl_split(Nx, Ny, levels, cl, place) if cl else 0
    hmax = max(h for _, h in cl_bands(Nx, Ny, levels, cl, place)) if cl else Nx
    sides = [(Nx >> lvl, Ny >> lvl) for lvl in range(levels)]
    rows = [hmax >> lvl if lvl < ls else n for lvl, (n, _) in enumerate(sides)]
    vec = [_r4((h + (2 if lvl < ls else 0)) * m)
           for lvl, (h, (_, m)) in enumerate(zip(rows, sides))]
    lc = levels - 1
    # P-cl's levels gathered whole beside split ones: their temporaries
    # alias only the fine T's own rows, past its halo row above
    gathered_t = bool(cl) and place != "distributed"
    lv, o, t_off = [], 0, 0
    for lvl, (n, m) in enumerate(sides):
        d = dict(n=rows[lvl], m=m, split=lvl < ls, TX=0, TY=0, D=0, RD=0, B=o,
                 X=o + vec[lvl], T=0)
        if lvl < lc:
            d["TX"] = o
            d["TY"] = o + (vec[lvl] if lvl < ls else _r4((n - 1) * m))
            if lvl == 0:
                d["X"], d["B"], d["T"] = (d["TY"] + k * vec[0] for k in (1, 2, 3))
                d["D"] = d["TY"] + 4 * vec[0]
                size = d["TY"] - o + (4 if unit_diag else 6) * vec[0]
            else:
                d["D"] = d["TY"] + vec[lvl]
                d["B"] = d["D"] + 2 * vec[lvl]
                d["X"] = d["B"] + vec[lvl]
                size = d["TY"] - o + 5 * vec[lvl]
                t_off += vec[lvl]
                if t_off <= (rows[0] * sides[0][1] if gathered_t else vec[0]):
                    d["T"] = lv[0]["T"] + (sides[0][1] if gathered_t else 0) + t_off - vec[lvl]
                else:
                    d["T"] = d["X"] + vec[lvl]
                    size += vec[lvl]
            d["RD"] = d["D"] + vec[lvl]
        else:
            size = 2 * vec[lvl]
        lv.append(d)
        o += size
    nc = sides[lc][0] * sides[lc][1]
    extra = {}
    if place == "shared" or not cl:
        extra["inverse"] = o
        o += _r4(nc * nc)
    elif place == "distributed":
        start, stop = cl_inverse_rows(nc, cl)[0]
        extra["inverse"] = o
        o += _r4((stop - start) * nc) + 4
        extra["barrier"] = o
        o += 4
    extra["reduction"] = o
    # two slots of a float pair a warp; P-cl's slots add one a rank
    o += (4 * (cl_threads(Nx, Ny, cl, place) // 32 + cl) if cl
          else 4 * (_kernel_threads(Nx, Ny) // 32))
    return lv, extra, o


def smem_bytes(Nx, Ny, levels, unit_diag=True):
    """Shared memory the shared-memory kernel takes for one member: its
    `layout`."""
    return 4 * layout(Nx, Ny, levels, unit_diag)[2]


def cl_bytes(Nx, Ny, levels, c, unit_diag=True, place="shared"):
    """Shared memory one rank of P-cl's cluster of `c` takes: its `layout`."""
    return 4 * layout(Nx, Ny, levels, unit_diag, cl=c, place=place)[2]


def cl_fits(Nx, Ny, c, place, unit_diag=True, limit=None):
    """Whether a cluster of `c` with the inverse at `place` splits the grid
    and its rank fits `limit` bytes (by default one block's shared memory)."""
    levels = n_levels(Nx, Ny)
    return (levels >= 2 and cl_split(Nx, Ny, levels, c, place) >= 1
            and cl_bytes(Nx, Ny, levels, c, unit_diag, place)
            <= (_build.SMEM_LIMIT if limit is None else limit))


def cl_plan(Nx, Ny, unit_diag=True, place=None):
    """P-cl's cluster for a grid: (c, place of the coarsest inverse). First
    the smallest c of CLUSTERS whose rank, the inverse shared or else in
    device memory, leaves room for two blocks an SM
    (`_build.SMEM_TWO_A_SM`); then the smallest whose rank fits one block
    (`_build.SMEM_LIMIT`) with the inverse shared; then the smallest c of
    DIST_CLUSTERS whose rank fits with the inverse spread over the
    ranks. None where none does. With `place`, the smallest c that fits
    one block with the inverse there. (On an H100 at 128x128, c = 8, three
    blocks an SM, ran the bench case's first step 1.4x faster than c = 4,
    one an SM, and 1.6x faster than c = 16: chip_smoke.py [24]. A rank
    that reads the inverse from device memory and holds a whole SM lost to
    P-gm at 100x100 and 60x220 (bench_routes.py), so those grids
    distribute it. PERF.md keeps the figures.)"""
    if place is not None:
        sizes = DIST_CLUSTERS if place == "distributed" else CLUSTERS
        return next(((c, place) for c in sizes if cl_fits(Nx, Ny, c, place, unit_diag)), None)
    tiers = [(c, place, _build.SMEM_TWO_A_SM) for c in CLUSTERS for place in ("shared", "device")]
    tiers += [(c, "shared", None) for c in CLUSTERS]
    tiers += [(c, "distributed", None) for c in DIST_CLUSTERS]
    return next(((c, place) for c, place, limit in tiers
                 if cl_fits(Nx, Ny, c, place, unit_diag, limit)), None)


# P-gm1 (csrc/pressure_pcg_gm1.cu `kMaxThreads`, `kMinStages`, `kMaxStages`):
# a block's threads at most (one a fine 2x2 tile, in whole warps) and the
# ring's fewest and most stages; then the shared memory a plan takes at
# most, the ring it holds back from the arrays, and the least stage. On an
# H100 each stage's copy and barriers cost more than its bytes, so two
# stages of ~50 KB streamed faster than four to twelve of 16-40 KB; and a
# block under 160 KB, which leaves the SM ~92 KB of L1 for the fine
# passes' reads of neighbouring cells, ran faster at N=1000 and at 120x440
# from N=128 than a block of the whole 227 KB, which won only at 100x100
# N=64 and 32x1088 N=4 and tied at 100x100 N=128: too few points for a
# rule by batch (bench_routes.py --kernel gm1; PERF.md).
GM1_MAX_THREADS, GM1_MIN_STAGES, GM1_MAX_STAGES = 512, 2, 4
GM1_SMEM_BYTES, GM1_RING_MIN_BYTES, GM1_STAGE_BYTES = 163_840, 98_304, 49_152
CG_KEYS = ("x", "p", "z", "Ap")  # P-gm1's CG vectors, each a fine level's size


class Gm1Plan(NamedTuple):
    """P-gm1's plan for a grid (`gm1_plan`), in floats but `smem_bytes`:
    each array by (key, level) (a CG vector's level None) at its offset in
    `shared` memory or in the `device` workspace; the head in shared
    memory (the ring's barriers at `bars`, the reduction slots at `red`,
    the inverse's ends at `ends`); the ring of `stages` slots of `stage`
    floats at `ring`."""
    threads: int
    shared: dict
    device: dict
    bars: int
    red: int
    ends: int
    ring: int
    stages: int
    stage: int
    smem_bytes: int
    ws_floats: int


def gm1_threads(Nx, Ny):
    """Threads of a P-gm1 block: one per fine 2x2 tile, in whole warps, at
    most GM1_MAX_THREADS."""
    t = (Nx // 2) * (Ny // 2)
    return GM1_MAX_THREADS if t >= GM1_MAX_THREADS else -(-t // 32) * 32


def gm1_arrays(Nx, Ny, unit_diag=True):
    """P-gm1's arrays for one member, each (key, floats) rounded up to 4:
    those the plan places in shared memory while they fit, in its order (by
    reads a V-cycle per byte: the coarsest level's B and X; the coarser
    levels' whole sets, coarsest first; the fine TX and TY; the fine D and
    1/D where the system is unscaled), then those that stay in the device
    workspace (the fine X, B and T, the CG vectors)."""
    levels = n_levels(Nx, Ny)
    lc = levels - 1
    size = lambda lvl, k: _r4(((Nx >> lvl) - (k == "TX")) * (Ny >> lvl))  # noqa: E731
    sets = [((k, lvl), size(lvl, k)) for lvl in range(lc - 1, 0, -1)
            for k in ("TX", "TY", "D", "RD", "B", "X", "T")]
    fine = ("TX", "TY") + (() if unit_diag else ("D", "RD"))
    ranked = ([((k, lc), size(lc, k)) for k in ("B", "X")] + sets
              + [((k, 0), size(0, k)) for k in fine])
    rest = [((k, 0), size(0, k)) for k in ("B", "X", "T")] + [((k, None), size(0, "x"))
                                                            for k in CG_KEYS]
    return ranked, rest


@functools.lru_cache(maxsize=None)
def gm1_plan(Nx, Ny, unit_diag=True, smem=GM1_SMEM_BYTES, ring_min=GM1_RING_MIN_BYTES,
             stage_min=GM1_STAGE_BYTES):
    """P-gm1's plan for a grid (`Gm1Plan`), in at most `smem` bytes of
    shared memory. That holds the head (barriers for GM1_MAX_STAGES slots,
    two reduction slots of a float pair for GM1_MAX_THREADS // 32 warps,
    eight floats of the inverse's ends), then each array of `gm1_arrays`'
    ranked list, in order, that fits beside the ring held back (`ring_min`
    bytes, or a member's stream where smaller; for the coarsest level's
    vectors, the least ring); what is left goes to the ring: as many stages
    of at least `stage_min` bytes as fit (GM1_MIN_STAGES to
    GM1_MAX_STAGES), each a multiple of 16 bytes and no larger than a
    member's stream (its inverse and at most three floats of its 16-byte
    phase, in whole 16-byte units) cut in as many. The rest of the arrays,
    in order, in the device workspace."""
    check_grid(Nx, Ny)
    levels = n_levels(Nx, Ny)
    nc = (Nx >> (levels - 1)) * (Ny >> (levels - 1))
    stream = _r4(nc * nc + 3)
    limit = smem // 4
    bars, red = 0, 4 * GM1_MAX_STAGES
    ends = red + 4 * (GM1_MAX_THREADS // 32)
    used = ends + 8

    def cut(k):  # a stage of the stream cut in k
        return _r4(-(-stream // k))

    hold = min(ring_min // 4, GM1_MIN_STAGES * cut(GM1_MIN_STAGES))
    ranked, rest = gm1_arrays(Nx, Ny, unit_diag)
    shared, device = {}, {}
    for key, size in ranked:
        # the coarsest level's vectors need only the least ring beside them
        room = 4 * GM1_MIN_STAGES if key[1] == levels - 1 else hold
        if used + size + room <= limit:
            shared[key] = used
            used += size
        else:
            rest.append((key, size))
    left = limit - used
    stages = min(GM1_MAX_STAGES, max(GM1_MIN_STAGES, left // (stage_min // 4)))
    stage = min(left // stages // 4 * 4, cut(stages))
    o = 0
    for key, size in rest:
        device[key] = o
        o += size
    return Gm1Plan(gm1_threads(Nx, Ny), shared, device, bars, red, ends, used, stages, stage,
                   4 * (used + stages * stage), o)


def gm1_table(Nx, Ny, unit_diag=True, plan=None):
    """P-gm1's plan (the grid's `gm1_plan`, or `plan`) as the C entry takes
    it: levels, floats a member, shared bytes, threads, the ring's stages
    and floats a stage, the shared offsets of the ring, its barriers, the
    reduction slots and the inverse's ends, the offsets of x, p, z and A p,
    then per level its LEVEL_KEYS. An array's offset is its float in the workspace, or -1 - its
    float in shared memory; an array the level does not have is 0."""
    plan = plan or gm1_plan(Nx, Ny, unit_diag)
    levels = n_levels(Nx, Ny)

    def where(key):
        if key in plan.shared:
            return -1 - plan.shared[key]
        return plan.device.get(key, 0)

    head = [levels, plan.ws_floats, plan.smem_bytes, plan.threads, plan.stages, plan.stage,
            plan.ring, plan.bars, plan.red, plan.ends] + [where((k, None)) for k in CG_KEYS]
    return head + [v for lvl in range(levels) for v in (
        Nx >> lvl, Ny >> lvl, *(where((k, lvl)) for k in LEVEL_KEYS[2:]))]


# P-gm: a member's blocks at most (the H100's SMs: one block an SM, all
# resident at once), and a block's threads (csrc/pressure_pcg_gm.cu
# `kTilesAThread`, `kMinThreads`, `kMaxThreads`).
GM_MAX_BLOCKS = 132
GM_TILES_A_THREAD, GM_MIN_THREADS, GM_MAX_THREADS = 4, 256, 1024


def gm_bands(Nx, Ny, G):
    """P-gm's band of fine rows on each of G blocks, (first row, rows):
    every level but the coarsest is split, in units of 2**(levels - 1)
    rows; P-cl/d's `cl_bands` over the blocks, the blocks past the units
    holding none."""
    return cl_bands(Nx, Ny, n_levels(Nx, Ny), G, "distributed")


def gm_threads(Nx, Ny, G):
    """Threads of a P-gm block: about one per GM_TILES_A_THREAD fine 2x2
    tiles of its largest band, in the nearest multiple of 128 (the granule
    registers are allocated in), from GM_MIN_THREADS to GM_MAX_THREADS."""
    h = max(rows for _, rows in gm_bands(Nx, Ny, G))
    t = (-(-(h * Ny // 4) // GM_TILES_A_THREAD) + 64) // 128 * 128
    return max(GM_MIN_THREADS, min(GM_MAX_THREADS, t))


def gm_inverse_rows(nc, G, ranks, kb):
    """The rows [start, stop) of the coarsest inverse on each of G blocks:
    `kb` on each of the first `ranks` (the banded blocks), the rest spread
    over the others in blocks of ceil(rest / (G - ranks)); the last ones
    shorter or empty."""
    kn = -(-(nc - ranks * kb) // (G - ranks)) if G > ranks else 0
    starts = [q * kb if q < ranks else ranks * kb + (q - ranks) * kn for q in range(G)]
    sizes = [kb if q < ranks else kn for q in range(G)]
    return [(min(nc, a), min(nc, a + k)) for a, k in zip(starts, sizes)]


def gm_layout(Nx, Ny, levels, G, kb, unit_diag=True):
    """A P-gm block's shared memory in floats (`Geo` in
    csrc/pressure_pcg_gm.cu): (per level a dict of its rows `n` (the largest
    band's, or the coarsest level's all), its columns `m`, whether it is
    `split` and the offsets of LEVEL_KEYS, the offsets of the extra arrays,
    the total). The head holds the coarsest level's right-hand side and
    correction (whole, on every block), the warps' partial sums and the
    bulk copy's barrier; then the split levels, laid out as a P-cl/d rank's
    (`layout` with `cl`), then a banded block's `kb` rows of the inverse
    ("inverse"); a block without a band puts its rows right after the head
    ("inverse_only"). Each block of rows takes four floats more (its
    placement keeps its source's 16-byte alignment). The total is the
    larger of the two kinds of block."""
    lv_cl, _, _ = layout(Nx, Ny, levels, unit_diag, cl=G, place="distributed")
    lc = levels - 1
    nc = (Nx >> lc) * (Ny >> lc)
    ranks = sum(1 for _, h in gm_bands(Nx, Ny, G) if h)
    warps = gm_threads(Nx, Ny, G) // 32
    extra = {"coarse_B": 0, "coarse_X": _r4(nc), "reduction": 2 * _r4(nc)}
    extra["barrier"] = extra["reduction"] + _r4(2 * warps)
    base = extra["barrier"] + 4
    lv = []
    for lvl, d in enumerate(lv_cl):
        d = dict(d)
        if lvl < lc:
            for k in LEVEL_KEYS[2:]:
                d[k] += base
        else:
            d.update(TX=0, TY=0, D=0, RD=0, T=0, B=extra["coarse_B"], X=extra["coarse_X"])
        lv.append(d)
    extra["inverse"] = base + lv_cl[lc]["B"]
    floats = extra["inverse"] + _r4(kb * nc) + 4
    if G > ranks:
        kn = max(b - a for a, b in gm_inverse_rows(nc, G, ranks, kb))
        extra["inverse_only"] = base
        floats = max(floats, base + _r4(kn * nc) + 4)
    return lv, extra, floats


def gm_bytes(Nx, Ny, levels, G, kb, unit_diag=True):
    """Shared memory one P-gm block takes on G blocks with `kb` inverse rows
    a banded block: its `gm_layout`."""
    return 4 * gm_layout(Nx, Ny, levels, G, kb, unit_diag)[2]


def gm_net_floats(Nx, Ny, G):
    """P-gm's exchange in device memory for one group (one member in flight),
    in floats: per block two slots of a band's first and last rows and two
    totals (a float pair each), then the coarse right-hand side and
    correction."""
    levels = n_levels(Nx, Ny)
    nc = (Nx >> (levels - 1)) * (Ny >> (levels - 1))
    return _r4(G * 4 * Ny) + _r4(4 * G) + 2 * _r4(nc)


@functools.lru_cache(maxsize=None)
def gm_plan(Nx, Ny, unit_diag=True):
    """P-gm's plan for a grid: (G, kb), the fewest blocks a member whose every
    block fits one block's shared memory (`_build.SMEM_LIMIT`), and the rows
    of the coarsest inverse on each banded block: ceil(nc / G) where every
    block holds a band, else as many as fit beside the band (at most ceil(nc
    / G)), the rest on the blocks without one (`gm_inverse_rows`). None
    where no G up to GM_MAX_BLOCKS fits (a band of 2**(levels - 1) rows
    wider than a block holds, as at 32x1088) or the grid has no
    hierarchy."""
    levels = n_levels(Nx, Ny)
    if levels < 2:
        return None
    nc = (Nx >> (levels - 1)) * (Ny >> (levels - 1))
    limit = _build.SMEM_LIMIT
    for G in range(1, GM_MAX_BLOCKS + 1):
        ranks = sum(1 for _, h in gm_bands(Nx, Ny, G) if h)
        even = -(-nc // G)
        if G == ranks:
            if gm_bytes(Nx, Ny, levels, G, even, unit_diag) <= limit:
                return G, even
            continue
        # the most rows beside the band, then the rest on the other blocks
        start = gm_layout(Nx, Ny, levels, G, 0, unit_diag)[1]["inverse"]
        kb = min(even, max(0, (limit // 4 - 4 - start) // nc))
        while kb > 0 and start + _r4(kb * nc) + 4 > limit // 4:
            kb -= 1
        if start + 4 <= limit // 4 and gm_bytes(Nx, Ny, levels, G, kb, unit_diag) <= limit:
            return G, kb
    return None


KERNELS = {"jacobi": "pressure_pcg", "cheb": "pressure_pcg_cheb"}  # by smoother
ROUTES = ("smem", "cl", "gm", "gm1")


def kernel_name(smoother, unit_diag=True, route="smem"):
    """The launch counter of P's instantiation for a smoother, fine
    diagonal and route."""
    return KERNELS[smoother] + ("" if unit_diag else "_diag") + (
        "" if route == "smem" else "_" + route)


def check_grid(Nx, Ny):
    """Raise unless kernel P takes an Nx x Ny grid: it needs a multigrid
    hierarchy."""
    if n_levels(Nx, Ny) < 2:
        raise ValueError(f"pressure kernel: a {Nx}x{Ny} grid has no multigrid hierarchy")


# P-cl/d keeps one member on a cluster of 9-16 SMs, 7-9 members in flight
# where P-gm1 keeps 132, and its member's iteration runs faster. Where P-gm1
# won at N=1000 all the same, the largest batch P-cl/d takes, by (Nx, Ny,
# unit_diag); the device-memory route takes larger ones. The scaled 100x100:
# P-cl/d ran 2.5x faster at N=64 and 1.06x at 192, 1.05x slower at 128
# (one wave of P-gm1), 1.20x at 256 and 1.36x at 1000. The scaled 60x220
# layer: P-cl/d 1.25x faster at N=128 and 1.12x at 256, even at 512, 1.08x
# slower at 1000 (bench_routes.py on an H100, the ring-streamed P-gm1;
# PERF.md keeps the figures).
DIST_BATCH_MAX = {(100, 100, True): 192, (60, 220, True): 256}
# P-gm keeps 132 // G members in flight (6 at the scaled 120x440, 14 at
# 100x100) where P-gm1 keeps 132, and its member runs 3x faster at
# 120x440. The largest batch P-gm takes on the device-memory route, by (Nx,
# Ny, unit_diag): the largest batch timed where it beat P-gm1. P-gm1 takes
# larger ones (and any batch not given). The scaled 120x440: P-gm 2.8x
# faster at N=16, 1.10x at 64, 1.18x slower at 96, 1.39x at 1000; unscaled
# 3.0x faster at 16, 1.6x at 96, 1.10x slower at 128, 1.6x at 1000. At the
# scaled 100x100 and 60x220 past DIST_BATCH_MAX P-gm lost to P-gm1 at every
# batch timed (256, 512, 1000; 512, 1000), so none there (bench_routes.py
# on an H100, the ring-streamed P-gm1; PERF.md keeps the figures). A grid
# not listed takes P-gm at any batch where it has a plan.
GM_BATCH_MAX = {(120, 440, True): 64, (120, 440, False): 96, (100, 100, True): 0,
                (60, 220, True): 0}


def route(Nx, Ny, unit_diag=True, batch=None):
    """Which kernel P takes a grid for a launch of `batch` members (None:
    any batch, so past every limit), smallest footprint first: "smem"
    where the layout fits one block's shared memory (`_build.SMEM_LIMIT`),
    "cl" where a cluster's rank does (`cl_plan`), else the device-memory
    route; and the device-memory route where the cluster's plan distributes
    the inverse and the batch exceeds the grid's `DIST_BATCH_MAX`. That
    route is "gm" where `gm_plan` gives a plan and the batch is within the
    grid's `GM_BATCH_MAX`, else "gm1"."""
    check_grid(Nx, Ny)
    if smem_bytes(Nx, Ny, n_levels(Nx, Ny), unit_diag) <= _build.SMEM_LIMIT:
        return "smem"
    plan = cl_plan(Nx, Ny, unit_diag)
    limit = DIST_BATCH_MAX.get((Nx, Ny, unit_diag))
    past = limit is not None and (batch is None or batch > limit)
    if plan is not None and not (plan[1] == "distributed" and past):
        return "cl"
    gm_max = GM_BATCH_MAX.get((Nx, Ny, unit_diag))
    within = gm_max is None or (batch is not None and batch <= gm_max)
    return "gm" if within and gm_plan(Nx, Ny, unit_diag) else "gm1"


def pressure_solve_cuda(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                        restart_every=8, smoother="jacobi", unit_diag=True, force=None,
                        plan=None, inverse_loads=False, probe=False):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device. With `unit_diag` (the contract of
    `models.ressim.scaled_system`) the kernel takes the fine diagonal as 1
    and does not read `hier[0][2]`; without, it reads it. The grid's
    `route` for these B members picks the shared-memory kernel, P-cl or
    P-gm; `force` (one of ROUTES) picks one at any grid it fits, and `plan`
    ((c, place), as `cl_plan` gives it) a cluster for P-cl other than the
    grid's, or (a `Gm1Plan`) a plan for P-gm1 other than the grid's; for
    timing the ring, `inverse_loads` runs P-gm1's control
    (`_build.pressure_gm1_loads_lib`: the inverse read by plain loads).
    Neither P-gm1 choice moves a float of the result. `probe` runs P-cl's
    probe build (`_build.pressure_cl_lib(..., probe=True)`), the same
    kernel counting the cluster barriers member 0 passes."""
    B, Nx, Ny = q.shape
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother must be one of {SMOOTHERS}, got {smoother!r}")
    planned = None if plan is None else "gm1" if isinstance(plan, Gm1Plan) else "cl"
    if force not in (None, *ROUTES) or (plan is not None and force not in (None, planned)):
        raise ValueError(f"force must be one of {ROUTES} or None (the plan's route with a "
                         f"plan), got {force!r}")
    rt = planned or (route(Nx, Ny, unit_diag, B) if force is None else force)
    if inverse_loads and rt != "gm1":
        raise ValueError(f"inverse_loads is P-gm1's, not route {rt!r}'s")
    if probe and rt != "cl":
        raise ValueError(f"probe is P-cl's, not route {rt!r}'s")
    if rt == "cl":
        plan = plan or cl_plan(Nx, Ny, unit_diag)
        if plan is None or plan[1] not in INV_PLACES or not cl_fits(Nx, Ny, *plan, unit_diag):
            raise ValueError(f"pressure kernel: no cluster holds the {Nx}x{Ny} layout"
                             + (f" as {plan}" if plan else ""))
    gplan = gm_plan(Nx, Ny, unit_diag) if rt == "gm" else None
    if rt == "gm" and gplan is None:
        raise ValueError(f"pressure kernel: no plan of P-gm fits the {Nx}x{Ny} layout")
    levels = len(hier)
    if levels != n_levels(Nx, Ny):
        raise ValueError(f"pressure kernel: grid {Nx}x{Ny} takes {n_levels(Nx, Ny)} multigrid "
                         f"levels, got {levels}")
    nc = (Nx >> (levels - 1)) * (Ny >> (levels - 1))
    tensors = {"Ainv": (Ainv, (B, nc, nc)), "q": (q, (B, Nx, Ny)), "p0": (p0, (B, Nx, Ny)),
               "w": (w, (B, Nx, Ny))}
    for lvl, (TX, TY, diag) in enumerate(hier):
        n, m = Nx >> lvl, Ny >> lvl
        tensors.update({f"TX{lvl}": (TX, (B, n - 1, m)), f"TY{lvl}": (TY, (B, n, m - 1)),
                        f"diag{lvl}": (diag, (B, n, m))})
    for name, (t, shape) in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need float32 CUDA {shape}, got "
                             f"{t.dtype} {t.device} {tuple(t.shape)}")
    # Per level TX, TY, diag; a unit fine diagonal is not read and goes as null.
    levels_c = [hier[0][0].contiguous(), hier[0][1].contiguous(),
                None if unit_diag else hier[0][2].contiguous()]
    levels_c += [t.contiguous() for lvl in hier[1:] for t in lvl]
    Ainv, q, p0, w = (t.contiguous() for t in (Ainv, q, p0, w))
    ptrs = (ctypes.c_void_p * len(levels_c))(*[None if t is None else t.data_ptr()
                                               for t in levels_c])
    p = torch.empty_like(q)
    it = torch.empty(B, dtype=torch.int32, device=q.device)
    rel = torch.empty(B, dtype=torch.float32, device=q.device)
    if B == 0:
        return p, it, rel
    patience = max(4, -(-patience_iters // restart_every))
    name = kernel_name(smoother, unit_diag, rt)
    solver = (int(maxiter), int(restart_every), patience, int(smoother == "cheb"),
              int(unit_diag), _build.stream_ptr(q.device))
    common = (ctypes.cast(ptrs, ctypes.c_void_p), Ainv.data_ptr(), q.data_ptr(), p0.data_ptr(),
              w.data_ptr(), p.data_ptr(), it.data_ptr(), rel.data_ptr())
    if rt == "gm":  # the groups' exchange and flags, for as many groups as can be in flight
        G = gplan[0]
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        per_sm = max(1, _build.SMEM_PER_SM // (gm_bytes(Nx, Ny, levels, *gplan, unit_diag) + 1024))
        cap = max(1, min(B, sms * per_sm // G))
        net = torch.empty(cap * gm_net_floats(Nx, Ny, G), dtype=torch.float32, device=q.device)
        flags = torch.zeros(cap * G, dtype=torch.int32, device=q.device)
        code = _build.pressure_gm_lib(Nx, Ny, *gplan).hm_pressure_gm_solve(
            *common, net.data_ptr(), flags.data_ptr(), cap, B, Nx, Ny, levels, float(tol),
            *solver)
    elif rt == "gm1":
        table = gm1_table(Nx, Ny, unit_diag, plan)
        ws = torch.empty(B * table[1], dtype=torch.float32, device=q.device)
        lib = _build.pressure_gm1_loads_lib() if inverse_loads else _build.lib()
        code = lib.hm_pressure_gm1_solve(
            *common, ws.data_ptr(), (ctypes.c_int * len(table))(*table), B, float(tol), *solver)
    elif rt == "cl":
        code = _build.pressure_cl_lib(Nx, Ny, *plan, probe).hm_pressure_cl_solve(
            *common, B, Nx, Ny, levels, float(tol), *solver)
    else:
        code = _build.pressure_lib(Nx, Ny).hm_pressure_solve(*common, B, Nx, Ny, levels,
                                                             float(tol), *solver)
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return p, it, rel


def pressure_solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96, smoother="jacobi",
                   unit_diag=True):
    """Solve every member's TPFA system: the kernel on CUDA, the plain
    version on the CPU."""
    fn = pressure_solve_cuda if q.is_cuda else pressure_solve_torch
    return fn(hier, Ainv, q, p0, w, tol, maxiter, patience_iters, smoother=smoother,
              unit_diag=unit_diag)


REFINE_ITERS = 96  # the refinement pass's iteration cap (pressure_pallas.py:378)


def recook_plan(N, Ny, maxiter, two_pass=True, twopass_j1=64, twopass_div=4):
    """The reference's rule for the straggler recook, from shapes only:
    (Nb, K), the padded batch and the members recooked from it, or None
    where the reference solves in one pass.

    The reference recooks only where it lane-packs P = 128 // Ny members a
    row (Ny <= 64, 128 % Ny == 0; pressure_pallas.py:303-304), pads the
    batch to a multiple of group = 16 P (:309-311), and engages with
    `two_pass`, maxiter > twopass_j1 and at least two groups (:351); it
    recooks K = max(group, (Nb // twopass_div // group) group) members
    (:359). Kept literally, so the port recooks the members the reference
    did at every shape (a 20x20 grid never recooks)."""
    if not (Ny <= 64 and 128 % Ny == 0):
        return None
    group = 16 * (128 // Ny)
    Nb = N + (-N) % group
    if not (two_pass and maxiter > twopass_j1 and Nb >= 2 * group):
        return None
    return Nb, max(group, (Nb // twopass_div // group) * group)


def pressure_solve_recook(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                          two_pass=True, twopass_j1=64, twopass_div=4, refine=True,
                          solve=pressure_solve, smoother="jacobi", unit_diag=True):
    """The reference's three-pass solve (pressure_pallas.py:336-397) around
    `solve` (by default the dispatch above; on either device), every pass
    with the V-cycle smoother `smoother`:

    1. every member with the iteration cap `twopass_j1`;
    2. the K members with the largest pass-1 residual (`recook_plan`; the
       batch padded by modular gather, a stable descending sort, so ties
       go to the lower index as in `lax.top_k`, padded copies dropped)
       again, warm-started from pass 1, with the full `maxiter`;
    3. with `refine`, a compensated residual of those members
       (`stencil_residual_ds`), its correction solved from zero with 96
       iterations on the same hierarchy, and `rel` rescaled to the
       refined iterate's.

    `unit_diag` goes to `solve` (False for the unscaled system).

    Returns (p, iters, rel, recooked): iterations add up over the passes;
    `recooked` (B,) marks the members of passes 2 and 3. Nothing waits for
    the device: the plan comes from shapes, the indices stay on it."""
    B, _, Ny = q.shape
    plan = recook_plan(B, Ny, maxiter, two_pass, twopass_j1, twopass_div)
    if plan is None:
        p, it, rel = solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters, smoother=smoother,
                           unit_diag=unit_diag)
        return p, it, rel, torch.zeros(B, dtype=torch.bool, device=q.device)
    Nb, K = plan
    p1, it1, rel1 = solve(hier, Ainv, q, p0, w, tol, twopass_j1, patience_iters,
                          smoother=smoother, unit_diag=unit_diag)
    pad = torch.arange(Nb, device=q.device) % B
    top = torch.sort(rel1[pad], descending=True, stable=True).indices[:K]
    idx = pad[top]
    take = lambda t: t[idx]  # noqa: E731
    hier_k = [tuple(take(t) for t in lvl) for lvl in hier]
    Ainv_k, q_k, w_k = take(Ainv), take(q), take(w)
    p2, it2, rel2 = solve(hier_k, Ainv_k, q_k, take(p1), w_k, tol, maxiter, patience_iters,
                          smoother=smoother, unit_diag=unit_diag)
    if refine:
        r_ds = stencil_residual_ds(*hier_k[0], p2, q_k)
        d3, it3, rel3 = solve(hier_k, Ainv_k, r_ds, torch.zeros_like(r_ds), w_k, tol,
                              REFINE_ITERS, patience_iters, smoother=smoother,
                              unit_diag=unit_diag)
        p2 = p2 + d3
        it2 = it2 + it3
        num = (w_k * r_ds).reshape(K, -1).norm(dim=1)
        den = (w_k * q_k).reshape(K, -1).norm(dim=1).clamp_min(torch.finfo(q.dtype).tiny)
        rel2 = rel3 * num / den
    # Picks of padded copies (top >= B) write to a spare last slot; their
    # member is picked at its own index too (equal rel, lower index first).
    dst = torch.where(top < B, idx, B)
    extend = lambda t: torch.cat([t, t[:1]])  # noqa: E731
    p = extend(p1).index_copy_(0, dst, p2)[:B]
    it = extend(it1).index_add_(0, dst, it2)[:B]
    rel = extend(rel1).index_copy_(0, dst, rel2)[:B]
    recooked = torch.zeros(B + 1, dtype=torch.bool, device=q.device).index_fill_(0, dst, True)
    return p, it, rel, recooked[:B]
