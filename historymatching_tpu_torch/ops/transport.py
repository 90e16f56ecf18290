"""Kernel K: all CFL substeps of one outer transport step, for every member.

Replaces the TPU kernels of `historymatching_tpu/ops/transport_pallas.py`
(`transport_substeps_pallas`, `_batched`, `_packed`): on the card each
member loops over its own substep count (`csrc/transport_upwind.cu`).
`route` says which body a grid takes:
- "templated": the strip body (one block a member, column strips of 4
  cells a thread) in the main library, at the grids of `_build.GRIDS`;
- "rt" (K-rt): the same body compiled for any other grid whose strips
  fit one block (`rt_plan`: strips of S rows, the faces in registers or
  in shared memory), one library a grid, built on first use, but where
  K-rt1 ran faster (`RT1_CELLS`, `RT1_BATCH_CELLS`);
- "cl" (K-cl): a thread-block cluster a member, each block a band of rows
  whose edge rows of fw it pushes into its neighbours' shared memory
  every substep (`cl_plan`), past 4,096 cells where a cluster takes the
  grid;
- "rt1" (K-rt1): the tile body (`rt1_plan`) with a member in one block,
  where the two fw tiles fit one block but no strip plan of one column a
  thread does, and on small grids at small batches, where a member runs
  on its own block of warps, one cell a thread;
- "gm" (K-gm): a member over co-resident blocks, each a band of rows in
  strips of S rows and W columns a thread (`gm_plan`), the bands' edge rows
  exchanged through L2, for the grids left;
- "gm1" (K-gm1): past K-gm's capacity, the tile body over co-resident
  blocks, a member in 2-D tiles whose edge rows and columns go through L2
  (`gm1_plan`); past the tiles' capacity, and at large batches where one
  block a member runs faster, its device-memory body (`GM1Device`).
Beside it, `transport_substeps_torch` is the plain PyTorch version; it runs
the batch to its largest count and freezes each member after its own, which
gives the same per-member result.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel, which raises on what it does not take.
"""

from __future__ import annotations

from collections import namedtuple
from functools import lru_cache

import torch
import torch.nn.functional as F

from historymatching_tpu_torch.ops import _build


ROUTES = ("templated", "rt", "rt1", "cl", "gm", "gm1")
NAMES = {"templated": "transport_upwind", "rt": "transport_upwind_rt",
         "rt1": "transport_upwind_rt1", "cl": "transport_upwind_cl",
         "gm": "transport_upwind_gm", "gm1": "transport_upwind_gm1"}  # launch counters by route
BAND_CELLS = 4096  # a K-cl rank's band at most: the templated 64x64 block's load
# K-cl's plan: c ranks a member (one of CL_CLUSTERS), strips of `strip`
# rows. CL_MAX_RANKS: ranks an SM a plan asks for at most; an H100 SM's
# shared bytes, those the runtime reserves a block, and its SMs.
ClPlan = namedtuple("ClPlan", "c strip")
CL_CLUSTERS, CL_MAX_RANKS = (2, 4, 8, 16), 4
SM_SHARED, BLOCK_RESERVED, SMS = 233_472, 1024, 132
# Where two ranks hold a grid (two bands of at most BAND_CELLS), K-cl runs
# strips of 4 rows, and a batch past one wave of its clusters (SMS / 2
# members) takes K-rt: on the H100 (bench_routes.py, N = 64 / 128 / 256 /
# 1000) K-cl on (2, 4) took 0.328-0.365 / 0.617 / 1.203 / 4.744-4.773 ms at
# 80x80 (K-rt 0.609-0.612 / 0.604 / 1.187 / 4.742-4.762) and 0.474-0.478 /
# 0.936 / 1.808 / 7.057-7.144 at 88x88 (K-rt 0.746 / 0.742 / 1.462 /
# 5.838); one strip a band there ran 0.463-0.565 and 0.565-0.655 at N=64.
# K-cl's registers a thread, 12 S + 14 by its strip's rows S, from what
# ptxas reported on the H100 (CUDA 12.9), none spilling: 63 at S = 4 under
# a cap of 64 (71-76 under more), 77-80 at S = 5, 110 at S = 8, 122 at S =
# 10, 133-134 at S = 11, 145-151 at S = 12, 177 at S = 15, 188-189 at S =
# 16. (The faces held in shared memory instead, as K-rt's SHARED plans
# hold them, took 40-56 registers at S = 4 but ran 1.13-1.15x slower at
# [24]'s first step; they went.)
CL_REGS = (12, 14)
# K-rt1 keeps a grid of up to RT1_CELLS cells (one cell a thread there)
# while the batch holds up to RT1_BATCH_CELLS cells: such a launch is
# bound by its chain of substeps, where one cell a thread runs faster
# than K-rt's strips of 4 cells. On the H100 (bench_routes.py --kernel k1,
# the card's time alone, N = 64 / 128 / 256 / 1000) K-rt1 ran 3.73 / 3.79
# / 3.86 / 6.76 us at 12x12 (K-rt 4.29 / 4.34 / 4.41 / 6.71), 3.34 / 3.37
# / 3.50 / 4.86 at 10x10 (4.85 / 4.90 / 4.90 / 5.50), 4.23 / 4.34 / 4.66
# / 10.36 at 15x15 (7.50 / 7.71 / 7.72 / 9.30), 5.40 / 5.50 / 7.02 /
# 19.54 at 24x16 (9.73 / 9.86 / 11.40 / 21.18), 3.51 / 3.57 / 3.71 /
# 5.25 at 12x9 (3.51 / 3.56 / 3.62 / 4.60) and 11.83 / 11.99 / 21.80 /
# 80.94 at 28x28 (14.69 / 14.80 / 22.53 / 74.11): up to 102,400 cells a
# batch K-rt1 wins or ties (within 2.5%: 12x9 N=256), past it K-rt wins or
# ties but at 28x28 N=256 and 24x16 N=1000 (K-rt1 3% and 8% faster).
RT1_CELLS, RT1_BATCH_CELLS = 1024, 102_400
# Threads a block at most, and the rows of a strip (csrc `kStrip`,
# `kMaxStrip`): the templated K's, and the range K-rt and K-gm plan in.
MAX_THREADS, MIN_STRIP, MAX_STRIP = 1024, 4, 16
# K-gm: rows of its first plan's strip (csrc `kStrip`), threads a block at
# most (`kGmThreads`), and bands a member at most: the H100's SMs, so that
# one member's blocks, one an SM, are resident at once.
GM_STRIP, GM_THREADS, GM_MAX_BANDS = 4, 1024, SMS
# Registers a thread needs, by the cells it holds, from what ptxas reported
# on the H100 (`reg_budget` is what a block's thread count leaves a
# thread): the strip body, a model by its strip's rows S with the faces in
# registers (11 S + 12: 55 at S = 4, 64 at S = 5) or in shared memory
# (3 S + 24: at most 71 at S = 11); K-gm, by its strip's (rows, columns a
# thread), the least register cap under which it built without spilling
# (53-61 at 1,024 threads for 4-6 cells, 72 for (8, 1), 80 for (5, 2), 95
# for (4, 3), 121-127 for 15-16 cells; (12, 1) and (16, 1) spilled at 128
# and 168): a plan takes only these shapes.
RT_REGS = {"registers": (11, 12), "shared": (3, 24)}
GM_SHAPES = {(4, 1): 64, (5, 1): 64, (6, 1): 64, (4, 2): 64, (8, 1): 72, (5, 2): 80,
             (4, 3): 96, (5, 3): 128, (6, 2): 128, (4, 4): 128, (8, 2): 128}


def reg_budget(threads):
    """Registers a thread may take in a block of `threads` threads that one
    SM holds: its 65,536 registers over the block's warps, allocated four
    at a time, in steps of 8, at most 255 (ptxas's cap under
    `__launch_bounds__(threads, 1)`)."""
    warps = -(-threads // 128) * 4
    return min(255, 65536 // (32 * warps) // 8 * 8)


def smem_bytes(Nx, Ny):
    """Shared memory the templated K and K-rt with their faces in registers
    take for one member, and the floor of a one-block tile plan of K-rt1:
    two fw tiles of the grid."""
    return 2 * 4 * Nx * Ny


def check_grid(Nx, Ny):
    """Raise unless kernel K takes an Nx x Ny grid: any grid with a cell,
    through one of its routes."""
    if Nx < 1 or Ny < 1:
        raise ValueError(f"transport kernel: a {Nx}x{Ny} grid has no cells")


def rt_threads(Nx, Ny, strip):
    """The strip body's threads a member: strips of `strip` rows (the last
    may hold fewer), one column a thread."""
    return -(-Nx // strip) * Ny


def rt_bytes(Nx, Ny, strip, place):
    """The strip body's shared bytes a member: two fw tiles, and with the
    faces in "shared" memory each thread's 4 `strip` + 1 faces and
    sources."""
    slots = 4 * strip + 1 if place == "shared" else 0
    return 4 * (2 * Nx * Ny + slots * rt_threads(Nx, Ny, strip))


def rt_plan(Nx, Ny):
    """K-rt's plan for a grid: (strip, place), the smallest strip from
    MIN_STRIP (or Nx, where fewer) up to MAX_STRIP whose threads one block
    holds (at most MAX_THREADS) without spilling, with the faces and
    sources in "registers" where `RT_REGS` fits `reg_budget`, else in
    "shared" memory where the bytes fit `_build.SMEM_LIMIT`; None where no
    strip fits (a row wider than a block, or past ~9,500 cells)."""
    check_grid(Nx, Ny)
    for strip in range(min(MIN_STRIP, Nx), MAX_STRIP + 1):
        threads = rt_threads(Nx, Ny, strip)
        if threads > MAX_THREADS:
            continue
        for place in ("registers", "shared"):
            a, c = RT_REGS[place]
            if (a * strip + c <= reg_budget(threads)
                    and rt_bytes(Nx, Ny, strip, place) <= _build.SMEM_LIMIT):
                return strip, place
    return None


def cl_threads(Nx, Ny, c, strip):
    """K-cl's threads a rank: the band's strips of `strip` rows (the last
    may hold fewer), one column a thread."""
    return -(-(Nx // c) // strip) * Ny


def cl_bytes(Nx, Ny, plan):
    """K-cl's shared bytes a rank (csrc `KClGeo::BYTES`): two mbarriers,
    four halo slots (two parities, the fw row from above and from below)
    and two fw tiles of the band."""
    return 4 * (4 + 4 * Ny + 2 * (Nx // plan.c) * Ny)


def cl_ranks(Nx, Ny, plan):
    """The ranks of `plan` one SM holds by its threads, its registers (the
    `CL_REGS` model, allocated 8 at a time for each warp) and its shared
    bytes (`SM_SHARED`, and `BLOCK_RESERVED` a block), at most
    `CL_MAX_RANKS`; 0 where the registers do not fit one rank."""
    c, strip = plan
    threads = cl_threads(Nx, Ny, c, strip)
    a, b = CL_REGS
    regs = -(-(a * strip + b) // 8) * 8
    by_regs = 65536 // (32 * -(-threads // 32) * regs) if regs <= 255 else 0
    by_bytes = SM_SHARED // (cl_bytes(Nx, Ny, plan) + BLOCK_RESERVED)
    return min(by_regs, by_bytes, 2048 // threads, CL_MAX_RANKS)


@lru_cache(maxsize=None)
def cl_plans(Nx, Ny):
    """Every plan K-cl takes for a grid, a tuple of ClPlan(c, strip): c
    ranks of CL_CLUSTERS that split Nx in equal bands of at most BAND_CELLS
    cells, strips of `strip` rows from MIN_STRIP (or the band's rows, where
    fewer) to MAX_STRIP; at most MAX_THREADS threads and `_build.SMEM_LIMIT`
    bytes a rank, and one rank an SM at least (`cl_ranks`)."""
    plans = []
    for c in CL_CLUSTERS:
        h = Nx // c
        if Nx % c or h * Ny > BAND_CELLS:
            continue
        for strip in range(min(MIN_STRIP, h), min(MAX_STRIP, h) + 1):
            plan = ClPlan(c, strip)
            if (cl_threads(Nx, Ny, c, strip) <= MAX_THREADS and cl_ranks(Nx, Ny, plan)
                    and cl_bytes(Nx, Ny, plan) <= _build.SMEM_LIMIT):
                plans.append(plan)
    return tuple(plans)


def cl_strips(Nx, plan):
    """K-cl's strips a band on `plan`: its rows over the strip's, rounded up."""
    return -(-(Nx // plan.c) // plan.strip)


@lru_cache(maxsize=None)
def cl_plan(Nx, Ny):
    """K-cl's plan for a grid (`cl_plans`): where two ranks hold the grid,
    two ranks in strips of MIN_STRIP rows; else one strip a band (a thread a column of
    the band, where a band has at most MAX_STRIP rows) with the most
    members an SM (`cl_ranks` over the ranks a member), then the fewest
    ranks; else the fewest ranks, then the shortest strip. None where no
    cluster takes the grid. On the H100 at N=1000 (bench_routes.py --kernel
    kcl) one strip a band ran 1.07-1.43x faster than strips of 4 rows at
    96x96, 128x128, 60x220, 192x192 and 256x256, and 1.07-1.42x at N=64:
    taller strips hold the i-neighbours' fw in registers and a member's
    cells in fewer registers, so more members fit an SM. Where two ranks
    hold the grid, strips of 4 rows on two ranks ran 1.2-1.7x faster at
    N=64 (a substep's chain of 4 cells a thread, not 10-11) and within 2%
    at N=1000 at 80x80 (`route` gives larger batches K-rt)."""
    plans = cl_plans(Nx, Ny)
    if not plans:
        return None
    two = [p for p in plans if p.c == 2]
    one = [p for p in plans if cl_strips(Nx, p) == 1]
    if one and not two:
        return min(one, key=lambda p: (-cl_ranks(Nx, Ny, p) / p.c, p.c))
    return min(plans, key=lambda p: (p.c, p.strip))


def gm_slots(strip, cols):
    """A K-gm thread's faces and sources in shared memory: its columns' strip
    + 1 faces along i, its rows' cols + 1 faces along j, its cells'
    sources (csrc `GmSlots`)."""
    return cols * (strip + 1) + strip * (cols + 1) + strip * cols


def gm_threads(Ny, rows, strip=GM_STRIP, cols=1):
    """K-gm's threads a block for a band of `rows` rows: its strips times
    its column groups."""
    return -(-rows // strip) * -(-Ny // cols)


def gm_bytes(Ny, rows, strip=GM_STRIP, cols=1):
    """K-gm's shared bytes a block for a band of `rows` rows: two fw tiles
    of the band, and each thread's `gm_slots`."""
    return 4 * (2 * rows * Ny + gm_slots(strip, cols) * gm_threads(Ny, rows, strip, cols))


def gm_fits(Ny, rows, strip=GM_STRIP, cols=1):
    """Whether one block holds a band of `rows` rows: its threads, its
    bytes, and the registers its strip shape needs (`GM_SHAPES`)."""
    threads = gm_threads(Ny, rows, strip, cols)
    return (threads <= GM_THREADS and gm_bytes(Ny, rows, strip, cols) <= _build.SMEM_LIMIT
            and GM_SHAPES.get((strip, cols), 256) <= reg_budget(threads))


def gm_bands(Nx, Ny, strip=GM_STRIP, cols=1):
    """K-gm's bands of a member in strips of `strip` rows and `cols`
    columns a thread: [(first row, rows)] of the G bands, G the fewest
    whose largest band (ceil(Nx / G) rows) one block holds (`gm_fits`), the
    first Nx mod G bands one row more. None where no band of `strip` rows
    (or of every row, where fewer) fits, or past GM_MAX_BANDS bands, or
    for a shape not in `GM_SHAPES`."""
    check_grid(Nx, Ny)
    if (strip, cols) not in GM_SHAPES:
        return None
    rows = min(Nx, strip * (GM_THREADS // -(-Ny // cols)))
    while rows >= min(strip, Nx) and not gm_fits(Ny, rows, strip, cols):
        rows -= 1
    if rows < min(strip, Nx) or -(-Nx // rows) > GM_MAX_BANDS:
        return None
    G = -(-Nx // rows)
    h, rem = divmod(Nx, G)
    sizes = [h + 1] * rem + [h] * (G - rem)
    return [(sum(sizes[:r]), sizes[r]) for r in range(G)]


def gm_plan(Nx, Ny):
    """K-gm's plan for a grid: (bands, strip, cols), of the strip shapes of
    `GM_SHAPES` whose `gm_bands` exist, the fewest cells a thread (strip x
    cols), then the fewest bands, then the fewest columns; so where strips
    of GM_STRIP rows and one column fit, that first plan. None past
    K-gm's capacity."""
    for cells in sorted({a * b for a, b in GM_SHAPES}):
        plans = [(bands, strip, cols) for strip, cols in GM_SHAPES if strip * cols == cells
                 for bands in [gm_bands(Nx, Ny, strip, cols)] if bands]
        if plans:
            return min(plans, key=lambda p: (len(p[0]), p[2]))
    return None


# K-rt1 and K-gm1 run the tile body (csrc `transport_upwind_tile_kernel`,
# one library a strip shape, face placement, tiling and thread bound,
# built on first use: `_build.transport_tile_lib`). Its plan: a member in
# gr x gc tiles (rows and columns split as `gm_bands` splits rows, the
# first ones one more), strips of `strip` rows and `cols` columns a thread,
# the faces and sources held in "registers" (split once) or in "shared"
# memory slots (K-gm's `gm_slots`), blocks of `threads` threads.
TilePlan = namedtuple("TilePlan", "gr gc strip cols faces threads")
TILE_FACES = ("registers", "shared")  # csrc kFacesRegs, kFacesSlots
# Registers a thread needs by strip shape: a register cap of those tried
# (64, 72, 80, 96, 128: 1,024, 896, 768, 640 and 512 threads) under which
# the tile body builds without spilling (ptxas on the H100, CUDA 12.9;
# bench_routes.py --kernel tileregs reads every shape at every cap, and a
# card test builds each entry at its cap): one tile a member with the
# faces in "registers" or in "shared" memory, and several ("tiles",
# K-gm1's, faces in shared memory; its edge logic costs 32-64 registers
# more than one tile's). A plan takes only these shapes: tiles of 8x1 and
# 5x2 spill under 128.
TILE_SHAPES = {
    "registers": {(1, 1): 64, (2, 1): 64, (4, 1): 128},
    "shared": {(4, 1): 80, (5, 1): 80, (6, 1): 96, (4, 2): 80, (5, 2): 96, (4, 3): 96,
               (5, 3): 128, (6, 2): 128, (4, 4): 128, (8, 1): 128, (8, 2): 128},
    "tiles": {(4, 1): 128, (5, 1): 128, (6, 1): 128},
}
# A small grid's member (up to RT1_CELLS cells) on its own block: one cell
# a thread (strips of RT1_STRIP rows), the faces split once into
# registers, the threads rounded to whole warps. On the H100
# (bench_routes.py --kernel k1, the card's time alone, at 12x12, 10x10,
# 15x15, 24x16 and 12x9): one cell a thread ran 3.15-5.26 us a launch at
# N=64 against strips of 2 rows' 3.98-7.67 and the first form's
# 3.25-6.66, and 4.74-19.32 at N=1000 against the first form's
# 5.08-30.92. Two or four members a block, each on its own named barrier,
# ran 3-67% slower than one at every grid and batch measured, and went.
RT1_STRIP = 1


def tile_threads(rows, width, strip, cols):
    """The tile body's threads a tile of rows x width: its strips times its
    column groups."""
    return -(-rows // strip) * -(-width // cols)


def tile_bytes(rows, width, strip, cols, faces, threads=None):
    """The tile body's shared bytes a block: two fw tiles of rows x width,
    and with the faces in "shared" memory each thread's `gm_slots`."""
    t = threads or tile_threads(rows, width, strip, cols)
    return 4 * (2 * rows * width + (gm_slots(strip, cols) * t if faces == "shared" else 0))


def tile_fits(rows, width, strip, cols, faces, threads=None, tiled=False):
    """Whether one block holds a tile of rows x width on a strip shape of
    `TILE_SHAPES` (under "tiles" where `tiled`): its threads, its bytes and
    its registers."""
    regs = TILE_SHAPES["tiles" if tiled else faces].get((strip, cols))
    t = threads or tile_threads(rows, width, strip, cols)
    return (regs is not None and t <= MAX_THREADS and regs <= reg_budget(t)
            and tile_bytes(rows, width, strip, cols, faces, threads) <= _build.SMEM_LIMIT)


def tile_dims(Nx, Ny, plan):
    """The largest tile of a plan: (rows, columns)."""
    return -(-Nx // plan.gr), -(-Ny // plan.gc)


@lru_cache(maxsize=None)
def rt1_plan(Nx, Ny):
    """K-rt1's plan for a grid, a TilePlan of one tile a member. A grid of
    up to RT1_CELLS cells: strips of RT1_STRIP rows, one column a thread,
    the faces in registers, the member's threads rounded to whole warps. A
    larger grid: the faces in "shared" memory, on the strip shape of the
    fewest cells a thread, then the fewest columns, that fits
    (`tile_fits`); None where none fits (past ~8,000 cells)."""
    check_grid(Nx, Ny)
    if Nx * Ny <= RT1_CELLS:
        strip = min(RT1_STRIP, Nx)
        threads = -(-tile_threads(Nx, Ny, strip, 1) // 32) * 32
        return TilePlan(1, 1, strip, 1, "registers", threads)
    for strip, cols in sorted(TILE_SHAPES["shared"], key=lambda sc: (sc[0] * sc[1], sc[1])):
        if tile_fits(Nx, Ny, strip, cols, "shared"):
            return TilePlan(1, 1, strip, cols, "shared", tile_threads(Nx, Ny, strip, cols))
    return None


def _widest(rows, Ny, strip, cols):
    """The most columns of a tile of `rows` rows that one block holds on a
    strip shape with the faces in shared memory (`tile_fits`), 0 where
    none."""
    width = min(Ny, cols * (MAX_THREADS // -(-rows // strip)))
    while width > 0 and not tile_fits(rows, width, strip, cols, "shared", tiled=True):
        width -= 1
    return width


@lru_cache(maxsize=None)
def gm1_plan(Nx, Ny):
    """K-gm1's tile plan for a grid: a TilePlan of gr x gc tiles a member,
    one block a tile, the faces in shared memory, at most GM_MAX_BANDS tiles
    (so one member's blocks, one an SM, are resident at once), on the strip
    shapes of `TILE_SHAPES["tiles"]`: a strip that divides the largest
    tile's rows where one does (no short last strip), then, as `gm_plan`,
    the fewest cells a thread, then the fewest tiles, then the fewest
    columns a thread, then the shortest edges (a tile's rows and columns).
    On the H100 (bench_routes.py --kernel k1) 5x6000's tiles of 5 rows ran
    3.50-3.55 / 20.5-20.6 / 312 ms at N=4 / 64 / 1000 on strips of 5
    against strips of 4's (and a strip of 1 row) 3.72-3.81 / 29.1-29.8 /
    443-447. None past the tiles' capacity (~0.9-1.08 M cells), where
    K-gm1 runs its device-memory body."""
    check_grid(Nx, Ny)
    plans = [p for p in (_gm1_shape_plan(Nx, Ny, *sc) for sc in TILE_SHAPES["tiles"]) if p]
    return min(plans)[1] if plans else None


def _gm1_shape_plan(Nx, Ny, strip, cols):
    """`gm1_plan`'s plan on one strip shape, the fewest tiles, then the
    shortest edges, with the key `gm1_plan` ranks it by; None where the
    shape takes no plan."""
    best = None
    for gr in range(1, min(Nx, GM_MAX_BANDS) + 1):
        rows = -(-Nx // gr)
        width = _widest(rows, Ny, strip, cols)
        gc = -(-Ny // width) if width else 0
        if width and gr * gc <= GM_MAX_BANDS and (
                best is None or (gr * gc, rows + -(-Ny // gc)) < best[0]):
            best = (gr * gc, rows + -(-Ny // gc)), gr, gc, rows
    if best is None:
        return None
    (tiles, edges), gr, gc, rows = best
    key = (rows % strip > 0, strip * cols, tiles, cols, edges)
    return key, TilePlan(gr, gc, strip, cols, "shared",
                         tile_threads(rows, -(-Ny // gc), strip, cols))


def route(Nx, Ny, batch=None):
    """Which kernel K takes a grid of a batch of `batch` members (not
    given: a small batch): "templated" at `_build.GRIDS`; "cl" past
    BAND_CELLS cells where a cluster takes it (`cl_plan`), but "rt" where
    the cluster has two ranks, the batch fills more than one wave of them
    (SMS / 2 members) and `rt_plan` gives a plan; where the two
    fw tiles fit one block's shared memory (`_build.SMEM_LIMIT`) "rt1" on
    up to RT1_CELLS cells while the batch holds up to RT1_BATCH_CELLS,
    else "rt" where `rt_plan` gives a plan, else "rt1" where `rt1_plan`
    gives one; past that "gm" where `gm_plan` gives a plan and "gm1" past
    it."""
    check_grid(Nx, Ny)
    if (Nx, Ny) in _build.GRIDS:
        return "templated"
    plan = cl_plan(Nx, Ny) if Nx * Ny > BAND_CELLS else None
    if plan:
        two = plan.c == 2 and (batch or 1) > SMS // 2
        return "rt" if two and rt_plan(Nx, Ny) else "cl"
    if smem_bytes(Nx, Ny) <= _build.SMEM_LIMIT:
        small = Nx * Ny <= RT1_CELLS and (batch or 1) * Nx * Ny <= RT1_BATCH_CELLS
        if not small and rt_plan(Nx, Ny):
            return "rt"
        if rt1_plan(Nx, Ny):
            return "rt1"
    return "gm" if gm_plan(Nx, Ny) else "gm1"


def transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid):
    """Plain version. s (B, Nx, Ny); Fx (B, Nx+1, Ny); Fy (B, Nx, Ny+1);
    q (B or 1, Nx, Ny); dts_pv (B,) substep length over pore volume;
    n_sub (B,) int; fluid (vw, vo, swc, sor)."""
    vw, vo, swc, sor = fluid
    XP, XN = Fx.clamp_min(0.0), Fx.clamp_max(0.0)
    YP, YN = Fy.clamp_min(0.0), Fy.clamp_max(0.0)
    fi, fp = q.clamp_min(0.0), q.clamp_max(0.0)
    dts_pv = dts_pv[:, None, None]

    def substep(s):
        S = (s - swc) / (1.0 - swc - sor)
        Mw = S * S / vw
        Mo = (1.0 - S) * (1.0 - S) / vo
        fw = Mw / (Mw + Mo)
        Fw_x = XP * F.pad(fw, (0, 0, 1, 0)) + XN * F.pad(fw, (0, 0, 0, 1))
        Fw_y = YP * F.pad(fw, (1, 0)) + YN * F.pad(fw, (0, 1))
        div = (Fw_x[..., 1:, :] - Fw_x[..., :-1, :]) + (Fw_y[..., :, 1:] - Fw_y[..., :, :-1])
        s_new = s + dts_pv * (fi + fp * fw - div)
        return torch.clamp(s_new, swc, 1.0 - sor)

    n_max = int(n_sub.max()) if n_sub.numel() else 0
    for k in range(n_max):
        s = torch.where((k < n_sub)[:, None, None], substep(s), s)
    return s


# K-gm1's device-memory body (csrc `transport_upwind_gm1_kernel`): `per`
# blocks a member, each a run of its cells in row-major order, s and fw in
# device memory, a barrier of the member's blocks a substep; per = 0
# (DEVICE): every block the card holds at once on one member at a time.
# On the H100 (bench_routes.py --kernel k1) at 1090x1090 one member at a
# time ran 172.1 / 2757.8 ms at N=4 / 64 against 321.0 / 5451.5 with the
# card's 132 blocks spread over the batch (33 / 2 a member) and the first
# form's (one block a member) 6404.5 / 8814.7.
GM1Device = namedtuple("GM1Device", "per")
DEVICE = GM1Device(0)
# K-gm1 takes one block a member (GM1Device(1)) where its tiles hold
# fewer than GM1_TILE_CELLS cells in flight (their members in flight, SMS
# over the tiles a member, times a member's cells) and the batch reaches
# those cells over GM1_WAVE_CELLS: one block's substep on the H100 took
# ~0.75 ns a cell (22.5-30.3 us at 29,056-40,000 cells), a wave of tiles'
# ~3.1-4.1 us, so it pays from about that many waves, and past the card's
# blocks the tiles keep up only with that many cells in flight. On the H100
# (bench_routes.py --kernel k1, N = 4 / 16 / 32 / 48 / 64 / 128 / 256 /
# 1000) the tiles ran 5.85 / 17.72 / 35.02 / 46.37 / 63.29 / 125.50 /
# 245.41 / 948.28 ms at 8x5000 (240,000 cells in flight; one block a
# member 45.49 / 45.22 / 45.83 / 49.17 / 59.57 / 95.07 / 189.16 /
# 736.25), 4.92 / 14.89 / 24.80 / 34.74 / 48.55 / 93.53 / 182.35 / 701.52
# at 16x2056 (230,272; 30.24 / 30.50 / 30.82 / 31.79 / 45.27 / 61.53 /
# 121.84 / 473.45) and 4.42 / 8.68 / 17.47 / 26.30 / 34.45 / 69.15 /
# 137.48 / 535.32 at 8x3632 (232,448; 23.33 / 23.16 / 23.62 / 23.79 /
# 26.15 / 45.03 / 89.65 / 350.19): GM1_WAVE_CELLS from 4,843 to 4,999
# splits them; at 5x6000 (330,000 cells in flight) the tiles won at
# every batch, 3.50 / 20.63 / 41.36 / 81.81 / 308.38 at N = 4 / 64 / 128
# / 256 / 1000 against 25.30 / 28.87 / 59.96 / 120.03 / 467.61.
GM1_TILE_CELLS, GM1_WAVE_CELLS = 280_000, 4_900


def gm1_groups(plan, B, resident):
    """K-gm1's device-memory launch on `plan` for a batch of B members when
    the card holds `resident` of its blocks at once: (blocks a member,
    members in flight)."""
    per = plan.per or resident
    return per, max(1, min(B, resident // per))


def gm1_route_plan(Nx, Ny, batch=None):
    """K-gm1's plan for a grid and batch: `gm1_plan`'s tiles, but one block
    a member (GM1Device(1)) where the tiles hold fewer than GM1_TILE_CELLS
    cells in flight and the batch holds at least those cells over
    GM1_WAVE_CELLS members; DEVICE past the tiles' capacity."""
    tiles = gm1_plan(Nx, Ny)
    if tiles is None:
        return DEVICE
    flight = max(1, SMS // (tiles.gr * tiles.gc)) * Nx * Ny
    block = flight < GM1_TILE_CELLS and (batch or 1) * GM1_WAVE_CELLS >= flight
    return GM1Device(1) if block else tiles


def _plan(rt, Nx, Ny, B, plan):
    """The plan a launch of route `rt` for B members runs: `plan` where
    given and the route takes it (K-cl: one of `cl_plans`; K-rt1: a
    TilePlan of one tile a member that `tile_fits`; K-gm1: a TilePlan whose
    tiles fit, or a GM1Device), else the route's own (K-gm1's by the batch,
    `gm1_route_plan`); () for the routes without one."""
    if plan is None and rt == "gm1":
        return gm1_route_plan(Nx, Ny, B)
    if plan is None:
        plan = {"rt": rt_plan, "cl": cl_plan, "gm": gm_plan,
                "rt1": rt1_plan}.get(rt, lambda Nx, Ny: ())(Nx, Ny)
        if plan is None:
            what = {"rt": "no strip plan of K-rt", "cl": "no cluster",
                    "gm": "no band plan of K-gm", "rt1": "no tile plan of K-rt1"}
            raise ValueError(f"transport kernel: {what[rt]} takes a {Nx}x{Ny} grid")
        return plan
    if rt == "cl" and ClPlan(*plan) in cl_plans(Nx, Ny):
        return ClPlan(*plan)
    if rt == "gm1" and isinstance(plan, GM1Device) and int(plan.per) >= 0:
        return plan
    if (rt in ("rt1", "gm1") and not isinstance(plan, GM1Device)
            and len(plan) == len(TilePlan._fields)):
        p = TilePlan(*plan)
        rows, width = tile_dims(Nx, Ny, p)
        if (p.faces in TILE_FACES and (p.gr * p.gc == 1 or rt == "gm1")
                and p.gr <= Nx and p.gc <= Ny
                and p.threads >= tile_threads(rows, width, p.strip, p.cols)
                and tile_fits(rows, width, p.strip, p.cols, p.faces, p.threads, rt == "gm1")):
            return p
    raise ValueError(f"transport kernel: {plan} is no plan of {rt} at {Nx}x{Ny}")


def transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, force=None, plan=None):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device; a `q` with one member is read by every member in place.
    The grid's `route` picks the body; `force` (one of `ROUTES`) picks one
    at any grid (the templated kernel only at `_build.GRIDS`, K-rt where
    `rt_plan`, K-cl where `cl_plan`, K-gm where `gm_plan` and K-rt1 where
    `rt1_plan` give a plan; K-gm1 at any); `plan` another plan of K-cl (one
    of `cl_plans`), K-rt1 or K-gm1 (a TilePlan, or a GM1Device for K-gm1)."""
    B, Nx, Ny = s.shape
    if force not in (None, *ROUTES):
        raise ValueError(f"force must be one of {ROUTES} or None, got {force!r}")
    rt = route(Nx, Ny, B) if force is None else force
    plan = _plan(rt, Nx, Ny, B, plan)
    shapes = {"s": (s, (B, Nx, Ny)), "Fx": (Fx, (B, Nx + 1, Ny)),
              "Fy": (Fy, (B, Nx, Ny + 1)), "q": (q, (1 if q.shape[0] == 1 else B, Nx, Ny)),
              "dts_pv": (dts_pv, (B,))}
    for name, (t, shape) in shapes.items():
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need float32 CUDA {shape}, got "
                             f"{t.dtype} {t.device} {tuple(t.shape)}")
    if not n_sub.is_cuda or n_sub.dtype != torch.int32 or tuple(n_sub.shape) != (B,):
        raise ValueError("n_sub: need int32 CUDA (B,)")
    s, Fx, Fy, q, dts_pv, n_sub = (t.contiguous() for t in (s, Fx, Fy, q, dts_pv, n_sub))
    out = torch.empty_like(s)
    if B == 0:
        return out
    vw, vo, swc, sor = (float(v) for v in fluid)
    q_stride = 0 if q.shape[0] == 1 else Nx * Ny
    args = (s.data_ptr(), Fx.data_ptr(), Fy.data_ptr(), q.data_ptr(), q_stride,
            dts_pv.data_ptr(), n_sub.data_ptr(), out.data_ptr())
    tail = (B, Nx, Ny, vw, vo, swc, sor, _build.stream_ptr(s.device))
    if rt == "gm":  # each band's edge rows in two slots, and the substeps it published
        bands, strip, cols = plan
        G = len(bands)
        threads = gm_threads(Ny, max(h for _, h in bands), strip, cols)
        halo = torch.empty(B * G * 4 * Ny, dtype=torch.float32, device=s.device)
        flags = torch.zeros(B * G, dtype=torch.int32, device=s.device)
        code = _build.transport_gm_lib(strip, cols, threads).hm_transport_substeps_gm(
            *args, halo.data_ptr(), flags.data_ptr(), B, Nx, Ny, G, *tail[3:])
    elif isinstance(plan, GM1Device):  # a group's two fw tiles, and its barriers passed
        per, groups = gm1_groups(plan, B, _build.gm1_resident(s.device))
        ws = torch.empty(groups * 2 * Nx * Ny, dtype=torch.float32, device=s.device)
        count = torch.zeros(groups, dtype=torch.int32, device=s.device)
        code = _build.lib().hm_transport_substeps_gm1(*args, ws.data_ptr(), count.data_ptr(),
                                                      B, Nx, Ny, per, groups, *tail[3:])
    elif rt == "gm1":  # each tile's edges in two slots, and the substeps it published
        P = plan.gr * plan.gc
        halo = torch.empty(B * P * 4 * sum(tile_dims(Nx, Ny, plan)), dtype=torch.float32,
                           device=s.device)
        flags = torch.zeros(B * P, dtype=torch.int32, device=s.device)
        code = _build.transport_tile_lib(plan, True).hm_transport_substeps_tile(
            *args, halo.data_ptr(), flags.data_ptr(), B, Nx, Ny, plan.gr, plan.gc, plan.threads,
            *tail[3:])
    elif rt == "rt1":  # one tile a member: no halo, no flags
        code = _build.transport_tile_lib(plan, False).hm_transport_substeps_tile(
            *args, None, None, B, Nx, Ny, 1, 1, plan.threads, *tail[3:])
    elif rt == "cl":
        code = _build.transport_cl_lib(Nx, Ny, plan).hm_transport_substeps_cl(*args, *tail)
    elif rt == "rt":
        code = _build.transport_rt_lib(Nx, Ny, *plan).hm_transport_substeps_rt(*args, *tail)
    else:
        code = _build.lib().hm_transport_substeps(*args, *tail)
    _build.check(code, NAMES[rt])
    _build.LAUNCHES[NAMES[rt]] += 1
    return out


def transport_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid):
    """Run every member's `n_sub` substeps: the kernel on CUDA, the plain
    version on the CPU. Leading dims of `s` are flattened to one member axis."""
    lead = s.shape[:-2]
    Nx, Ny = s.shape[-2:]
    args = (s.reshape(-1, Nx, Ny), Fx.reshape(-1, Nx + 1, Ny), Fy.reshape(-1, Nx, Ny + 1),
            q.reshape(-1, Nx, Ny), dts_pv.reshape(-1), n_sub.reshape(-1))
    fn = transport_substeps_cuda if s.is_cuda else transport_substeps_torch
    return fn(*args, fluid).reshape(*lead, Nx, Ny)
