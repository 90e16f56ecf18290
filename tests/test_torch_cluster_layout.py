"""What the CPU can check of the cluster variants P-cl and K-cl: the
cluster each grid takes, a rank's layout (`ops/pressure.layout` with
`cl`), the row bands of the split levels and the levels gathered whole on
every rank, the coarsest inverse's place (P-cl/d: its rows distributed
over the ranks), K-cl's bands and strips, the routes that follow (by batch
where P-cl/d lost at N=1000), and the wrappers' refusal of CPU tensors.
The kernels run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import pytest
import torch

from historymatching_tpu_torch.ops import pressure, transport
from historymatching_tpu_torch.ops._build import GRIDS, SMEM_LIMIT, SMEM_TWO_A_SM
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, n_levels
from historymatching_tpu_torch.ops.pressure import (
    CLUSTERS,
    DIST_BATCH_MAX,
    DIST_CLUSTERS,
    cl_bands,
    cl_bytes,
    cl_fits,
    cl_inverse_rows,
    cl_plan,
    cl_split,
    cl_threads,
    layout,
    pressure_solve_cuda,
)
from historymatching_tpu_torch.ops.transport import transport_substeps_cuda

# The grids past one block's shared memory (P) or one band (K), with the
# cluster each kernel takes: (P-cl's c, split levels, the inverse's place),
# K-cl's (c, strip) or None. The grids of equal bands keep their plans.
CL_GRIDS = {
    (60, 60): ((2, 1, "device"), None),
    (80, 80): ((2, 3, "shared"), (2, 4)),
    (88, 88): ((4, 1, "device"), (2, 4)),
    (96, 96): ((4, 3, "shared"), (8, 12)),
    (100, 100): ((9, 2, "distributed"), (4, 4)),
    (128, 128): ((8, 3, "shared"), (8, 16)),
    (60, 220): ((15, 2, "distributed"), (4, 15)),
    (192, 192): ((8, 3, "shared"), (16, 12)),
    (256, 256): ((16, 4, "shared"), (16, 16)),
}
# P-cl/d's grids: scaled and unscaled, the plan (c, bytes a rank) and each
# rank's fine rows.
DIST_GRIDS = {
    (100, 100, True): (9, 217_936, [12] * 7 + [8] * 2),
    (100, 100, False): (9, 229_136, [12] * 7 + [8] * 2),
    (60, 220, True): (15, 225_488, [4] * 15),
    (60, 220, False): (16, 226_160, [4] * 15 + [0]),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", list(CL_GRIDS))
def test_pressure_cluster_plan_fits(Nx, Ny, unit_diag):
    """P-cl's cluster is the smallest power of two up to 16 that splits the
    fine level in equal bands and whose rank leaves room for two blocks an
    SM, the inverse shared or else in device memory; else the smallest
    whose rank fits one block's shared memory with the inverse shared;
    else the smallest cluster of up to 16 whose rank fits one block with
    the inverse distributed (100x100, 60x220)."""
    levels = n_levels(Nx, Ny)
    c, place = cl_plan(Nx, Ny, unit_diag)
    if unit_diag:
        assert (c, cl_split(Nx, Ny, levels, c, place), place) == CL_GRIDS[(Nx, Ny)][0]
    sizes = [s for s in CLUSTERS if cl_split(Nx, Ny, levels, s)]
    two = [(s, pl) for s in sizes for pl in ("shared", "device")
           if cl_fits(Nx, Ny, s, pl, unit_diag, SMEM_TWO_A_SM)]
    one = [(s, "shared") for s in sizes if cl_fits(Nx, Ny, s, "shared", unit_diag)]
    dist = [(s, "distributed") for s in DIST_CLUSTERS if cl_fits(Nx, Ny, s, "distributed",
                                                                 unit_diag)]
    assert (c, place) == (two or one or dist)[0]
    assert cl_bytes(Nx, Ny, levels, c, unit_diag, place) <= (
        SMEM_TWO_A_SM if two else SMEM_LIMIT)
    if place == "distributed":
        assert c == DIST_GRIDS[(Nx, Ny, unit_diag)][0]
        assert cl_plan(Nx, Ny, unit_diag, place) == (c, place)


@pytest.mark.parametrize("Nx,Ny", list(CL_GRIDS))
def test_pressure_cluster_bands_cover_the_levels(Nx, Ny):
    """Every split level's rows are the ranks' bands, each row in exactly
    one band, each band an even number of rows (2x2 tiles and the
    restriction stay inside a rank), a coarse band half its finer one; the
    levels below are whole on every rank: the first level of <= 256 cells
    or of an odd band, and every coarser one."""
    levels = n_levels(Nx, Ny)
    c, place = cl_plan(Nx, Ny)
    lv, extra, floats = layout(Nx, Ny, levels, cl=c, place=place)
    ls = cl_split(Nx, Ny, levels, c, place)
    assert 1 <= ls < levels
    bands = cl_bands(Nx, Ny, levels, c, place)
    for lvl, d in enumerate(lv):
        n, m = Nx >> lvl, Ny >> lvl
        assert d["m"] == m and d["split"] == (lvl < ls)
        if d["split"]:
            rows = [range(f >> lvl, (f + h) >> lvl) for f, h in bands]
            assert all(len(b) % 2 == 0 for b in rows)
            assert [i for b in rows for i in b] == list(range(n))
            assert d["n"] == max(len(b) for b in rows) >= 2
            if place != "distributed":
                assert all(len(b) * c == n for b in rows)
            if lvl > 0:
                assert 2 * d["n"] == lv[lvl - 1]["n"]
        else:
            assert d["n"] == n
    first_n = Nx >> ls
    assert (first_n * (Ny >> ls) <= 256 or first_n % (2 * c) or ls == levels - 1)
    assert ("inverse" in extra) == (place != "device")
    nc = lv[-1]["n"] * lv[-1]["m"]
    if place == "shared":
        assert extra["reduction"] - extra["inverse"] >= nc * nc
    assert floats - extra["reduction"] == 4 * (cl_threads(Nx, Ny, c, place) // 32 + c)


@pytest.mark.parametrize("Nx,Ny,place", [(60, 220, "distributed"), (100, 100, "distributed"),
                                         (60, 60, "device"), (88, 88, "device"),
                                         (128, 128, "shared"), (96, 96, "shared"),
                                         (256, 256, "shared")])
def test_pressure_cluster_inverse_place(Nx, Ny, place):
    """The coarsest inverse of 60x220 (825^2 floats, 2.7 MB) and 100x100
    (625^2, 1.56 MB) is distributed over the ranks' shared memory; 60x60's
    (225^2) is read in place from device memory, and 88x88's (121^2), whose
    rank then fits two blocks an SM; 4x4's and 3x3's sit in every rank's
    shared memory. Where the coarse product's rows are split over
    the ranks (read in place or distributed), eight warps a rank or more."""
    c, got = cl_plan(Nx, Ny)
    assert got == place
    assert cl_threads(Nx, Ny, c, place) >= (128 if place == "shared" else 256)


@pytest.mark.parametrize("Nx,Ny,unit_diag", [
    (Nx, Ny, unit) for Nx, Ny in [(60, 60), (96, 96), (100, 100), (128, 128), (60, 220),
                                  (256, 256)]
    for unit in (True, False)])
def test_pressure_cluster_layout_arrays_fit_and_do_not_overlap(Nx, Ny, unit_diag):
    """A rank's arrays, a split level's with their halo rows, lie inside
    its floats, 4-aligned (the kernel loads float pairs), and no two
    overlap, except that a coarse level's temporary lives inside the fine
    one while they all fit there; a distributed inverse's block (with 3
    floats of slack for its alignment) and its copy's barrier too."""
    levels = n_levels(Nx, Ny)
    c, place = cl_plan(Nx, Ny, unit_diag)
    lv, extra, floats = layout(Nx, Ny, levels, unit_diag, cl=c, place=place)
    lc = levels - 1
    spans = []
    for lvl, d in enumerate(lv):
        h, m = d["n"], d["m"]
        keys = ("B", "X") if lvl == lc else (
            ("TX", "TY", "X", "B", "T") + (() if lvl == 0 and unit_diag else ("D", "RD")))
        for k in keys:
            size = (h + 2) * m if d["split"] else (h - 1) * m if k == "TX" else h * m
            spans.append(((k, lvl), d[k], d[k] + size))
    nc = lv[lc]["n"] * lv[lc]["m"]
    if place == "shared":
        spans.append((("inverse", None), extra["inverse"], extra["inverse"] + nc * nc))
    if place == "distributed":
        start, stop = cl_inverse_rows(nc, c)[0]
        spans.append((("inverse", None), extra["inverse"],
                      extra["inverse"] + 3 + (stop - start) * nc))
        spans.append((("barrier", None), extra["barrier"], extra["barrier"] + 2))
    spans.append((("reduction", None), extra["reduction"], floats))
    assert all(o % 4 == 0 and 0 <= o < e <= floats for _, o, e in spans)
    fine_t = next((o, e) for k, o, e in spans if k == ("T", 0))
    own = sorted((o, e, k) for k, o, e in spans
                 if not (k[0] == "T" and k[1] > 0 and fine_t[0] <= o and e <= fine_t[1]))
    assert all(e1 <= o2 for (_, e1, _), (o2, _, _) in zip(own, own[1:])), own
    assert 4 * floats == cl_bytes(Nx, Ny, levels, c, unit_diag, place) <= SMEM_LIMIT


@pytest.mark.parametrize("Nx,Ny", list(CL_GRIDS))
def test_transport_cluster_bands_and_strips(Nx, Ny):
    """K-cl's cluster: a power of two up to 16 whose equal bands (Nx / c
    rows) hold at most 4,096 cells, in strips (the last may hold fewer
    rows) of one column a thread, at most 1,024 threads a rank: two ranks
    in strips of 4 where two hold the grid
    (80x80, 88x88), else one strip a band where a band has at most 16 rows,
    else strips of 4 (100x100); grids of up to 4,096 cells keep the
    runtime-grid variant (60x60)."""
    plan = transport.cl_plan(Nx, Ny)
    if Nx * Ny <= transport.BAND_CELLS:
        assert transport.route(Nx, Ny) == "rt"
        return
    assert (plan.c, plan.strip) == CL_GRIDS[(Nx, Ny)][1] and transport.route(Nx, Ny) == "cl"
    c, strip = plan.c, plan.strip
    h = Nx // c
    assert Nx % c == 0 and h * Ny <= transport.BAND_CELLS
    assert -(-h // strip) * Ny <= 1024 and c & (c - 1) == 0 and 2 <= c <= 16
    two = Nx % 2 == 0 and Nx // 2 * Ny <= transport.BAND_CELLS
    assert (c == 2 and strip == 4) if two else (strip == h or h > transport.MAX_STRIP)


# K's route at K-cl's grids by batch: where two ranks hold the grid (80x80,
# 88x88) K-cl up to one wave of its clusters (SMS / 2 = 66 members), K-rt
# past it; elsewhere K-cl at every batch.
@pytest.mark.parametrize("batch", [None, 1, 64, 66, 67, 128, 256, 1000])
@pytest.mark.parametrize("Nx,Ny", [g for g in CL_GRIDS if g != (60, 60)])
def test_transport_route_takes_the_batch_past_a_wave_of_two_ranks(Nx, Ny, batch):
    """K-rt takes a two-rank K-cl grid's batch past one wave of clusters;
    K-cl keeps every other batch and grid."""
    two = transport.cl_plan(Nx, Ny).c == 2
    assert two == ((Nx, Ny) in ((80, 80), (88, 88)))
    past = two and (batch or 1) > transport.SMS // 2
    assert transport.route(Nx, Ny, batch) == ("rt" if past else "cl")
    assert not past or transport.rt_plan(Nx, Ny) is not None


# P's route past one block, by grid, fine diagonal and batch: P-cl on
# every grid a cluster holds; at the scaled 100x100 P-cl/d only up to 192
# members and at the scaled 60x220 up to 256, the device-memory route past
# them (and for a batch not given): P-gm1, which beat P-gm there.
P_GM_PAST = {(100, 100, True): 192, (60, 220, True): 256}


@pytest.mark.parametrize("batch", [None, 64, 192, 193, 256, 257, 1000])
@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", [g for g in CL_GRIDS if g != (80, 80)])
def test_pressure_route_past_one_block(Nx, Ny, unit_diag, batch):
    """P takes P-cl past one block's shared memory wherever a cluster holds
    the layout; where the plan distributes the inverse and the
    device-memory route won at N=1000 (the scaled 100x100 and 60x220),
    only up to the batch where P-cl/d still won (`DIST_BATCH_MAX`), P-gm1
    beyond it (P-gm has a plan there but lost to P-gm1 at every batch
    timed: `GM_BATCH_MAX`)."""
    plan = cl_plan(Nx, Ny, unit_diag)
    limit = P_GM_PAST.get((Nx, Ny, unit_diag))
    expect = "gm1" if limit is not None and (batch is None or batch > limit) else "cl"
    assert pressure.route(Nx, Ny, unit_diag, batch) == expect
    assert DIST_BATCH_MAX == P_GM_PAST and (limit is None or plan[1] == "distributed")


# The plans (c, place, bytes a rank) on the grids of equal bands, scaled
# and unscaled, as they were before the inverse could be distributed; the
# rule that adds P-cl/d leaves them so. Where the inverse is read in place
# (60x60, the scaled 88x88) a rank runs 8 warps, not 4: 64 bytes more of
# their reduction slots.
EQUAL_BAND_PLANS = {
    (60, 60): ((2, "device", 61_872), (2, "device", 77_232)),
    (88, 88): ((4, "device", 103_184), (2, "shared", 209_952)),
    (96, 96): ((4, "shared", 75_472), (4, "shared", 95_440)),
    (128, 128): ((8, "shared", 74_976), (8, "shared", 93_408)),
    (192, 192): ((8, "shared", 159_984), (8, "shared", 199_920)),
    (256, 256): ((16, "shared", 144_288), (16, "shared", 181_152)),
}


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", list(EQUAL_BAND_PLANS))
def test_pressure_equal_band_plans_unchanged(Nx, Ny, unit_diag):
    """Every grid that a cluster of equal bands held keeps its plan, its
    split and its bytes a rank."""
    c, place, nbytes = EQUAL_BAND_PLANS[(Nx, Ny)][0 if unit_diag else 1]
    levels = n_levels(Nx, Ny)
    assert cl_plan(Nx, Ny, unit_diag) == (c, place)
    assert cl_bytes(Nx, Ny, levels, c, unit_diag, place) == nbytes
    assert [h for _, h in cl_bands(Nx, Ny, levels, c, place)] == [Nx // c] * c


@pytest.mark.parametrize("Nx,Ny,unit_diag", list(DIST_GRIDS))
def test_pressure_dist_bands_cover_every_row_once(Nx, Ny, unit_diag):
    """P-cl/d's bands, scaled and unscaled: on every level but the
    coarsest, the ranks' bands cover every row once, in order, each an
    even count (a rank past the rows holds none), the largest first."""
    c, nbytes, rows = DIST_GRIDS[(Nx, Ny, unit_diag)]
    levels = n_levels(Nx, Ny)
    bands = cl_bands(Nx, Ny, levels, c, "distributed")
    assert [h for _, h in bands] == rows
    assert cl_split(Nx, Ny, levels, c, "distributed") == levels - 1
    for lvl in range(levels - 1):
        cover = [i for f, h in bands for i in range(f >> lvl, (f + h) >> lvl)]
        assert cover == list(range(Nx >> lvl))
        assert all((h >> lvl) % 2 == 0 for _, h in bands)


@pytest.mark.parametrize("Nx,Ny,unit_diag", list(DIST_GRIDS))
def test_pressure_dist_inverse_rows_partition(Nx, Ny, unit_diag):
    """The ranks' blocks of the coarsest inverse's rows partition 0..nc-1 in
    order, none longer than the block every rank's layout holds."""
    c = DIST_GRIDS[(Nx, Ny, unit_diag)][0]
    levels = n_levels(Nx, Ny)
    nc = (Nx >> (levels - 1)) * (Ny >> (levels - 1))
    blocks = cl_inverse_rows(nc, c)
    assert len(blocks) == c and [i for a, b in blocks for i in range(a, b)] == list(range(nc))
    assert max(b - a for a, b in blocks) == blocks[0][1] == -(-nc // c)


@pytest.mark.parametrize("Nx,Ny,unit_diag", list(DIST_GRIDS))
def test_pressure_dist_rank_fits_one_block(Nx, Ny, unit_diag):
    """A P-cl/d rank's bytes (bands, halos, the coarsest level, its block of
    the inverse, the copy's barrier and the reduction slots) fit one
    block's shared memory but leave no room for a second on its SM; one
    rank fewer does not fit."""
    c, nbytes, _ = DIST_GRIDS[(Nx, Ny, unit_diag)]
    levels = n_levels(Nx, Ny)
    assert cl_bytes(Nx, Ny, levels, c, unit_diag, "distributed") == nbytes
    assert SMEM_TWO_A_SM < nbytes <= SMEM_LIMIT
    assert not cl_fits(Nx, Ny, c - 1, "distributed", unit_diag)
    assert cl_threads(Nx, Ny, c, "distributed") == 256


def test_routes_of_the_main_grids_unchanged():
    """The flagship and the other instantiated grids keep their kernels:
    P in shared memory, K templated; 80x80's P still fits one block, its K
    (6,400 cells) takes K-cl."""
    for Nx, Ny in GRIDS:
        assert pressure.route(Nx, Ny) == pressure.route(Nx, Ny, False) == "smem"
        assert transport.route(Nx, Ny) == "templated"
    assert pressure.route(80, 80) == "smem" and transport.route(80, 80) == "cl"
    assert pressure.kernel_name("cheb", False, "cl") == "pressure_pcg_cheb_diag_cl"
    assert transport.NAMES["cl"] == "transport_upwind_cl"


def _p_args(Nx, Ny):
    z = torch.zeros(2, Nx, Ny)
    hier = build_hierarchy_5pt(torch.zeros(2, Nx - 1, Ny), torch.zeros(2, Nx, Ny - 1), z)
    nc = hier[-1][2][0].numel()
    return (hier, torch.zeros(2, nc, nc), z, z, z)


def _k_args(Nx, Ny):
    z = torch.zeros(2, Nx, Ny)
    return (z, torch.zeros(2, Nx + 1, Ny), torch.zeros(2, Nx, Ny + 1), z, torch.ones(2),
            torch.ones(2, dtype=torch.int32), (1.0, 1.0, 0.0, 0.0))


@pytest.mark.parametrize("force", [None, "cl", "gm", "gm1"])
@pytest.mark.parametrize("Nx,Ny", [(128, 128), (60, 220)])
def test_wrappers_refuse_cpu_tensors_on_every_route(Nx, Ny, force):
    """On the cluster route, and forced to it or to the device-memory
    variants (K: K-gm and K-gm1), the wrappers get past their route to the
    CPU tensors' refusal: nothing falls back to the plain version."""
    if force != "gm1":  # K's alone
        with pytest.raises(ValueError, match="need float32 CUDA"):
            pressure_solve_cuda(*_p_args(Nx, Ny), tol=1e-3, maxiter=8, force=force)
    with pytest.raises(ValueError, match="need float32 CUDA"):
        transport_substeps_cuda(*_k_args(Nx, Ny), force=force)


def test_cluster_route_refused_where_no_cluster_holds_the_grid():
    """P-cl forced where no cluster's rank fits (a 60x220 layer refined 2x2,
    120x440, either system), or on a plan that does not fit, and K-cl
    forced where no band fits (171 rows), raise before any launch; P-gm and
    K-gm take them. P-cl's probe build is P-cl's alone."""
    args = _p_args(120, 440)
    for unit in (True, False):
        with pytest.raises(ValueError, match="no cluster"):
            pressure_solve_cuda(*args, tol=1e-3, maxiter=8, unit_diag=unit, force="cl")
        with pytest.raises(ValueError, match="need float32 CUDA"):
            pressure_solve_cuda(*args, tol=1e-3, maxiter=8, unit_diag=unit, force="gm")
    with pytest.raises(ValueError, match="no cluster"):
        pressure_solve_cuda(*_p_args(100, 100), tol=1e-3, maxiter=8, plan=(8, "distributed"))
    with pytest.raises(ValueError, match="probe is P-cl's"):
        pressure_solve_cuda(*_p_args(128, 128), tol=1e-3, maxiter=8, force="gm", probe=True)
    with pytest.raises(ValueError, match="need float32 CUDA"):
        pressure_solve_cuda(*_p_args(128, 128), tol=1e-3, maxiter=8, probe=True)
    with pytest.raises(ValueError, match="force must be"):
        pressure_solve_cuda(*_p_args(100, 100), tol=1e-3, maxiter=8, plan=(9, "distributed"),
                            force="gm")
    with pytest.raises(ValueError, match="no cluster"):
        transport_substeps_cuda(*_k_args(171, 171), force="cl")
    with pytest.raises(ValueError, match="need float32 CUDA"):
        transport_substeps_cuda(*_k_args(171, 171), force="gm")
