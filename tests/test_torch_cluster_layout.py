"""What the CPU can check of the cluster variants P-cl and K-cl: the
cluster each grid takes, a rank's layout (`ops/pressure.layout` with
`cl`), the row bands of the split levels and the levels gathered on the
first rank, the coarsest inverse's place, K-cl's bands and strips, the
routes that follow, and the wrappers' refusal of CPU tensors. The kernels
run only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import pytest
import torch

from historymatching_tpu_torch.ops import pressure, transport
from historymatching_tpu_torch.ops._build import GRIDS, SMEM_LIMIT, SMEM_TWO_A_SM
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, n_levels
from historymatching_tpu_torch.ops.pressure import (
    CLUSTERS,
    cl_bytes,
    cl_plan,
    cl_split,
    cl_threads,
    layout,
    pressure_solve_cuda,
)
from historymatching_tpu_torch.ops.transport import transport_substeps_cuda

# The grids past one block's shared memory (P) or one band (K), with the
# cluster each kernel takes: (P-cl's c, split levels, inverse in shared
# memory), K-cl's (c, strip) or None.
CL_GRIDS = {
    (60, 60): ((2, 1, False), None),
    (80, 80): ((2, 3, True), (2, 4)),
    (88, 88): ((4, 1, False), (2, 4)),
    (96, 96): ((4, 3, True), (4, 4)),
    (100, 100): ((2, 1, False), (4, 5)),
    (128, 128): ((8, 3, True), (4, 4)),
    (60, 220): ((2, 1, False), (4, 5)),
    (192, 192): ((8, 3, True), (16, 4)),
    (256, 256): ((16, 4, True), (16, 4)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", list(CL_GRIDS))
def test_pressure_cluster_plan_fits(Nx, Ny, unit_diag):
    """P-cl's cluster is the smallest power of two up to 16 that splits the
    fine level and whose rank leaves room for two blocks an SM, else the
    smallest whose rank fits one block's shared memory; at that size the
    coarsest inverse sits beside the bands where it fits. The unscaled
    system's rank at 60x220 (its fine diagonal and reciprocal beside the
    band) fits none."""
    levels = n_levels(Nx, Ny)
    plan = cl_plan(Nx, Ny, unit_diag)
    sizes = [c for c in CLUSTERS if cl_split(Nx, Ny, levels, c)]
    fit = lambda c, limit: min(cl_bytes(Nx, Ny, levels, c, unit_diag, inv)  # noqa: E731
                               for inv in (True, False)) <= limit
    if (Nx, Ny) == (60, 220) and not unit_diag:
        assert plan is None and not any(fit(c, SMEM_LIMIT) for c in sizes)
        return
    c, inv = plan
    if unit_diag:
        assert (c, cl_split(Nx, Ny, levels, c), inv) == CL_GRIDS[(Nx, Ny)][0]
    assert c in sizes and c & (c - 1) == 0 and c <= 16
    limit = SMEM_TWO_A_SM if any(fit(s, SMEM_TWO_A_SM) for s in sizes) else SMEM_LIMIT
    assert cl_bytes(Nx, Ny, levels, c, unit_diag, inv) <= limit
    assert not any(fit(s, limit) for s in sizes if s < c)
    if not inv:
        assert cl_bytes(Nx, Ny, levels, c, unit_diag, True) > limit


@pytest.mark.parametrize("Nx,Ny", list(CL_GRIDS))
def test_pressure_cluster_bands_cover_the_levels(Nx, Ny):
    """Every split level's rows are the ranks' bands, each row in exactly
    one band, each band an even number of rows (2x2 tiles and the
    restriction stay inside a rank), a coarse band half its finer one; the
    levels below are whole on the first rank: the first level of <= 256
    cells or of an odd band, and every coarser one."""
    levels = n_levels(Nx, Ny)
    c, inv = cl_plan(Nx, Ny)
    lv, extra, floats = layout(Nx, Ny, levels, cl=c, inv_smem=inv)
    ls = cl_split(Nx, Ny, levels, c)
    assert 1 <= ls < levels
    for lvl, d in enumerate(lv):
        n, m = Nx >> lvl, Ny >> lvl
        assert d["m"] == m and d["split"] == (lvl < ls)
        if d["split"]:
            h = d["n"]
            assert h * c == n and h % 2 == 0 and h >= 2
            bands = [range(r * h, (r + 1) * h) for r in range(c)]
            assert sorted(i for b in bands for i in b) == list(range(n))
            if lvl > 0:
                assert 2 * h == lv[lvl - 1]["n"]
        else:
            assert d["n"] == n
    first_n = Nx >> ls
    assert (first_n * (Ny >> ls) <= 256 or first_n % (2 * c) or ls == levels - 1)
    assert ("inverse" in extra) == inv
    nc = lv[-1]["n"] * lv[-1]["m"]
    if inv:
        assert extra["reduction"] - extra["inverse"] >= nc * nc
    assert floats - extra["reduction"] == 4 * (cl_threads(Nx, Ny, c) // 32 + c)


@pytest.mark.parametrize("Nx,Ny,place", [(60, 220, "device"), (100, 100, "device"),
                                         (60, 60, "device"), (88, 88, "device"),
                                         (128, 128, "shared"), (96, 96, "shared"),
                                         (256, 256, "shared")])
def test_pressure_cluster_inverse_place(Nx, Ny, place):
    """The coarsest inverse of 60x220 (825^2 floats, 2.7 MB), 100x100 (625^2)
    and 60x60 (225^2) is read in place from device memory, and 88x88's
    (121^2), whose rank then fits two blocks an SM; 4x4's and 3x3's sit in
    the first rank's shared memory."""
    assert cl_plan(Nx, Ny)[1] == (place == "shared")


@pytest.mark.parametrize("Nx,Ny,unit_diag", [
    (Nx, Ny, unit) for Nx, Ny in [(60, 60), (96, 96), (100, 100), (128, 128), (60, 220),
                                  (256, 256)]
    for unit in (True, False) if (Nx, Ny, unit) != (60, 220, False)])
def test_pressure_cluster_layout_arrays_fit_and_do_not_overlap(Nx, Ny, unit_diag):
    """A rank's arrays, a split level's with their halo rows, lie inside
    its floats, 4-aligned (the kernel loads float pairs), and no two
    overlap, except that a coarse level's temporary lives inside the fine
    one while they all fit there (the unscaled 60x220 system has no
    cluster: it takes P-gm)."""
    levels = n_levels(Nx, Ny)
    c, inv = cl_plan(Nx, Ny, unit_diag)
    lv, extra, floats = layout(Nx, Ny, levels, unit_diag, cl=c, inv_smem=inv)
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
    if inv:
        spans.append((("inverse", None), extra["inverse"], extra["inverse"] + nc * nc))
    spans.append((("reduction", None), extra["reduction"], floats))
    assert all(o % 4 == 0 and 0 <= o < e <= floats for _, o, e in spans)
    fine_t = next((o, e) for k, o, e in spans if k == ("T", 0))
    own = sorted((o, e, k) for k, o, e in spans
                 if not (k[0] == "T" and k[1] > 0 and fine_t[0] <= o and e <= fine_t[1]))
    assert all(e1 <= o2 for (_, e1, _), (o2, _, _) in zip(own, own[1:])), own
    assert 4 * floats == cl_bytes(Nx, Ny, levels, c, unit_diag, inv) <= SMEM_LIMIT


@pytest.mark.parametrize("Nx,Ny", list(CL_GRIDS))
def test_transport_cluster_bands_and_strips(Nx, Ny):
    """K-cl's cluster: the smallest power of two whose bands (Nx / c rows)
    hold at most 4,096 cells, the band's rows tiled by strips, at most 1,024
    threads a rank; grids of up to 4,096 cells keep the runtime-grid
    variant (60x60)."""
    shape = transport.cl_shape(Nx, Ny)
    if Nx * Ny <= transport.BAND_CELLS:
        assert transport.route(Nx, Ny) == "rt"
        return
    assert shape == CL_GRIDS[(Nx, Ny)][1] and transport.route(Nx, Ny) == "cl"
    c, strip = shape
    h = Nx // c
    assert Nx % c == 0 and h * Ny <= transport.BAND_CELLS and h % strip == 0
    assert h // strip * Ny <= 1024 and c & (c - 1) == 0 and c <= 16
    assert all(Nx % s or (Nx // s) * Ny > transport.BAND_CELLS for s in (2, 4, 8, 16) if s < c)


# P's route past one block, by grid: P-gm where the rank would take a
# whole SM and read the coarsest inverse from device memory (both fine
# diagonals at 100x100, the scaled 60x220), or where no cluster holds the
# layout (the unscaled 60x220).
P_GM_GRIDS = {(100, 100), (60, 220)}


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("Nx,Ny", [g for g in CL_GRIDS if g != (80, 80)])
def test_pressure_route_past_one_block(Nx, Ny, unit_diag):
    """P takes P-cl past one block's shared memory unless its rank would
    hold a whole SM (more than `SMEM_TWO_A_SM` bytes) with the coarsest
    inverse read from device memory; there, and where no cluster holds the
    layout, P-gm."""
    levels = n_levels(Nx, Ny)
    plan = cl_plan(Nx, Ny, unit_diag)
    expect = "gm" if (Nx, Ny) in P_GM_GRIDS else "cl"
    assert pressure.route(Nx, Ny, unit_diag) == expect
    if expect == "gm" and plan is not None:
        c, inv = plan
        assert not inv and cl_bytes(Nx, Ny, levels, c, unit_diag, inv) > SMEM_TWO_A_SM
    if expect == "cl":
        c, inv = plan
        assert inv or cl_bytes(Nx, Ny, levels, c, unit_diag, inv) <= SMEM_TWO_A_SM


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


@pytest.mark.parametrize("force", [None, "cl", "gm"])
@pytest.mark.parametrize("Nx,Ny", [(128, 128), (60, 220)])
def test_wrappers_refuse_cpu_tensors_on_every_route(Nx, Ny, force):
    """On the cluster route, and forced to it or to the device-memory
    variants, the wrappers get past their route to the CPU tensors'
    refusal: nothing falls back to the plain version."""
    with pytest.raises(ValueError, match="need float32 CUDA"):
        pressure_solve_cuda(*_p_args(Nx, Ny), tol=1e-3, maxiter=8, force=force)
    with pytest.raises(ValueError, match="need float32 CUDA"):
        transport_substeps_cuda(*_k_args(Nx, Ny), force=force)


def test_cluster_route_refused_where_no_cluster_holds_the_grid():
    """P-cl forced where no cluster's rank fits (the unscaled 60x220
    system), and K-cl forced where no band fits (171 rows), raise before
    any launch; P-gm and K-gm take them."""
    args = _p_args(60, 220)
    with pytest.raises(ValueError, match="no cluster"):
        pressure_solve_cuda(*args, tol=1e-3, maxiter=8, unit_diag=False, force="cl")
    with pytest.raises(ValueError, match="need float32 CUDA"):
        pressure_solve_cuda(*args, tol=1e-3, maxiter=8, unit_diag=False, force="gm")
    with pytest.raises(ValueError, match="no cluster"):
        transport_substeps_cuda(*_k_args(171, 171), force="cl")
    with pytest.raises(ValueError, match="need float32 CUDA"):
        transport_substeps_cuda(*_k_args(171, 171), force="gm")
