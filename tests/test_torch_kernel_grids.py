"""What the CPU can check of the hand kernels' contract: the grids the
main libraries instantiate, the layout each kernel takes at a grid and the
route (shared or device memory) that follows from it, the grids the
kernels refuse, and the device the port's entry points default to. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py)."""

import os
import re

import pytest
import torch

from historymatching_tpu_torch import ResSim
from historymatching_tpu_torch.ops import pressure, transport
from historymatching_tpu_torch.ops._build import CSRC, GRIDS, SMEM_LIMIT
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, n_levels
from historymatching_tpu_torch.ops.pressure import (
    CG_KEYS,
    LEVEL_KEYS,
    gm1_plan,
    gm1_table,
    layout,
    pressure_solve_cuda,
    smem_bytes,
)
from historymatching_tpu_torch.ops.transport import transport_substeps_cuda


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_grid_list_matches_the_cuda_header():
    with open(os.path.join(CSRC, "grids.cuh")) as f:
        line = next(ln for ln in f if ln.startswith("#define HM_FOR_GRIDS"))
    pairs = re.findall(r"F\((\d+), (\d+)\)", line)
    assert tuple((int(a), int(b)) for a, b in pairs) == GRIDS


def _call(kernel, Nx, Ny, unit_diag=True, force=None):
    """The wrapper on CPU tensors of the right shapes: its grid check and
    route run first, then it refuses the CPU tensors."""
    z = torch.zeros(2, Nx, Ny)
    if kernel == "pressure":
        hier = build_hierarchy_5pt(torch.zeros(2, Nx - 1, Ny), torch.zeros(2, Nx, Ny - 1), z)
        nc = hier[-1][2][0].numel()
        pressure_solve_cuda(hier, torch.zeros(2, nc, nc), z, z, z, tol=1e-3, maxiter=8,
                            unit_diag=unit_diag, force=force)
    else:
        transport_substeps_cuda(z, torch.zeros(2, Nx + 1, Ny), torch.zeros(2, Nx, Ny + 1), z,
                                torch.ones(2), torch.ones(2, dtype=torch.int32),
                                (1.0, 1.0, 0.0, 0.0), force=force)


def _need(kernel, Nx, Ny, unit_diag=True):
    if kernel == "transport":
        return transport.smem_bytes(Nx, Ny)
    return smem_bytes(Nx, Ny, n_levels(Nx, Ny), unit_diag)


def _route(kernel, Nx, Ny, unit_diag=True):
    return pressure.route(Nx, Ny, unit_diag) if kernel == "pressure" else transport.route(Nx, Ny)


def _shared_route(kernel, Nx, Ny):
    if kernel == "pressure":
        return "smem"
    return "rt" if Nx * Ny > transport.RT1_CELLS else "rt1"


@pytest.mark.parametrize("kernel", ["pressure", "transport"])
@pytest.mark.parametrize("Nx,Ny", [(24, 24), (64, 32), (128, 128)])
def test_uninstantiated_grid_raises(kernel, Nx, Ny):
    """A grid outside `GRIDS` takes the shared-memory route where its layout
    fits one block (P's per-grid library; K's strip body built for the
    grid, K-rt, up to 4,096 cells, or the runtime-grid body on up to
    1,024) and a thread-block cluster a member where it does not (P
    at 128x128 needs 458,528 bytes, K has 16,384 cells); on either route
    the wrapper gets past its grid check to the CPU tensors' refusal."""
    need = _need(kernel, Nx, Ny)
    big = need > SMEM_LIMIT or (kernel == "transport" and Nx * Ny > transport.BAND_CELLS)
    assert _route(kernel, Nx, Ny) == ("cl" if big else _shared_route(kernel, Nx, Ny))
    with pytest.raises(ValueError, match="need float32 CUDA"):
        _call(kernel, Nx, Ny)


@pytest.mark.parametrize("kernel,Nx,Ny,unit_diag,need,expect", [
    ("pressure", 96, 96, True, 257_584, "cl"),
    ("pressure", 80, 80, False, 231_872, "smem"),
    ("pressure", 96, 64, False, None, "smem"),
    ("transport", 171, 171, True, 233_928, "gm"),
    ("transport", 8, 3632, True, 232_448, "gm1"),
])
def test_shared_memory_limit(kernel, Nx, Ny, unit_diag, need, expect):
    """At and around the 232,448 bytes one block may take: the byte counts
    of the layouts, the route they choose (a layout at the limit still
    fits; past it a cluster where one holds the grid, else device memory:
    no power of two splits 171 rows, and 8 rows of 3,632 cells leave no
    band of 4,096 cells a block can hold. 8x3632's two fw tiles fit one
    block exactly, but its 29,056 cells need 29 or more a thread there,
    which no plan of K-rt1's tile body holds without spilling, so K-gm1's
    tiles take it: `bench_routes.py --kernel k1` timed them 2.4-3.2x
    faster than K-rt1's first form at N=64 and 1000), and a forced
    device-memory route, which every grid takes (P: P-gm1, and P-gm where
    `gm_plan` cuts the grid; K: K-gm1, and K-gm where its `gm_plan` splits
    the grid; a band of 3,632 columns exceeds a block)."""
    got = _need(kernel, Nx, Ny, unit_diag)
    if need is not None:
        assert got == need
    assert got <= SMEM_LIMIT if expect in ("smem", "rt", "rt1") else (
        got > SMEM_LIMIT or transport.rt1_plan(Nx, Ny) is None)
    assert _route(kernel, Nx, Ny, unit_diag) == expect
    forces = (None, "gm1", *(("gm",) if pressure.gm_plan(Nx, Ny, unit_diag) else ())) if (
        kernel == "pressure") else (None, "gm1", *(("gm",) if transport.gm_plan(Nx, Ny) else ()))
    for force in forces:
        with pytest.raises(ValueError, match="need float32 CUDA"):
            _call(kernel, Nx, Ny, unit_diag, force=force)


# The grids the JAX package simulates and kernel P's shared-memory layout
# does not fit: (P's shared bytes, P-gm1's workspace bytes (its plan's:
# what its shared memory does not hold), K's shared bytes, K's route), a
# member each.
LARGE_GRIDS = {
    (60, 60): (297_712, 100_800, 28_800, "rt"),
    (88, 88): (272_048, 247_808, 61_952, "cl"),
    (96, 96): (257_584, 258_048, 73_728, "cl"),
    (100, 100): (1_827_072, 369_600, 80_000, "cl"),
    (128, 128): (458_528, 589_312, 131_072, "cl"),
    (60, 220): (3_071_152, 513_920, 105_600, "cl"),
    (192, 192): (1_030_960, 1_510_656, 294_912, "cl"),
    (256, 256): (1_833_760, 2_816_512, 524_288, "cl"),
}


@pytest.mark.parametrize("Nx,Ny", list(LARGE_GRIDS))
def test_large_grid_layouts_and_routes(Nx, Ny):
    """The layout count at each grid past one block's shared memory: P's
    shared bytes (`layout`) and P-gm1's workspace (`gm1_plan`); P takes P-cl
    everywhere but on the scaled 100x100 past 192 members and the scaled
    60x220 past 256 (or for a batch not given), where its coarsest inverse
    is distributed over 9 or 15 ranks and P-gm1 (132 members in flight;
    P-gm, 14 or 8 in flight, lost to it there) takes it; K its runtime-grid
    variant up to 4,096 cells (60x60) and K-cl above."""
    p_smem, p_gm, k_smem, k_route = LARGE_GRIDS[(Nx, Ny)]
    levels = n_levels(Nx, Ny)
    assert smem_bytes(Nx, Ny, levels) == p_smem > SMEM_LIMIT
    assert 4 * gm1_plan(Nx, Ny).ws_floats == p_gm
    p_route = "gm1" if (Nx, Ny) in ((100, 100), (60, 220)) else "cl"
    assert pressure.route(Nx, Ny) == pressure.route(Nx, Ny, True, 1000) == p_route
    assert pressure.route(Nx, Ny, True, 64) == pressure.route(Nx, Ny, False) == "cl"
    assert transport.smem_bytes(Nx, Ny) == k_smem and transport.route(Nx, Ny) == k_route
    for kernel in ("pressure", "transport"):
        with pytest.raises(ValueError, match="need float32 CUDA"):
            _call(kernel, Nx, Ny)


def _spans(Nx, Ny, unit_diag, gm1):
    """Every array of `layout` that a kernel reads or writes, as (name,
    start, end) in floats; for P-gm1 (`gm1`) those of its plan's device
    workspace."""
    if gm1:
        plan = gm1_plan(Nx, Ny, unit_diag)
        n = lambda lvl: Nx >> lvl if lvl is not None else Nx  # noqa: E731
        m = lambda lvl: Ny >> lvl if lvl is not None else Ny  # noqa: E731
        return [((k, lvl), o, o + (n(lvl) - (k == "TX")) * m(lvl))
                for (k, lvl), o in plan.device.items()], plan.ws_floats
    lv, extra, floats = layout(Nx, Ny, n_levels(Nx, Ny), unit_diag)
    lc = len(lv) - 1
    spans = []
    for lvl, d in enumerate(lv):
        n, m = d["n"], d["m"]
        keys = ("B", "X") if lvl == lc else (
            ("TX", "TY", "X", "B", "T") + (() if lvl == 0 and unit_diag else ("D", "RD")))
        for k in keys:
            size = (n - 1) * m if k == "TX" else n * m
            spans.append(((k, lvl), d[k], d[k] + size))
    nc = lv[lc]["n"] * lv[lc]["m"]
    sizes = {"inverse": nc * nc, "reduction": floats - extra.get("reduction", 0)}
    spans += [((k, None), o, o + sizes.get(k, Nx * Ny)) for k, o in extra.items()]
    return spans, floats


@pytest.mark.parametrize("unit_diag", [True, False])
@pytest.mark.parametrize("gm1", [False, True])
@pytest.mark.parametrize("Nx,Ny", [(8, 8), (10, 10), (64, 64), (60, 220), (128, 128)])
def test_layout_arrays_fit_and_do_not_overlap(Nx, Ny, gm1, unit_diag):
    """`layout` places every array inside the member's floats, 4-aligned
    (the kernels load float pairs), and no two overlap, except that each
    intermediate level's smoothing temporary lives inside the fine one (its
    only use comes after the fine temporary's last read); P-gm1's plan
    does the same in its device workspace, each array its own, and its
    table carries the same offsets."""
    spans, floats = _spans(Nx, Ny, unit_diag, gm1)
    assert all(o % 4 == 0 and 0 <= o < e <= floats for _, o, e in spans)
    coarse_t = lambda k: not gm1 and k[0] == "T" and k[1] > 0  # noqa: E731
    own = sorted((o, e, k) for k, o, e in spans if not coarse_t(k))
    assert all(e1 <= o2 for (_, e1, _), (o2, _, _) in zip(own, own[1:])), own
    fine_t = next((o, e) for k, o, e in spans if k == ("T", 0))
    assert all(fine_t[0] <= o and e <= fine_t[1] for k, o, e in spans if coarse_t(k))
    if gm1:
        table = gm1_table(Nx, Ny, unit_diag)
        levels = n_levels(Nx, Ny)
        assert table[1] == floats and table[10:14] == [o for k, o, _ in spans
                                                       if k in [(c, None) for c in CG_KEYS]]
        device = {(LEVEL_KEYS[2 + i], lvl): table[16 + 9 * lvl + i]
                  for lvl in range(levels) for i in range(7)}
        assert all(device[k] == o for k, o, _ in spans if k[1] is not None)


@pytest.mark.parametrize("Nx,Ny", [(15, 15), (12, 9), (4, 4), (6, 5)])
def test_pressure_kernel_needs_a_hierarchy(Nx, Ny):
    """Grids without a multigrid hierarchy take the plain Jacobi-PCG (in
    torch ops on either device); kernel P refuses them on every route, K
    takes them."""
    assert n_levels(Nx, Ny) < 2
    with pytest.raises(ValueError, match="has no multigrid hierarchy"):
        pressure.check_grid(Nx, Ny)
    with pytest.raises(ValueError, match="has no multigrid hierarchy"):
        pressure.route(Nx, Ny)
    transport.check_grid(Nx, Ny)


def test_build_defaults_to_the_card():
    """Without `device` the model lands on CUDA; on a host without CUDA the
    call raises torch's own error instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert ResSim.build(Nx=16, Ny=16).K.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ResSim.build(Nx=16, Ny=16)
    assert ResSim.build(Nx=16, Ny=16, device="cpu").K.device.type == "cpu"
