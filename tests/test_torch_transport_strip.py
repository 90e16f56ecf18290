"""What the CPU can check of K-rt, kernel K's strip body built for a grid
outside `_build.GRIDS` (csrc/transport_upwind.cu `transport_upwind_kernel`
under -DHM_KRT_*): its plan (`ops/transport.rt_plan`: strips of S rows, one
column a thread, the faces in registers or in shared memory), the route
between it and K-rt1 (the runtime-grid body it replaced; the tile body
since, tests/test_torch_transport_tile.py), the library a
grid gets, and its schedule in a plain emulation held to the plain version
and to the JAX package's Pallas kernel.

The strip body is K-gm's schedule on one band of the whole grid and one
column a thread, so the emulation is tests/test_torch_transport_gm.py's
`banded_substeps` with one band.

Tolerances: float64 against `transport_substeps_torch` bit for bit (the
same operations in the same order); float32 against
`transport_substeps_pallas` in interpret mode at atol 1e-6, the tolerance
tests/test_torch_transport.py holds the plain version to. The kernel runs
only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.ops.transport_pallas import transport_substeps_pallas
from historymatching_tpu_torch.ops import _build, transport
from historymatching_tpu_torch.ops.transport import (
    MAX_STRIP,
    MAX_THREADS,
    MIN_STRIP,
    RT1_BATCH_CELLS,
    RT1_CELLS,
    RT_REGS,
    reg_budget,
    rt_bytes,
    rt_plan,
    rt_threads,
    transport_substeps_cuda,
    transport_substeps_torch,
)
from tests.test_sim import default_model
from tests.test_torch_transport_gm import _inputs, banded_substeps


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# chip_smoke.py [18]'s grids, [23]'s 60x60, the main grids, grids past
# 4,096 cells that no cluster takes, and small odd grids.
K_RT_GRIDS = [(15, 15), (12, 9), (10, 10), (12, 12), (24, 16), (80, 80)]
STRIP_GRIDS = K_RT_GRIDS + list(_build.GRIDS) + [
    (60, 60), (75, 75), (97, 97), (101, 60), (7, 1), (1, 7), (3, 500), (5, 1024), (40, 40)]


@pytest.mark.parametrize("Nx,Ny", STRIP_GRIDS)
def test_rt_plan_covers_every_cell_once(Nx, Ny):
    """The strips of the plan cover every row once (the last may hold
    fewer), one column a thread, so each cell is one thread's; one block
    holds them (threads, bytes); the strip is the smallest that fits; the
    faces go to shared memory only where registers do not fit the block's
    share (`RT_REGS` against `reg_budget`)."""
    strip, place = rt_plan(Nx, Ny)
    threads = rt_threads(Nx, Ny, strip)
    rows = [min(strip, Nx - i0) for i0 in range(0, Nx, strip)]
    assert sum(rows) == Nx and all(0 < h <= strip for h in rows) and rows[:-1] == [strip] * (
        len(rows) - 1)
    assert len(rows) * Ny == threads <= MAX_THREADS
    assert rt_bytes(Nx, Ny, strip, place) <= _build.SMEM_LIMIT
    assert strip == min(MIN_STRIP, Nx) or strip <= MAX_STRIP
    for smaller in range(min(MIN_STRIP, Nx), strip):
        t = rt_threads(Nx, Ny, smaller)
        assert t > MAX_THREADS or all(
            RT_REGS[p][0] * smaller + RT_REGS[p][1] > reg_budget(t)
            or rt_bytes(Nx, Ny, smaller, p) > _build.SMEM_LIMIT for p in RT_REGS)
    a, c = RT_REGS["registers"]
    assert (place == "registers") == (a * strip + c <= reg_budget(threads))


def test_main_grids_plan_is_the_templated_instantiation():
    """At `GRIDS` the plan is the main library's instantiation (strips of 4
    rows, faces in registers), so K-rt forced there runs the templated K's
    code from a library of its own."""
    for grid in _build.GRIDS:
        assert rt_plan(*grid) == (4, "registers")
        assert transport.route(*grid) == "templated"


def test_reg_budget():
    """A block's thread count leaves a thread 65,536 registers over its
    warps, allocated four at a time, in steps of 8, at most 255: the caps
    ptxas took on the H100 (64 at 900-1,024 threads, 72 at 873, 80 at 668,
    96 at 544)."""
    assert [reg_budget(t) for t in (1024, 960, 900, 873, 800, 668, 544, 256, 60)] == [
        64, 64, 64, 72, 72, 80, 96, 255, 255]


# K's route: the strip body (K-rt) on every grid of more than RT1_CELLS
# cells whose strips fit a block and whose tiles fit; K-rt1 on the grids
# of up to RT1_CELLS cells (faster there) and where no strip plan of one
# column a thread fits but K-rt1's one-block tile plan does (a row wider
# than a block's threads); past that, where K-rt1's first form held a grid
# with its faces read from L1 every substep (8x3632, 150x150, 99x199: no
# one-block plan of the tile body builds without spilling), K-gm or K-gm1
# (bench_routes.py --kernel k1: faster at N=64 and 1000).
STRIP_ROUTES = {
    (15, 15): "rt1", (12, 9): "rt1", (10, 10): "rt1", (12, 12): "rt1", (24, 16): "rt1",
    (30, 30): "rt1", (32, 32): "templated", (33, 32): "rt", (36, 36): "rt",
    (60, 60): "rt", (75, 75): "rt", (97, 97): "rt", (3, 500): "rt",
    (8, 3632): "gm1", (2, 2000): "rt1", (150, 150): "gm", (99, 199): "gm",
    (80, 80): "cl", (64, 64): "templated",
}


@pytest.mark.parametrize("grid", list(STRIP_ROUTES))
def test_strip_route(grid):
    """K-rt past RT1_CELLS cells where `rt_plan` gives a plan and the two
    fw tiles fit, K-rt1 where only the tiles and its one-block plan fit or
    on fewer cells, K-gm or K-gm1 past that, K-cl and the templated K keep
    theirs; a forced K-rt or K-rt1 without a plan is refused before any
    launch, and every route reaches the wrappers' refusal of CPU tensors
    (nothing falls back)."""
    from historymatching_tpu_torch.ops.transport import rt1_plan

    Nx, Ny = grid
    assert transport.route(Nx, Ny) == STRIP_ROUTES[grid]
    if STRIP_ROUTES[grid] in ("rt", "rt1"):  # the route for a batch not given: a small one
        assert (STRIP_ROUTES[grid] == "rt1") == (
            rt_plan(Nx, Ny) is None or Nx * Ny <= RT1_CELLS)
    z = torch.zeros(1, Nx, Ny)
    args = (z, torch.zeros(1, Nx + 1, Ny), torch.zeros(1, Nx, Ny + 1), z, torch.ones(1),
            torch.ones(1, dtype=torch.int32), (1.0, 1.0, 0.0, 0.0))
    if rt_plan(Nx, Ny) is None:
        with pytest.raises(ValueError, match="no strip plan"):
            transport_substeps_cuda(*args, force="rt")
    if rt1_plan(Nx, Ny) is None:
        with pytest.raises(ValueError, match="no tile plan of K-rt1"):
            transport_substeps_cuda(*args, force="rt1")
    for force in ((None,) + (("rt1",) if rt1_plan(Nx, Ny) else ())
                  + (("rt",) if rt_plan(Nx, Ny) else ())):
        with pytest.raises(ValueError, match="need float32 CUDA"):
            transport_substeps_cuda(*args, force=force)
    assert transport.NAMES["rt"] == "transport_upwind_rt"
    assert transport.NAMES["rt1"] == "transport_upwind_rt1"


# bench_routes.py on the H100 (K-rt against K-rt1, forced, on the first
# step's substeps): which ran faster at each (grid, batch) measured, "tie"
# within 3%. Grids of up to RT1_CELLS cells: `--kernel k1`, the card's
# time alone; larger grids: K-rt against K-rt1's first form, launch times.
FASTER = {((12, 12), 64): "rt1", ((12, 12), 128): "rt1", ((12, 12), 256): "rt1",
          ((12, 12), 1000): "tie", ((10, 10), 64): "rt1", ((10, 10), 128): "rt1",
          ((10, 10), 256): "rt1", ((10, 10), 1000): "rt1", ((15, 15), 64): "rt1",
          ((15, 15), 128): "rt1", ((15, 15), 256): "rt1", ((15, 15), 1000): "rt",
          ((24, 16), 64): "rt1", ((24, 16), 128): "rt1", ((24, 16), 256): "rt1",
          ((24, 16), 1000): "rt1", ((12, 9), 64): "tie", ((12, 9), 128): "tie",
          ((12, 9), 256): "tie", ((12, 9), 1000): "rt", ((28, 28), 64): "rt1",
          ((28, 28), 128): "rt1", ((28, 28), 256): "rt1", ((28, 28), 1000): "rt",
          ((30, 30), 1000): "rt", ((36, 36), 64): "rt", ((40, 40), 64): "rt",
          ((48, 48), 64): "rt", ((60, 60), 64): "rt", ((75, 75), 64): "rt",
          ((60, 60), 1000): "rt", ((36, 36), 1000): "rt", ((75, 75), 1000): "rt"}
# Where the rule takes the slower body, and by how much (ops/transport.py
# `RT1_BATCH_CELLS`): no threshold on a batch's cells splits these.
RULE_MISSES = {((28, 28), 256): 0.03, ((24, 16), 1000): 0.08}


@pytest.mark.parametrize("case", list(FASTER))
def test_rt1_keeps_small_launches(case):
    """The route takes the body that ran faster, either where they tied,
    but at RULE_MISSES: K-rt1 on grids of up to RT1_CELLS cells while the
    batch holds up to RT1_BATCH_CELLS cells, K-rt past either."""
    (Nx, Ny), batch = case
    got = transport.route(Nx, Ny, batch)
    small = Nx * Ny <= RT1_CELLS and batch * Nx * Ny <= RT1_BATCH_CELLS
    assert got == ("rt1" if small else "rt")
    assert got == FASTER[case] or FASTER[case] == "tie" or case in RULE_MISSES


def test_rt_library_per_grid_and_plan():
    """A grid's K-rt library is keyed by the grid and its plan and built
    with them as macros; `prebuild(k_grids=)` starts it with the others;
    K-gm's plans past the first get a library keyed by strip, columns and
    threads in whole warps."""
    key, stem, flags, so, sigs = _build._k_specs(80, 80)[0]
    assert key == "transport_upwind_rt_80x80_s7s" and stem == "transport_upwind"
    assert flags == ["-DHM_KRT_NX=80", "-DHM_KRT_NY=80", "-DHM_KRT_S=7", "-DHM_KRT_SHARED=1"]
    assert sigs == "transport_upwind_rt" and so.endswith(".so")
    assert [sp[0] for sp in _build._k_specs(15, 15)] == ["transport_upwind_rt_15x15_s4r"]
    assert [sp[0] for sp in _build._k_specs(32, 1088)] == ["transport_upwind_gm_s4w2t544"]
    assert _build._k_specs(120, 440) == []  # K-gm's first plan: the main library


# (grid, strip rows): K_RT_GRIDS' strips of 4 (short last strips at 15x15
# and 10x10), a strip taller than its grid, and 80x80's 7 rows on a
# smaller grid (a last strip of 3).
STRIP_CASES = [((15, 15), 4), ((12, 9), 4), ((10, 10), 4), ((3, 5), 4), ((10, 6), 7),
               ((13, 4), 16)]


@pytest.mark.parametrize("grid,strip", STRIP_CASES)
def test_strip_schedule_matches_plain_f64(grid, strip):
    """Float64: the strips, each computing its own rows from its own fw and
    the rows above and below it, give the plain version's saturations bit
    for bit."""
    Nx, Ny = grid
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, _inputs(8, 4, Nx, Ny, np.float64))
    fluid = (0.3, 3.0, 0.1, 0.2)
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    got = banded_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, [Nx], strip=strip)
    assert torch.equal(got, ref)
    assert not torch.equal(ref, s)


@pytest.mark.parametrize("grid,strip", STRIP_CASES)
def test_strip_schedule_matches_pallas_interpret_f32(grid, strip):
    """Float32: the strip schedule against the JAX package's Pallas kernel
    in interpret mode (atol 1e-6), member by member, and bit for bit
    against the plain version."""
    Nx, Ny = grid
    fl = default_model(Nx=max(Nx, 2), Ny=max(Ny, 2)).fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    arrays = _inputs(9, 4, Nx, Ny, np.float32)
    s, Fx, Fy, q, dts_pv, n_sub = map(torch.as_tensor, arrays)
    got = banded_substeps(s, Fx, Fy, q[None], dts_pv, n_sub, fluid, [Nx], strip=strip)
    assert torch.equal(got, transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid))
    for b in range(4):
        ref = transport_substeps_pallas(*(jnp.asarray(x[b]) for x in arrays[:3]),
                                        jnp.asarray(arrays[3]), arrays[4][b], arrays[5][b],
                                        fluid, interpret=True)
        assert np.allclose(got[b].numpy(), np.asarray(ref), atol=1e-6), b
