#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failed check raises:
1. device: require CUDA, print the card's name and power limit, TF32 off;
2. build the hand-written kernels (historymatching_tpu_torch/csrc) with nvcc,
   one compiler per source and per cluster library (each grid of [23] and
   [18]), in parallel; print each kernel's registers,
   local (spill) bytes, shared memory and resident blocks per SM, P in
   both its smoother instantiations (damped Jacobi and Chebyshev);
3. kernel K (transport) against its plain PyTorch version, float32;
4. kernel P (pressure MG-PCG) against its plain version: (a) fixed work,
   (b) the main path's solver settings; (c) both for P's Chebyshev
   instantiation at N=1000;
5. the flagship workload: N=1000 members, 64x64, 40 steps, 4-pass ES-MDA
   (prior, truth simulation, observations, forward_model -> simulate ->
   es_mda) through the entry points' default device, on the reference's
   solver schedule with its straggler recook, with launch counts of both
   kernels over the run and, per pass, the members recooked a step;
6. each kernel's time against its plain version at the main path's shapes,
   and the least time the card could take for the same work (bound_ms);
   6b. one step's recooked solve (three P launches) and its bound;
7. torch.profiler over 10 steps of a loose pass: device time by stage and
   the card's idle share;
8. the recook on the card against the recook around P's plain version;
9. localized ES-MDA (4x4-cell domains, radius 1.2) at the flagship size;
10. IES (10 Gauss-Newton iterations, xStep 0.4) at the flagship size;
11. the EnOpt model (20x20, the reference bench's inj_xy case, its JAX
    draws from historymatching_tpu_torch/data): K and P against their
    plain versions on one step of the 400-member landscape batch, each
    member with its own injector, and each kernel's time and bound at 400
    members and at 40 (a gradient batch of 4 starts x 10);
12. the exhaustive landscape: all 400 cell-centre injector positions in
    one `npv` batch, held against the JAX package's float64 landscape;
13. `gd_scan_multi`, the bench's EnOpt case: 4 starts, 10 perturbations,
    8 trial steps, 30 iterations, held to the bench's 2% criterion;
14. robust EnOpt over a 31-member permeability ensemble: GD with StoSAG
    gradients for 30 iterations, then Paired and Mean-model for 5 each;
15. the flagship ES-MDA of [5] with the Chebyshev smoother (P's cheb
    instantiation on every solve), on [5]'s data and draws, and P cheb's
    time a launch against its plain version and its bound;
16. ILES over 256 domains (4x4 cells, radius 1.2) at the flagship size,
    10 Gauss-Newton iterations of step 0.4, with the GN step's time
    against its bound, the domains whose pseudo-inverse took
    `torch.linalg.pinv`, and the peak device memory;
17. ES-MDA resume: a 4-pass run at N=200 against the same run stopped after
    2 passes, checkpointed, loaded and resumed; the posteriors must be
    equal;
18. K-rt, kernel K's strip body built for each grid the main library does
    not cover (15x15, 12x9, 10x10, 12x12, 24x16, 80x80; one library a
    grid), forced, against its plain version at N=64 on fields and fluxes
    of a real pressure step (bit for bit), each timed beside K-rt1 (the
    tile body: these small grids' route, a member on its own warps; bit
    for bit too) and its bound; and built for 64x64 on [6]'s inputs against
    the templated K and K-rt1;
19. kernel P built for grids outside the main library (8x8, 10x10, 12x12,
    24x16, 80x80), both smoothers, against its plain version after one
    window, the acceptance counts at bench settings and its time a launch;
    19b. P with an explicit fine diagonal (the unscaled system) at 20x20
    and 64x64 the same way, its time at [6]'s shapes, and
    `simulate(scale_system=False)` through the entry point;
    19c. each new instantiation's resources (K-rt's and K-rt1's at [18]'s
    grids and 64x64), and a 96x96 grid, whose
    layout exceeds one block's shared memory, simulated through P-cl and
    K-cl;
20. one member of 64 whose coarse Cholesky fails: it gets the guarded
    Newton-Schulz, the others keep their inverses, and P solves the batch;
21. the port's two tutorial examples, `history_match` (20x20, N=40, every
    method) and `optimise` (20x20, every case but `robust`; then --small,
    12x12, inj_xy, rate and toys), with each run's wall, kernel launches
    and headline numbers;
22. workload parity (`historymatching_tpu_torch.parity`, as `bench_gpu.py`
    runs it): ES-MDA, localized ES-MDA and IES at N=192 and the ES-MDA
    ladder at N=384, 768 and 1000, on the inputs the reference bench draws
    for each seed (JAX's threefry draws, computed by the port), held to the
    committed exact float64 oracle's posterior RMSE by each rung's gate;
    every seed's prior RMSE must match its ref's. With `--parity-out DIR`
    each rung's record is written there;
23. the grids whose layouts exceed one block's shared memory (60x60,
    88x88, 96x96, 100x100, 128x128, 60x220, 192x192, 256x256), N=64: P-cl
    (a thread-block cluster a member; at 100x100 and 60x220 P-cl/d, the
    coarsest inverse distributed over the ranks, beside the plan that reads
    it in place on two ranks) on its route, P-gm1 forced and at 100x100
    P-gm forced, in the four
    instantiations, each against its plain version after one window and
    timed at bench settings, with its plan, bytes and inverse rows a rank,
    resources and clusters resident; K on its route (K-cl, or K-rt at
    60x60), K-rt1 where its one-block plan fits, K-rt where a strip plan fits and
    K-gm forced, each bit for bit on a real step and timed against its
    bound (K-gm, a member over co-resident blocks a band of rows, with its
    bands and members in flight); a few steps of `simulate`
    through each P-cl instantiation and K-cl at 128x128 and at 60x220
    (P-cl/d), and through each P-gm instantiation (a member over
    co-resident blocks, bands of rows and the coarsest inverse's rows in
    their shared memory) and K-gm at 120x440 (a 60x220 layer refined 2x2,
    past any cluster; N=16), where each P-gm instantiation is then held to
    its plain version and timed with its bound, its plain version and P-gm1
    (one block a member, its coarse levels in shared memory, the rest in
    device memory, its inverse streamed through a ring of bulk copies)
    beside it, with its
    registers, spills, blocks and members in flight, and K-gm beside K-gm1
    (a member over co-resident 2-D tiles); `simulate` at
    32x1088 (N=4), past P-gm's capacity and K-gm's first plan (a row wider
    than a block), through each P-gm1 instantiation and K-gm on its widened
    plan (strips of 4 rows and 2 columns a thread), then K-gm timed on its
    step 6 beside K-gm1 and P-gm1 on the first step's system (with its plan
    and its inverse's floor); `simulate` at
    4x1100 through K-rt1 (a row wider than a block of the strip body) and
    at 5x6000 through K-gm1 (past K-gm's capacity), N=4, each timed on its
    step 6 with its plan, K-gm1's device-memory body forced there too;
    P-gm1, K-gm and K-gm1 forced at 64x64 on [6]'s inputs beside
    the shared-memory kernels;
    23c. K at 600x600, N=4, past K-gm's first plan (150 bands of 4 rows)
    with rows under 1,024 cells: on the first step's inputs K-gm on its
    widened plan (120 bands, strips of 5 rows) bit for bit, timed beside
    K-gm1, the plain version and the bound, with the phase's wall;
24. the reference's bench case at 128x128 (`parity.build_case(seed=1,
    N=1000, Nx=128, Ny=128)`): 40 steps and the 4-pass ES-MDA on the
    reference's schedule, every step one P-cl and one K-cl launch, the
    saturations of every step kept on the card; wall, launches, cg
    acceptance a pass, peak memory, RMSE, and 10 profiled steps; on its
    first step P-cl and K-cl against their plain versions and timed beside
    P-gm1, K-gm1 and K-gm, all forced;
    24b. the bench case's geometry at P-cl/d's grids, a 60x220 layer of
    SPE10 model 2 and 100x100 (`parity.build_case(seed=1, N=1000, Nx, Ny)`):
    5 steps of the first pass through `forward_model` and P's route (P-gm1
    at both for 1000 members), P's device time a step; on the first step
    P-cl/d and P-gm1 (and at 100x100 P-gm) forced, held to the plain
    version after one window and timed side by side with their bounds,
    P-gm1 with its plan and its inverse's floor;
25. on a world of one over NCCL (`parallel.mesh`): `forward_model(mesh=)`
    on a member-sharded prior, 64x64, N=128, 5 steps, bit for bit against
    the run without a mesh; then [5]'s flagship ES-MDA (N=1000, 64x64, 40
    steps, 4 passes, the reference's schedule with the recook), [10]'s IES
    and [14]'s robust StoSAG GD (20x20, 31 fields) on member-sharded
    inputs, each on its phase's inputs and draws, the wall of the sharded
    and of the unsharded run, each P and K launch count equal to its
    phase's, and each result equal to the unsharded run's bit for bit.

The line before the last is the kernels' JSON record (with each kernel's
launches in each rung of [22]); the last line is
{"ok": true, "device": {...}}. Without a card, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1
N, NX, NY, NTIME, DT, PASSES = 1000, 64, 64, 40, 0.025, 4
# Solver settings of the reference bench: bench.bench_sim_kwargs without
# `packed`, `coarse_warm` and `warm_start` (TPU-only or off), and
# bench.DEFAULT_SCHED per ES-MDA pass, bench.IES_DEFAULT_SCHED per IES
# iteration.
BASE = dict(tol=2e-4, maxiter=768, patience_iters=256, two_pass=True, twopass_j1=64,
            twopass_div=4, refine=True)
LOOSE = dict(tol=2e-3, maxiter=256, patience_iters=128, twopass_j1=8, twopass_div=8)
FINAL = dict(twopass_div=8, twopass_j1=8, maxiter=128)
SCHED = [LOOSE, LOOSE, LOOSE, FINAL]
IES_SCHED = [LOOSE] * 8 + [FINAL] * 2
IES_ITERS, IES_STEP = 10, 0.4
SOLVE_KEYS = ("tol", "maxiter", "patience_iters")  # what one P launch takes
K_TOL, P_TOL = 1e-5, 1e-3
# Peak rates of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and device memory.
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12
# The least work a unit of each kernel's function needs. K: flops a cell and
# substep with the upwind split folded once a step into five coefficients
# with dt (fw 8, the update and s + acc 11, the clamp 2), and flops a cell
# and step for that fold (18); the kernel does more, to keep the plain
# version's rounding. P, counted from the code: flops a fine cell and CG
# iteration outside the V-cycle (matvec 9, p.Ap 2, x and r updates 4, r.z
# and (w r)^2 5, p update 2), and a V-cycle's flops a cell of each smoothed
# level (two sweeps down with the zero start folded, residual and
# restriction, prolongation and two sweeps up).
K_FLOPS_SUBSTEP, K_FLOPS_FOLD, P_FLOPS_FINE, P_FLOPS_VCYCLE = 21, 18, 22, 54
# The Chebyshev V-cycle a cell of each smoothed level: Jacobi's, plus one
# flop for the momentum term of the folded pre-smoothing sweep and three
# for the second post-smoothing sweep's (1 + a) t - a x0 (its start x0
# counted once, where the first sweep forms it).
P_FLOPS_VCYCLE_CHEB = 58
# The ILES Gauss-Newton step a weight matrix (N x N, p observations): LU
# 2/3 N^3 and its solve 2 N^2 p, the two Gram-type products 2 N^2 p each,
# Cholesky 1/3 N^3 and its solve on N right-hand sides 2 N^3.
ILES_FLOPS = lambda n, p: 3 * n**3 + 6 * n**2 * p  # noqa: E731
ILES_ITERS, RESUME_N = 10, 200
# Grids of phases 18-19: K's runtime-grid variant, P built on first use,
# P with an explicit fine diagonal; and a grid over one block's shared
# memory, simulated through its route (P-cl since PR 10).
K_RT_GRIDS = ((15, 15), (12, 9), (10, 10), (12, 12), (24, 16), (80, 80))
P_NEW_GRIDS = ((8, 8), (10, 10), (12, 12), (24, 16), (80, 80))
P_DIAG_GRIDS = ((20, 20), (64, 64))
GM_GRID, NEW_N, P_NEW_N = (96, 96), 64, 128
# [23]: the grids the JAX package simulates whose P layout exceeds one
# block's shared memory, N=64 a grid; [24]: the bench case's grid;
# [25]: the mesh run's members and steps.
LARGE_GRIDS = ((60, 60), (88, 88), (96, 96), (100, 100), (128, 128), (60, 220), (192, 192),
               (256, 256))
LARGE_N, BIG, MESH_N, MESH_STEPS = 64, (128, 128), 128, 5
P_GM = tuple((smoother, unit) for unit in (True, False) for smoother in ("jacobi", "cheb"))
# (grid, scaled system) whose P route is the device-memory one (P-gm1) past
# a batch, and the batch (`ops/pressure.route`): P-cl/d keeps 7-9 members in
# flight there.
P_GM_PAST = {(100, 100, True): 192, (60, 220, True): 256}
# [24b]: the bench case's geometry on P-cl/d's grids, a 60x220 layer of
# SPE10 model 2 and 100x100, N=1000, 5 steps of the first pass.
LAYER_GRIDS, LAYER_STEPS = ((60, 220), (100, 100)), 5
# [23]'s path through P-gm and K-gm: a 60x220 layer refined 2x2, whose P
# and K layouts no cluster of up to 16 blocks holds, N=16.
GM_PATH_GRID, GM_PATH_N = (120, 440), 16
# [23]'s path past K-gm's and P-gm's capacity, through K-gm1 and P-gm1: a
# grid whose 1,088 columns exceed one block's row (and whose band of 8 rows
# exceeds P-gm's block), N=4.
GM1_PATH_GRID, GM1_PATH_N = (32, 1088), 4
# [23]'s paths of the tile body: K-rt1 (a row wider than a block of the
# strip body) and K-gm1 (past K-gm's capacity), N=4; [23c]'s grid past K-gm's first plan
# with rows under 1,024 cells, N=4.
ROUTE_PATHS, ROUTE_PATH_N = {"rt1": (4, 1100), "gm1": (5, 6000)}, 4
CAPACITY_GRID, CAPACITY_N = (600, 600), 4
# [19]'s fixed work: one restart window of 4 iterations. On grids of up to
# 400 cells a window of 8 reaches float32's floor, where the plain version
# in float32 and in float64 part by up to 1.5e-1 (PERF.md, Findings).
WINDOW4 = dict(tol=0.0, maxiter=4, restart_every=4, patience_iters=160)
# [19b] holds the unscaled system's P on fields of mild contrast (the prior
# scaled by this): at the prior's own contrast float32 leaves the unscaled
# system undetermined, the plain version in float32 and float64 parting by
# O(1) after one iteration.
MILD = 0.2
# The unscaled system's extra flops a fine cell and CG iteration: the
# matvec's and the V-cycle's products by the diagonal and its reciprocal.
P_FLOPS_DIAG = 8
# The examples of [21]: module, arguments, the kernels each must launch.
OPT_DEFAULT = "inj_xy,x_only,two_inj,rate,multi_rate,time_rates,pareto,toys"
EXAMPLES = (
    ("history_match", [], ("transport_upwind", "pressure_pcg")),
    ("optimise", ["--cases", OPT_DEFAULT], ("transport_upwind", "pressure_pcg")),
    ("optimise", ["--small", "--cases", "inj_xy,rate,toys"],
     ("transport_upwind_rt1", "pressure_pcg")),
)
# Device activities by kernel name, for the profiled stages.
STAGE_OF = (("pressure_pcg_kernel", "pressure_pcg"), ("pressure_pcg_gm_kernel", "pressure_pcg"),
            ("pressure_pcg_gm1_kernel", "pressure_pcg"), ("pressure_pcg_cl_kernel", "pressure_pcg"),
            ("transport_upwind_kernel", "transport_upwind"),
            ("transport_upwind_tile_kernel", "transport_upwind"),
            ("transport_upwind_gm_kernel", "transport_upwind"),
            ("transport_upwind_gm1_kernel", "transport_upwind"),
            ("transport_upwind_cl_kernel", "transport_upwind"))
JACOBI_KERNELS = ("transport_upwind", "pressure_pcg")  # the main path's
# EnOpt (phases 11-14): the bench's gd_scan_multi (bench._enopt_fields) and
# the reference's robust case (Optimise.py:833-875), each at its full size.
EN_ITERS, EN_NENS, EN_CHOL, EN_SMALL_B = 30, 10, 0.1, 40
ROBUST_N, ROBUST_ITERS, ROBUST_SHORT_ITERS = 31, 30, 5


_T0 = time.perf_counter()
PHASE_AT = {}  # seconds from the start to each phase's first line


def log(*a):
    tag = str(a[0]).split(" ", 1)[0] if a else ""
    if tag.startswith("[") and tag not in PHASE_AT:
        PHASE_AT[tag] = round(time.perf_counter() - _T0, 1)
    print(*a, flush=True)


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of `fn` on the card over `reps` runs, after a
    warm-up (none where `warm` is False: `fn` ran just before)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flagship_model(torch):
    """The reference bench case (bench.build_model): 2x1 domain, centre
    injector, 4 producers at (0.12, 0.87) x (Lx, Ly), balanced unit rates,
    on the entry point's default device."""
    import numpy as np

    from historymatching_tpu_torch import ResSim

    Lx, Ly = 2.0, 1.0
    near01 = np.array([0.12, 0.87])
    prd_xy = [[x, y] for y in Ly * near01 for x in Lx * near01]
    return ResSim.build(Nx=NX, Ny=NY, Lx=Lx, Ly=Ly, inj_xy=[[Lx / 2, Ly / 2]], prd_xy=prd_xy,
                        inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4,
                        dtype=torch.float32)


def pressure_bound_ms(hier, Ainv, iters, vcycle_flops=P_FLOPS_VCYCLE,
                      fine_flops=P_FLOPS_FINE):
    """Least time of a P launch: its flops (the iterations these members
    ran) at the float32 rate, or its bytes (hierarchy, coarse inverse, q,
    p0, w read once, p written once) at the memory rate."""
    cells = [lvl[2][0].numel() for lvl in hier]
    per_iter = cells[0] * fine_flops + vcycle_flops * sum(cells[:-1]) + 2 * cells[-1] ** 2
    flops = per_iter * float(iters.double().sum())
    nbytes = 4 * (sum(t.numel() for lvl in hier for t in lvl) + Ainv.numel()
                  + 4 * hier[0][2].numel() + 2 * iters.numel())
    return bound(flops, nbytes)


def transport_bound_ms(s, Fx, Fy, q, n_sub):
    """Least time of a K launch: its flops (the substeps these members run,
    and one fold a member) or its bytes (s, Fx, Fy, q, dts_pv, n_sub read
    once, s written once)."""
    flops = s[0].numel() * (K_FLOPS_SUBSTEP * float(n_sub.double().sum())
                            + K_FLOPS_FOLD * n_sub.numel())
    nbytes = 4 * (2 * s.numel() + Fx.numel() + Fy.numel() + q.numel() + 2 * n_sub.numel())
    return bound(flops, nbytes)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def inverse_floor_ms(Ainv, iters, restart_every=8):
    """Least time of a P launch that reads each member's coarsest inverse
    from device memory once a V-cycle (P-gm1's ring, P-cl's in-place plan):
    a V-cycle an iteration and one a restart window, for these members'
    iterations, at the card's memory rate."""
    it = iters.double()
    vcycles = float((it + (it / restart_every).ceil()).sum())
    return 1e3 * 4 * Ainv[0].numel() * vcycles / HBM_BYTES


def gm1_said(Nx, Ny, unit=True, plan=None):
    """P-gm1's plan at a grid (`ops/pressure.gm1_plan`, or `plan`) for a log
    line and a record: its shared bytes and the arrays there, the ring, the
    workspace."""
    from historymatching_tpu_torch.ops.pressure import gm1_plan

    p = plan or gm1_plan(Nx, Ny, unit)
    rec = dict(shared_bytes=p.smem_bytes, shared_arrays=sorted(
        f"{k}{lvl}" for k, lvl in p.shared), ring_stages=p.stages, ring_stage_bytes=4 * p.stage,
               workspace_bytes=4 * p.ws_floats, threads=p.threads)
    said = (f"plan: {p.smem_bytes} shared bytes ({', '.join(rec['shared_arrays'])}), ring "
            f"{p.stages} x {4 * p.stage} bytes, workspace {4 * p.ws_floats} bytes a member")
    return rec, said


def noisy_start(args, seed):
    """P's arguments `args` with the start p0 replaced by seeded noise, each
    member's at the scale of its right-hand side's largest entry."""
    import torch

    q = args[2]
    g = torch.Generator(device=q.device).manual_seed(seed)
    p0 = torch.randn(q.shape, generator=g, device=q.device) * q.abs().amax(dim=(-2, -1),
                                                                         keepdim=True)
    return (*args[:3], p0, *args[4:])


def sync():
    import torch

    torch.cuda.synchronize()


def device_stages(fn, steps):
    """`fn` traced by the port's `profiling.trace`, the Chrome trace summed
    by `profiling.parse_trace`: (device ms a step by stage, device
    activities a step). Stages are kernel P (either smoother), kernel K and
    every other device activity (kernels, copies, memsets)."""
    from historymatching_tpu_torch import profiling

    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            fn()
        totals = profiling.parse_trace(d)
    stages = {"pressure_pcg": 0.0, "transport_upwind": 0.0, "torch ops": 0.0}
    for name, seconds in totals.device.items():
        key = next((st for sub, st in STAGE_OF if sub in name), "torch ops")
        stages[key] += 1e3 * seconds / steps
    return stages, sum(totals.device_count.values()) / steps


def profile_steps(fn, steps):
    """`fn` run once unprofiled for the wall, then under torch.profiler:
    (device ms a step by stage, device busy ms a step, wall ms a step,
    device activities a step)."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    stages, per_step = device_stages(fn, steps)
    busy = sum(stages.values())
    assert busy > 0, "the profiler saw no device time"
    # The card cannot be busy longer than the wall. The profiled and the
    # unprofiled run differ, but device times repeat to about 1% between
    # runs, so beyond 5% the profile double-counts or its overhead leaks in.
    assert busy <= 1.05 * wall_ms, f"device time {busy:.3f} ms exceeds the wall {wall_ms:.3f} ms"
    return stages, busy, wall_ms, per_step


def enopt_phases(dev, gen):
    """Phases 11-14. Returns, per kernel, its figures at 20x20 for the
    kernels' record."""
    import numpy as np
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import (
        _source_field,
        cfl_substeps,
        pressure_step,
        scaled_system,
        transport_step,
    )
    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda, pressure_solve_torch
    from historymatching_tpu_torch.ops.stencil import face_fluxes
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.opt.cases import enopt_case

    # 11. K and P at 20x20 on step 21 of the 40 of the landscape batch (one
    # injector a member), warm-started from step 20's pressure as in
    # `simulate`, on the solver settings `npv` runs: simulate's float32
    # defaults, one P launch a step.
    case = enopt_case(device=dev)
    em, cfg = case.model, case.cfg
    nx, ny = em.shape
    fl = em.fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    B = case.cells.shape[0]
    land_m = em.replace(inj_xy=case.cells[:, None, :])
    path_kw = dict(tol=2e-3, maxiter=4 * max(nx, ny), patience_iters=96)
    half = ht.simulate(land_m, torch.zeros(em.Nxy, device=dev), cfg.dt, cfg.nTime // 2 - 1,
                       keep_wsats=False)
    s_prev = half.wsats[:, -1].reshape(B, nx, ny)
    q = _source_field(land_m, land_m.inj_rates[..., 0], land_m.prd_rates[..., 0]).contiguous()
    p_prev, Fx, Fy, *_ = pressure_step(land_m, s_prev, q, torch.zeros_like(s_prev),
                                       path_kw["tol"], path_kw["maxiter"], 5e-2)
    s_mid = transport_step(land_m, s_prev, Fx, Fy, q, cfg.dt)[0].contiguous()
    TX, TY, diag, sd, hier, Ainv = scaled_system(land_m, s_mid)
    args = (hier, Ainv, (q * sd).contiguous(), (p_prev * diag * sd).contiguous(),
            (diag * sd).contiguous())
    fixed = dict(tol=0.0, maxiter=8, patience_iters=160)
    p_k, _, _ = pressure_solve_cuda(*args, **fixed)
    p_t, _, _ = pressure_solve_torch(*args, **fixed)
    dn, nt = (p_k - p_t).norm(dim=(-2, -1)), p_t.norm(dim=(-2, -1))
    p_err = float(torch.where((dn == 0) & (nt == 0), 0.0, dn / nt).max())
    y, p_iters, _ = pressure_solve_cuda(*args, **path_kw)
    Fx, Fy = (F.contiguous() for F in face_fluxes(TX, TY, y * sd))
    nsub, dtspv = cfl_substeps(land_m, Fx, Fy, q, cfg.dt)
    t_args = (s_mid, Fx, Fy, q, dtspv, nsub, fluid)
    k_err = float((transport_substeps_cuda(*t_args) - transport_substeps_torch(*t_args)).abs().max())
    log(f"[11] 20x20 landscape step, N={B}, one injector a member: P vs plain, one window: max "
        f"rel |dp| = {p_err:.3e} (tol {P_TOL}); K vs plain: max|ds| = {k_err:.3e} (tol {K_TOL}); "
        f"cg_iters median {int(p_iters.median())} max {int(p_iters.max())}, substeps median "
        f"{int(nsub.median())} max {int(nsub.max())}")
    assert torch.isfinite(p_k).all() and p_err <= P_TOL and k_err <= K_TOL

    def sub(b):
        take = lambda t: t[:b].contiguous()  # noqa: E731
        return ([tuple(take(t) for t in lvl) for lvl in hier], take(Ainv), take(args[2]),
                take(args[3]), take(args[4])), tuple(take(t) for t in t_args[:6]) + (fluid,)

    # A launch's device time from the profiler; CUDA events around
    # back-to-back launches give the launch interval, which at this size the
    # host's submission may set rather than the kernel.
    figs = {"pressure_pcg": {}, "transport_upwind": {}}
    reps = 20
    for b in (B, EN_SMALL_B):
        pa, ta = sub(b)
        it_b = pressure_solve_cuda(*pa, **path_kw)[1]
        launch = {"pressure_pcg": lambda: pressure_solve_cuda(*pa, **path_kw),
                  "transport_upwind": lambda: transport_substeps_cuda(*ta)}
        bounds = {"pressure_pcg": pressure_bound_ms(pa[0], pa[1], it_b),
                  "transport_upwind": transport_bound_ms(ta[0], ta[1], ta[2], ta[3], ta[5])}
        tag = "" if b == B else f"_b{b}"
        said = []
        for name, fn in launch.items():
            interval = cuda_ms(fn, reps)
            ms = device_stages(lambda: [fn() for _ in range(reps)], reps)[0][name]
            bnd, by = bounds[name]
            figs[name].update({f"ms{tag}": ms, f"interval_ms{tag}": interval,
                               f"bound_ms{tag}": bnd, f"bound_by{tag}": by,
                               f"share_of_bound{tag}": bnd / ms})
            said.append(f"{'P' if name == 'pressure_pcg' else 'K'} {ms:.4f} ms on the device "
                        f"(launch interval {interval:.4f} ms), bound {bnd:.5f} ms ({by}, "
                        f"{bnd / ms:.1%})")
        log(f"[11] one launch at N={b} 20x20: " + "; ".join(said) + f"; cg_iters mean "
            f"{float(it_b.float().mean()):.1f}, substeps mean {float(ta[5].float().mean()):.1f}")
    figs["pressure_pcg"]["plain_ms"] = cuda_ms(lambda: pressure_solve_torch(*args, **path_kw), 1)
    figs["transport_upwind"]["plain_ms"] = cuda_ms(lambda: transport_substeps_torch(*t_args), 1)
    figs["pressure_pcg"]["max_abs_err"] = float((p_k - p_t).abs().max())
    figs["transport_upwind"]["max_abs_err"] = k_err
    log(f"[11] plain versions at N={B}: P {figs['pressure_pcg']['plain_ms']:.3f} ms, K "
        f"{figs['transport_upwind']['plain_ms']:.3f} ms")
    # Whether small batches leave the card idle: one npv call of the
    # landscape's 400 members and of a gradient batch's 40, profiled.
    for b in (B, EN_SMALL_B):
        call = lambda: ht.npv_value(em, cfg, inj_xy=case.cells[:b, None, :])  # noqa: E731
        stages, busy, wall_ms, acts = profile_steps(call, cfg.nTime)
        log(f"[11] profile, one npv call of N={b} (40 steps): per step " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in stages.items()) + f"; device busy {busy:.4f} ms of "
            f"{wall_ms:.4f} ms unprofiled wall, idle {1 - busy / wall_ms:.1%}; {acts:.1f} "
            f"device activities a step")

    def run(tag, fn):
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES[k] for k in JACOBI_KERNELS}
        assert all(v > 0 for v in launches.values()), (tag, launches)
        assert _build.LAUNCHES["pressure_pcg_cheb"] == 0, tag
        for name, v in launches.items():
            figs[name]["launches"] = figs[name].get("launches", 0) + v
        return out, wall, launches

    # 12. the exhaustive landscape: 400 injector positions, one npv batch
    land, wall, launches = run("12", lambda: ht.npv_value(em, cfg, inj_xy=case.cells[:, None, :]))
    assert land.shape == (B,) and torch.isfinite(land).all()
    assert launches == {"pressure_pcg": cfg.nTime, "transport_upwind": cfg.nTime}, launches
    land = land.double().cpu().numpy()
    ref = case.landscape
    arg, arg_ref = int(np.argmax(land)), int(np.argmax(ref))
    cell = lambda i: (int(i % nx), int(i // nx))  # noqa: E731  (ix, iy); cells run x fastest
    both = (land != 0) & (ref != 0)
    rel = np.abs(land - ref)[both] / np.abs(ref[both])
    gate = np.flatnonzero((land == 0) != (ref == 0))
    log(f"[12] landscape, {B} injector positions in one npv batch: {wall:.3f} s; max "
        f"{land[arg]:.4f} at cell {cell(arg)} (JAX float64: {ref[arg_ref]:.4f} at "
        f"{cell(arg_ref)}); zeroed by the gate {int((land == 0).sum())} (JAX float64 "
        f"{int((ref == 0).sum())}); over the {int(both.sum())} cells both accept, relative "
        f"difference median {np.median(rel):.3e} max {rel.max():.3e}; launches {launches}")
    log(f"[12] cells where the card's float32 and JAX's float64 disagree about the gate "
        f"(card value, JAX value): " + ", ".join(
            f"{cell(i)} ({land[i]:.2f}, {ref[i]:.2f})" for i in gate))
    assert max(abs(a - b) for a, b in zip(cell(arg), cell(arg_ref))) <= 1
    assert abs(land[arg] - ref[arg_ref]) <= 0.02 * abs(ref[arg_ref])

    # 13. the bench's gd_scan_multi from the fixture's starts and draws
    def obj(U):
        return ht.npv_value(em, cfg, inj_xy=U.reshape(-1, 1, 2))

    (paths, objs, info), wall, launches = run("13", lambda: ht.gd_scan_multi(
        obj, case.U0, chol=EN_CHOL, nEns=EN_NENS, nIter=EN_ITERS, Z=case.Z))
    objs = objs.double().cpu().numpy()
    best = int(np.argmax(objs[:, -1]))
    gap = land[arg] - objs[best, -1]
    log(f"[13] gd_scan_multi, {len(objs)} starts x ({EN_NENS} perturbations + 8 trials), "
        f"{EN_ITERS} iterations: {wall:.3f} s; nIter per start {info['nIter'].tolist()}; NPV "
        f"start -> end {[f'{a:.3f} -> {b:.3f}' for a, b in objs[:, [0, -1]]]}; best {objs[best, -1]:.4f} "
        f"at {[round(float(v), 3) for v in paths[best, -1]]}, gap to the landscape max "
        f"{gap:.4f} ({gap / abs(land[arg]):.2%}); launches {launches}")
    assert np.isfinite(objs).all() and paths.shape == (len(objs), EN_ITERS + 1, 2)
    assert objs[best, -1] >= land[arg] - 0.02 * abs(land[arg])
    assert (objs[:, -1] > objs[:, 0]).any()

    # 14. robust EnOpt over a permeability ensemble: obj1(u, x) the NPV with
    # the injector at u and permeability x; the robust objective its mean
    # over the ensemble, so one trial batch is 8 x 31 members.
    pre = ht.sample_prior_perm(gen, em.grid, ROBUST_N, r=0.8, device=dev)
    X = 0.1 + torch.exp(5 * pre)  # (31, Nxy) permeability fields
    rows = []

    def obj1(U, Xb):
        rows.append(len(U))
        Kx = Xb.reshape(-1, nx, ny)
        return ht.npv_value(em, cfg, inj_xy=U.reshape(-1, 1, 2), K=torch.stack([Kx, Kx], 1))

    obj_robust = ht.robust_mean(obj1, X)  # one npv call of len(U) x 31 members
    u0 = torch.rand(2, generator=gen, device=dev) * torch.tensor([em.Lx, em.Ly], device=dev)
    robust = {}
    for strategy, n_iter in (("StoSAG", ROBUST_ITERS), ("Paired", ROBUST_SHORT_ITERS),
                             ("Mean-model", ROBUST_SHORT_ITERS)):
        rows.clear()
        if strategy == "StoSAG":  # [25] replays this run on a mesh
            robust = dict(obj_ux=obj1, X=X, u0=u0, gen_state=gen.get_state())
        nabla = ht.EnGrad(chol=EN_CHOL, nEns=ROBUST_N, robustly=strategy, obj_ux=obj1, X=X)
        (path, objs_r, info_r), wall, launches = run("14", lambda: ht.GD(
            obj_robust, u0, nabla=nabla, nIter=n_iter, generator=gen))
        if strategy == "StoSAG":
            robust.update(launches=launches, path=path, wall=wall)
        objs_r = objs_r.double().cpu().numpy()
        log(f"[14] robust {strategy}, {ROBUST_N} permeability fields, {n_iter} iterations: "
            f"{wall:.3f} s; {info_r['cause']} after {info_r['nIter']} (accepted "
            f"{len(objs_r) - 1}); J {objs_r[0]:.4f} -> {objs_r[-1]:.4f} at "
            f"{[round(float(v), 3) for v in path[-1]]}; members per objective call "
            f"{sorted(set(rows))} in {len(rows)} calls; launches {launches}")
        assert np.isfinite(objs_r).all() and (np.diff(objs_r) > 0).all()
        assert set(rows) <= {2 * ROBUST_N if strategy == "StoSAG" else ROBUST_N,
                             ROBUST_N, 8 * ROBUST_N}, rows
    return figs, robust


def iteration_us(ms, resident, iters):
    """An estimate of a P-cl iteration's (or a K-cl substep's) time in
    microseconds, from a launch of `ms` over len(iters) members with
    `resident` clusters on the card at once: ms x min(resident, members) /
    members / mean iterations (substeps). It takes every resident cluster
    as busy for the whole launch, so it counts the last wave's idle tail as
    iteration time."""
    n = len(iters)
    return 1e3 * ms * min(resident, n) / n / float(iters.float().mean())


def cl_iteration_barriers(args, unit, plan):
    """The cluster barriers of one CG iteration of P-cl's Jacobi V-cycle on
    `plan`, as its probe build counts them on member 0 of P's arguments
    `args`: a window of one iteration and one of two (tol 0, so neither
    stops early), the difference of their counts."""
    import ctypes

    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda

    hier, Ainv, q, p0, w = args
    one = ([tuple(t[:1] for t in lvl) for lvl in hier], Ainv[:1], q[:1], p0[:1], w[:1])
    lib = _build.pressure_cl_lib(*q.shape[1:], *plan, True)
    got, counts = ctypes.c_uint(), []
    for k in (1, 2):
        _build.check(lib.hm_pressure_cl_barriers(ctypes.byref(got)), "probe")  # from 0
        pressure_solve_cuda(*one, tol=0.0, maxiter=k, restart_every=k, unit_diag=unit,
                            plan=plan, probe=True)
        _build.check(lib.hm_pressure_cl_barriers(ctypes.byref(got)), "probe")
        counts.append(got.value)
    return counts[1] - counts[0]


def rel_err(p_k, p_t):
    """Largest per-member relative difference; zero from both counts as
    agreement (a member whose weighted residual never improved on its
    start returns the start from both)."""
    import torch

    dn, nt = (p_k - p_t).norm(dim=(-2, -1)), p_t.norm(dim=(-2, -1))
    return float(torch.where((dn == 0) & (nt == 0), 0.0, dn / nt).max())


def grid_model(torch, Nx, Ny):
    """The flagship geometry (2x1 domain, centre injector, 4 producers) on
    an Nx x Ny grid."""
    import numpy as np

    from historymatching_tpu_torch import ResSim

    near01 = np.array([0.12, 0.87])
    prd_xy = [[x, y] for y in near01 for x in 2.0 * near01]
    return ResSim.build(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0, inj_xy=[[1.0, 0.5]], prd_xy=prd_xy,
                        inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4, dtype=torch.float32)


def new_grid_phases(dev, six):
    """Phases 18-20. `six` holds [6]'s step at N=1000 64x64: the unscaled
    model, states, the templated K's and the P kernels' times. Returns the
    figures of the new instantiations for the kernels' record."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import (
        _source_field,
        _tpfa,
        cfl_substeps,
        pressure_step,
        scaled_system,
    )
    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.ops.multigrid import build_hierarchy, coarse_inverse, n_levels
    from historymatching_tpu_torch.ops.pressure import (
        kernel_name,
        pressure_solve_cuda,
        pressure_solve_torch,
        smem_bytes,
    )
    from historymatching_tpu_torch.ops.transport import (
        rt_plan,
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    gen = torch.Generator(device=dev).manual_seed(SEED + 18)

    def system(mm, qf, unit):
        """P's arguments for fields `mm` at s = 0: the scaled system, or the
        unscaled one (`unit` False) with w = 1."""
        B, (Nx, Ny) = mm.K.shape[0], mm.shape
        s0 = torch.zeros(B, Nx, Ny, device=dev)
        if unit:
            _, _, diag, sd, hier, Ainv = scaled_system(mm, s0)
            return (hier, Ainv, (qf * sd).contiguous(), torch.zeros_like(sd),
                    (diag * sd).contiguous())
        TX, TY, _, pin = _tpfa(mm, s0)
        hier = build_hierarchy(TX, TY, pin)
        q = qf.expand(B, Nx, Ny).contiguous()
        return hier, coarse_inverse(hier), q, torch.zeros_like(q), torch.ones_like(q)

    def one_window(tag, args, **kw):
        """P against its plain version after `WINDOW4`, logged and held to
        P_TOL. Returns (max rel, max abs) difference."""
        p_k = pressure_solve_cuda(*args, **WINDOW4, **kw)[0]
        p_t = pressure_solve_torch(*args, **WINDOW4, **kw)[0]
        err = rel_err(p_k, p_t)
        log(f"{tag}: one window of 4 iterations, max rel |dp| vs plain = {err:.3e} (tol {P_TOL})")
        assert torch.isfinite(p_k).all() and err <= P_TOL
        return err, float((p_k - p_t).abs().max())
    figs = {"transport_upwind_rt": {"grids": {}}, "transport_upwind_rt1": {"grids": {}},
            "pressure_pcg": {"grids": {}},
            "pressure_pcg_cheb": {"grids": {}}, "pressure_pcg_diag": {"grids": {}},
            "pressure_pcg_cheb_diag": {"grids": {}}}
    base1 = {k: BASE[k] for k in SOLVE_KEYS}

    # 18. K-rt, the strip body built for each grid, on a real step: 5 steps
    # of simulate, then the sixth step's pressure solve and CFL counts; K-rt1
    # (the runtime-grid body K-rt was before) forced beside it.
    for Nx, Ny in K_RT_GRIDS:
        m = grid_model(torch, Nx, Ny)
        mm = set_perm(m, ht.sample_prior_perm(gen, m, NEW_N, r=0.8))
        s5 = ht.simulate(mm, torch.zeros(m.Nxy, device=dev), DT, 5,
                         keep_wsats=False).wsats[:, -1].reshape(NEW_N, Nx, Ny).contiguous()
        q = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
        _, Fx, Fy, it, ok, _ = pressure_step(mm, s5, q, torch.zeros_like(s5), 2e-3,
                                             4 * max(Nx, Ny), 5e-2)
        Fx, Fy = Fx.contiguous(), Fy.contiguous()
        nsub, dtspv = cfl_substeps(mm, Fx, Fy, q, DT)
        args = (s5, Fx, Fy, q[None].contiguous(), dtspv, nsub, fluid_of(m))
        s_k, n = launched(lambda: transport_substeps_cuda(*args, force="rt"))  # 80x80's route: K-cl
        assert n == {"transport_upwind_rt": 1}, n
        s_t = transport_substeps_torch(*args)
        err = float((s_k - s_t).abs().max())
        assert torch.equal(s_k, s_t), (Nx, Ny, err)
        assert torch.equal(transport_substeps_cuda(*args, force="rt1"), s_t), (Nx, Ny)
        ms = cuda_ms(lambda: transport_substeps_cuda(*args, force="rt"), 5)
        rt1_ms = cuda_ms(lambda: transport_substeps_cuda(*args, force="rt1"), 5)
        plain_ms = cuda_ms(lambda: transport_substeps_torch(*args), 1)
        bnd, by = transport_bound_ms(s5, Fx, Fy, args[3], nsub)
        plan = rt_plan(Nx, Ny)
        figs["transport_upwind_rt"]["grids"][f"{Nx}x{Ny}"] = dict(
            ms=ms, rt1_ms=rt1_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
            share_of_bound=bnd / ms, max_abs_err=err, plan=plan)
        figs["transport_upwind_rt1"]["grids"][f"{Nx}x{Ny}"] = dict(
            ms=rt1_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / rt1_ms,
            max_abs_err=0.0, forced=True)
        log(f"[18] K-rt {Nx}x{Ny} (strips of {plan[0]} rows, faces in {plan[1]}), N={NEW_N}, step "
            f"6 of a prior run (cg_iters median {int(it.median())}, accepted {int(ok.sum())}/"
            f"{NEW_N}): max|ds| vs plain = {err:.3e} (K-rt1 too); substeps median "
            f"{int(nsub.median())} max {int(nsub.max())}; {ms:.4f} ms a launch against K-rt1's "
            f"{rt1_ms:.4f} ms ({rt1_ms / ms:.2f}x), plain {plain_ms:.3f} ms, bound {bnd:.5f} ms "
            f"({by}, K-rt {bnd / ms:.1%}, K-rt1 {bnd / rt1_ms:.1%})")
    t_args = six["t_args"]
    s_t = transport_substeps_torch(*t_args)
    for force in ("rt", "rt1"):  # K-rt built for 64x64, forced
        assert torch.equal(transport_substeps_cuda(*t_args, force=force), s_t), force
    rt_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="rt"), 5)
    rt1_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="rt1"), 5)
    tpl_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args), 5)
    bnd, by = transport_bound_ms(*t_args[:4], t_args[5])
    log(f"[18] K at {NX}x{NY}, N={N}, [6]'s inputs: K-rt built for the grid {rt_ms:.3f} ms, "
        f"K-rt1 {rt1_ms:.3f} ms, templated {tpl_ms:.3f} ms (at [6]: {six['t_ms']:.3f} ms), bound "
        f"{bnd:.4f} ms ({by}; K-rt {bnd / rt_ms:.1%}); K-rt and K-rt1 max|ds| vs plain 0")
    figs["transport_upwind_rt"].update(max_abs_err=0.0, ms=rt_ms, plain_ms=six["t_plain_ms"],
                                       bound_ms=bnd, bound_by=by, templated_ms=tpl_ms,
                                       rt1_ms=rt1_ms)
    figs["transport_upwind_rt1"]["forced_64x64"] = dict(ms=rt1_ms, rt_ms=rt_ms,
                                                        templated_ms=tpl_ms)

    # 19. P built for new grids, on scaled hierarchies of prior fields at s = 0
    B = P_NEW_N
    for Nx, Ny in P_NEW_GRIDS:
        m = grid_model(torch, Nx, Ny)
        mm = set_perm(m, ht.sample_prior_perm(gen, m, B, r=0.8))
        qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
        args = system(mm, qf, True)
        hier, Ainv = args[:2]
        for smoother in ("jacobi", "cheb"):
            name = kernel_name(smoother)
            err = one_window(f"[19] P {smoother} {Nx}x{Ny}, N={B}", args, smoother=smoother)[0]
            _, it_k, rl_k = pressure_solve_cuda(*args, **base1, smoother=smoother)
            _, it_t, rl_t = pressure_solve_torch(*args, **base1, smoother=smoother)
            ms = cuda_ms(lambda: pressure_solve_cuda(*args, **base1, smoother=smoother), 3)
            plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **base1, smoother=smoother),
                               1)
            vf = P_FLOPS_VCYCLE_CHEB if smoother == "cheb" else P_FLOPS_VCYCLE
            bnd, by = pressure_bound_ms(hier, Ainv, it_k, vf)
            figs[name]["grids"][f"{Nx}x{Ny}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
                max_rel_err=err, accepted=int((rl_k <= 5e-2).sum()),
                accepted_plain=int((rl_t <= 5e-2).sum()))
            log(f"[19] P {smoother} {Nx}x{Ny}, N={B}: bench settings: accepted kernel "
                f"{int((rl_k <= 5e-2).sum())}/{B}, plain {int((rl_t <= 5e-2).sum())}/{B}, "
                f"iterations median {int(it_k.median())} vs {int(it_t.median())}; {ms:.3f} ms "
                f"a launch vs plain {plain_ms:.3f} ms, bound {bnd:.5f} ms ({by}, {bnd / ms:.1%})")

    # 19b. P with an explicit fine diagonal, on the unscaled system
    for Nx, Ny in P_DIAG_GRIDS:
        m = grid_model(torch, Nx, Ny)
        pre = ht.sample_prior_perm(gen, m, B, r=0.8)
        qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
        args = system(set_perm(m, pre), qf, False)
        mild = system(set_perm(m, MILD * pre), qf, False)
        for smoother in ("jacobi", "cheb"):
            kw = dict(smoother=smoother, unit_diag=False)
            err, abs_err = one_window(f"[19b] P {smoother}, explicit fine diagonal, {Nx}x{Ny}, "
                                      f"N={B}, the prior times {MILD}", mild, **kw)
            name = kernel_name(smoother, False)
            figs[name]["max_abs_err"] = max(figs[name].get("max_abs_err", 0.0), abs_err)
            _, it_k, rl_k = pressure_solve_cuda(*args, **base1, **kw)
            _, it_t, rl_t = pressure_solve_torch(*args, **base1, **kw)
            figs[name]["grids"][f"{Nx}x{Ny}"] = dict(
                max_rel_err=err, accepted=int((rl_k <= 5e-2).sum()),
                accepted_plain=int((rl_t <= 5e-2).sum()))
            log(f"[19b] P {smoother}, explicit fine diagonal, {Nx}x{Ny}, N={B}: bench settings: "
                f"accepted kernel {int((rl_k <= 5e-2).sum())}/{B}, plain "
                f"{int((rl_t <= 5e-2).sum())}/{B}, iterations median {int(it_k.median())} vs "
                f"{int(it_t.median())}")
    # ... at [6]'s shapes: the unscaled system of [6]'s states, N=1000 64x64
    TX, TY, _, pin = _tpfa(six["mm"], six["s_end"])
    hier = build_hierarchy(TX, TY, pin)
    Ainv = coarse_inverse(hier)
    q1 = six["q1"].expand(N, NX, NY).contiguous()
    args = (hier, Ainv, q1, torch.zeros_like(q1), torch.ones_like(q1))
    for smoother in ("jacobi", "cheb"):
        kw = dict(six["kw"], smoother=smoother, unit_diag=False)
        name = kernel_name(smoother, False)
        ms = cuda_ms(lambda: pressure_solve_cuda(*args, **kw), 3)
        plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **kw), 1)
        it_k = pressure_solve_cuda(*args, **kw)[1]
        vf = P_FLOPS_VCYCLE_CHEB if smoother == "cheb" else P_FLOPS_VCYCLE
        bnd, by = pressure_bound_ms(hier, Ainv, it_k, vf, P_FLOPS_FINE + P_FLOPS_DIAG)
        unit_ms = six["p_ms"][smoother]
        figs[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by)
        log(f"[19b] P {smoother}, explicit fine diagonal, N={N} {NX}x{NY} ([6]'s states, "
            f"maxiter {kw['maxiter']}): {ms:.3f} ms a launch vs plain {plain_ms:.3f} ms, bound "
            f"{bnd:.4f} ms ({by}, {bnd / ms:.1%}); cg_iters median {int(it_k.median())}; the "
            f"scaled system's P {smoother} at [6]/[15]: {unit_ms:.3f} ms")
    # ... and through the entry point: simulate(scale_system=False)
    m = grid_model(torch, 20, 20)
    mm = set_perm(m, ht.sample_prior_perm(gen, m, B, r=0.8))
    for smoother in ("jacobi", "cheb"):
        _build.reset_launches()
        t0 = time.perf_counter()
        res = ht.simulate(mm, torch.zeros(m.Nxy, device=dev), DT, NTIME, smoother=smoother,
                          scale_system=False)
        sync()
        wall = time.perf_counter() - t0
        name = kernel_name(smoother, False)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        figs[name]["launches"] = launches.get(name, 0)
        log(f"[19b] simulate(scale_system=False, smoother={smoother!r}), N={B} 20x20, {NTIME} "
            f"steps: {wall:.3f} s; cg_ok {float(res.cg_ok.float().mean()):.1%}, cg_iters median "
            f"{int(res.cg_iters.median())}; launches {launches}")
        assert launches == {name: NTIME, "transport_upwind": NTIME}, launches
        assert torch.isfinite(res.wsats).all()

    # 19c. resources of the new instantiations, and the refusal by bytes
    for name in ("pressure_pcg", "pressure_pcg_cheb"):
        for grid in P_NEW_GRIDS:
            info = _build.kernel_info(name, *grid)
            figs[name]["grids"][f"{grid[0]}x{grid[1]}"]["resources"] = info
            log(f"[19c] {name} {grid[0]}x{grid[1]}: {info}")
    for name in ("pressure_pcg_diag", "pressure_pcg_cheb_diag"):
        for grid in P_DIAG_GRIDS + P_NEW_GRIDS:
            info = _build.kernel_info(name, *grid)
            figs[name]["grids"].setdefault(f"{grid[0]}x{grid[1]}", {})["resources"] = info
            log(f"[19c] {name} {grid[0]}x{grid[1]}: {info}")
    for grid in K_RT_GRIDS + ((NX, NY),):
        for name in ("transport_upwind_rt", "transport_upwind_rt1"):
            info = _build.kernel_info(name, *grid)
            figs[name]["grids"].setdefault(f"{grid[0]}x{grid[1]}", {})["resources"] = info
            log(f"[19c] {name} {grid[0]}x{grid[1]}: {info}")
            assert info["local_bytes"] == 0, (name, grid, info)
    big = grid_model(torch, *GM_GRID)
    _build.reset_launches()
    res = ht.simulate(set_perm(big, torch.zeros(2, big.Nxy, device=dev)),
                      torch.zeros(big.Nxy, device=dev), DT, 1)
    sync()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    log(f"[19c] simulate at {GM_GRID[0]}x{GM_GRID[1]} on the card (P's layout "
        f"{smem_bytes(*GM_GRID, n_levels(*GM_GRID))} bytes): launches {launches}")
    assert launches == {"pressure_pcg_cl": 1, "transport_upwind_cl": 1}, launches
    assert torch.isfinite(res.wsats).all()

    # 20. one member's coarse Cholesky fails: [4]'s geometry, N=64 prior
    # fields, member 5's coarsest diagonal halved (no longer dominant, so
    # indefinite)
    m = grid_model(torch, NX, NY)
    mm = set_perm(m, ht.sample_prior_perm(gen, m, NEW_N, r=0.8))
    _, _, diag, sd, hier, Ainv = scaled_system(mm, torch.zeros(NEW_N, NX, NY, device=dev))
    TXc, TYc, Dc = hier[-1]
    Dc = Dc.clone()
    Dc[5] = 0.5 * Dc[5]
    hier_f = hier[:-1] + [(TXc, TYc, Dc)]
    Ainv_f = coarse_inverse(hier_f)
    keep = torch.arange(NEW_N, device=dev) != 5
    qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
    solve = lambda h, A: pressure_solve_cuda(h, A, (qf * sd).contiguous(),  # noqa: E731
                                             torch.zeros_like(sd), (diag * sd).contiguous(),
                                             **base1)
    p_f, it_f, rel_f = solve(hier_f, Ainv_f)
    p_0, it_0, rel_0 = solve(hier, Ainv)
    same = bool(torch.equal(Ainv_f[keep], Ainv[keep]))
    log(f"[20] member 5 of {NEW_N} with an indefinite coarse operator: inverse finite "
        f"{bool(torch.isfinite(Ainv_f[5]).all())}; the other members' inverses equal the unforced "
        f"run's: {same}; their solves equal: {bool(torch.equal(p_f[keep], p_0[keep]))}; member 5: "
        f"{int(it_f[5])} iterations, rel {float(rel_f[5]):.3e} (unforced {int(it_0[5])}, "
        f"{float(rel_0[5]):.3e})")
    assert same and bool(torch.isfinite(Ainv_f).all()) and bool(torch.isfinite(p_f).all())
    assert torch.equal(p_f[keep], p_0[keep])
    return figs


def launched(fn):
    """fn() and the launches it made, by kernel."""
    from historymatching_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    out = fn()
    sync()
    return out, {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}


def p_system(mm, qf, unit):
    """P's arguments at s = 0 for the members of model `mm`: the scaled
    system, or the unscaled one (w = 1), as [19]."""
    import torch

    from historymatching_tpu_torch.models.ressim import _tpfa, scaled_system
    from historymatching_tpu_torch.ops.multigrid import build_hierarchy, coarse_inverse

    B, (Nx, Ny) = mm.K.shape[0], mm.shape
    s0 = torch.zeros(B, Nx, Ny, device=mm.K.device)
    if unit:
        _, _, diag, sd, hier, Ainv = scaled_system(mm, s0)
        return (hier, Ainv, (qf * sd).contiguous(), torch.zeros_like(sd),
                (diag * sd).contiguous())
    TX, TY, _, pin = _tpfa(mm, s0)
    hier = build_hierarchy(TX, TY, pin)
    q = qf.expand(B, Nx, Ny).contiguous()
    return hier, coarse_inverse(hier), q, torch.zeros_like(q), torch.ones_like(q)


def large_grid_phases(dev, six):
    """Phase 23. Returns the figures of the cluster and device-memory
    variants for the kernels' record."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, pressure, transport
    from historymatching_tpu_torch.ops.multigrid import n_levels
    from historymatching_tpu_torch.ops.pressure import (
        cl_bytes,
        cl_inverse_rows,
        cl_plan,
        gm1_plan,
        gm_plan,
        kernel_name,
        pressure_solve_cuda,
        pressure_solve_torch,
        smem_bytes,
    )
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    base1 = {k: BASE[k] for k in SOLVE_KEYS}
    names = [kernel_name(sm, unit, rt) for rt in ("cl", "gm", "gm1") for sm, unit in P_GM] + [
        "transport_upwind_cl", "transport_upwind_gm", "transport_upwind_gm1",
        "transport_upwind_rt", "transport_upwind_rt1"]
    figs = {name: {"grids": {}, "max_abs_err": 0.0} for name in names}

    def p_run(tag, args, smoother, unit, force, plan=None):
        """One window against the plain version, then one launch at bench
        settings timed; the route's figures (P-cl on `plan`, else the
        grid's), and for P-cl an estimate of an iteration's time
        (`iteration_us`)."""
        kw = dict(smoother=smoother, unit_diag=unit, force=force, plan=plan)
        name = kernel_name(smoother, unit, force)
        (p_k, _, _), n = launched(lambda: pressure_solve_cuda(*args, **WINDOW4, **kw))
        assert n == {name: 1}, n
        p_t = pressure_solve_torch(*args, **WINDOW4, smoother=smoother, unit_diag=unit)[0]
        err, abs_err = rel_err(p_k, p_t), float((p_k - p_t).abs().max())
        assert torch.isfinite(p_k).all() and err <= P_TOL, (tag, name, err)
        _, it_k, rl_k = pressure_solve_cuda(*args, **base1, **kw)
        ms = cuda_ms(lambda: pressure_solve_cuda(*args, **base1, **kw), 5)
        vf = P_FLOPS_VCYCLE_CHEB if smoother == "cheb" else P_FLOPS_VCYCLE
        bnd, by = pressure_bound_ms(args[0], args[1], it_k, vf,
                                    P_FLOPS_FINE + (0 if unit else P_FLOPS_DIAG))
        fig = dict(ms=ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms, max_rel_err=err,
                   max_abs_err=abs_err, iters_median=int(it_k.median()),
                   accepted=int((rl_k <= 5e-2).sum()))
        est = None
        if force == "cl":
            c, place = plan or cl_plan(*args[2].shape[1:], unit)
            rows = cl_inverse_rows(args[1].shape[-1], c)[0]
            res = _build.kernel_info(name, *args[2].shape[1:], (c, place))
            fig.update(cluster=c, inverse=place, rank_bytes=cl_bytes(
                *args[2].shape[1:], len(args[0]), c, unit, place),
                       inverse_rows=rows[1] - rows[0] if place == "distributed" else None,
                       resources=res)
            est = iteration_us(ms, res["max_active_clusters"], it_k)
        # the in-place plan beside P-cl/d is kept under its own key
        figs[name]["grids"][tag if plan is None else f"{tag} c={plan[0]} {plan[1]}"] = fig
        figs[name]["max_abs_err"] = max(figs[name]["max_abs_err"], abs_err)
        return name, fig, est

    for Nx, Ny in LARGE_GRIDS:
        tag = f"{Nx}x{Ny}"
        levels = n_levels(Nx, Ny)
        m = grid_model(torch, Nx, Ny)
        pre = ht.sample_prior_perm(gen, m, LARGE_N, r=0.8)
        qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
        systems = {True: p_system(set_perm(m, pre), qf, True),
                   False: p_system(set_perm(m, MILD * pre), qf, False)}
        nc = systems[True][1].shape[-1]
        said = []
        for smoother, unit in P_GM:
            rt = pressure.route(Nx, Ny, unit, LARGE_N)
            limit = P_GM_PAST.get((Nx, Ny, unit))
            assert rt == ("gm1" if limit and LARGE_N > limit else "cl"), (tag, unit, rt)
            # P-cl on the grid's plan, on its route or forced; beside P-cl/d
            # the plan that reads the inverse in place; P-gm1 forced, and
            # P-gm at the grid whose route takes the batch
            plan = cl_plan(Nx, Ny, unit)
            runs = [("cl", None)] if plan else []
            if plan and plan[1] == "distributed" and cl_plan(Nx, Ny, unit, "device"):
                runs.append(("cl", cl_plan(Nx, Ny, unit, "device")))
            runs.append(("gm1", None))
            if (Nx, Ny) == (100, 100):  # P-gm lost to P-gm1 past P-cl/d's batch
                runs.append(("gm", None))
            for force, plan_k in runs:
                name, fig, est = p_run(tag, systems[unit], smoother, unit, force, plan_k)
                layer_cl = pressure.route(*LAYER_GRIDS[0], True, N) == "cl"
                if force == "cl" and plan_k is None and ((Nx, Ny) == BIG or (
                        (Nx, Ny) == LAYER_GRIDS[0]
                        and ((smoother, unit) != ("jacobi", True) or not layer_cl))):
                    # the plain version, at [24]'s grid and at P-cl/d's path's
                    # ([24b] times it for the Jacobi instantiation where
                    # [24b]'s route is P-cl/d)
                    fig["plain_ms"] = cuda_ms(lambda: pressure_solve_torch(
                        *systems[unit], **base1, smoother=smoother, unit_diag=unit), 1)
                said.append(f"{name}{'' if plan_k is None else ' ' + str(plan_k)} window rel "
                            f"{fig['max_rel_err']:.2e}, {fig['ms']:.3f} ms "
                            f"(iterations median {fig['iters_median']}, accepted "
                            f"{fig['accepted']}/{LARGE_N}), bound {fig['bound_ms']:.4f} ms "
                            f"({fig['bound_by']}, {fig['share_of_bound']:.1%})"
                            + (f", plain {fig['plain_ms']:.3f} ms" if "plain_ms" in fig else "")
                            + (f", cluster {fig['cluster']} (inverse {fig['inverse']}, "
                               f"{fig['rank_bytes']} bytes a rank, {fig['inverse_rows']} inverse "
                               f"rows a rank; {fig['resources']}; an iteration ~{est:.2f} us, "
                               f"an estimate)" if "cluster" in fig else ""))
        log(f"[23] P {tag}, N={LARGE_N}, {levels} levels (coarsest {nc} cells), P layout "
            f"{smem_bytes(Nx, Ny, levels)} shared bytes, P-gm plan {gm_plan(Nx, Ny)}, P-gm1 "
            f"workspace {4 * gm1_plan(Nx, Ny).ws_floats} bytes a member, at bench settings: "
            + "; ".join(said))

        # K on step 6 of a prior run: its own route, the runtime-grid
        # variant where its tiles fit one block, and K-gm, forced
        mm = set_perm(m, pre)
        (res5, n_sim) = launched(lambda: ht.simulate(mm, torch.zeros(m.Nxy, device=dev), DT, 5,
                                                     keep_wsats=False))
        k_route = transport.route(Nx, Ny)
        assert n_sim == {kernel_name("jacobi", True, pressure.route(Nx, Ny, True, LARGE_N)): 5,
                         transport.NAMES[k_route]: 5}, n_sim
        if k_route == "rt":  # K-rt's path: 60x60
            figs["transport_upwind_rt"][f"launches_simulate_{tag}"] = n_sim["transport_upwind_rt"]
        s5 = res5.wsats[:, -1].reshape(LARGE_N, Nx, Ny).contiguous()
        _, Fx, Fy, it, ok, _ = pressure_step(mm, s5, qf, torch.zeros_like(s5), 2e-3,
                                             4 * max(Nx, Ny), 5e-2)
        Fx, Fy = Fx.contiguous(), Fy.contiguous()
        nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, DT)
        t_args = (s5, Fx, Fy, qf[None].contiguous(), dtspv, nsub, fluid_of(m))
        s_t = transport_substeps_torch(*t_args)
        fits = transport.smem_bytes(Nx, Ny) <= _build.SMEM_LIMIT
        k_ms, k_est = {}, None
        # the route; K-rt1 where its one-block plan fits, and where the two fw
        # tiles fit, K-rt on a strip plan
        rt1 = transport.rt1_plan(Nx, Ny)
        for force in dict.fromkeys((k_route, *(("rt1",) if rt1 else ()),
                                    *(("rt",) if fits and transport.rt_plan(Nx, Ny) else ()),
                                    "gm")):
            s_k, n = launched(lambda: transport_substeps_cuda(*t_args, force=force))
            assert n == {transport.NAMES[force]: 1} and torch.equal(s_k, s_t), (tag, force, n)
            k_ms[force] = cuda_ms(lambda: transport_substeps_cuda(*t_args, force=force),
                                  5 if force == "gm" else 10)
        bnd, by = transport_bound_ms(s5, Fx, Fy, t_args[3], nsub)
        plain_ms = cuda_ms(lambda: transport_substeps_torch(*t_args), 1) if (
            (Nx, Ny) in (BIG, (256, 256))) else None
        for force in ("cl", "gm"):
            if force in k_ms:
                fig = dict(ms=k_ms[force], bound_ms=bnd, bound_by=by,
                           share_of_bound=bnd / k_ms[force], max_abs_err=0.0, route=k_route,
                           forced_ms=k_ms, plain_ms=plain_ms,
                           substeps_median=int(nsub.median()))
                if force == "cl":
                    res = _build.kernel_info("transport_upwind_cl", Nx, Ny)
                    fig.update(plan=transport.cl_plan(Nx, Ny), resources=res)
                    k_est = iteration_us(k_ms[force], res["max_active_clusters"], nsub)
                else:
                    fig.update(resources=_build.kernel_info("transport_upwind_gm", Nx, Ny))
                figs[f"transport_upwind_{force}"]["grids"][tag] = fig
        log(f"[23] K {tag}, N={LARGE_N}, step 6 of a prior run (simulate's launches {n_sim}; "
            f"cg_iters median {int(it.median())}, accepted {int(ok.sum())}/{LARGE_N}): "
            f"substeps median {int(nsub.median())} max {int(nsub.max())}; route {k_route!r}"
            + (f" ({transport.cl_plan(Nx, Ny)}, a substep ~{k_est:.2f} us by estimate)"
               if k_route == "cl" else "")
            + "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in k_ms.items())
            + f", each bit for bit with the plain version; bound {bnd:.5f} ms ({by}, "
            f"{k_route} {bnd / k_ms[k_route]:.1%}, gm {bnd / k_ms['gm']:.1%}); K-gm "
            f"{figs['transport_upwind_gm']['grids'][tag]['resources']}"
            + (f"; plain {plain_ms:.3f} ms" if plain_ms else ""))

    # simulate through each instantiation: P-cl and K-cl at [24]'s grid,
    # P-cl/d and K-cl at 60x220; P-gm and K-gm at GM_PATH_GRID, past every
    # cluster
    for grid, rt, n_members in ((BIG, "cl", LARGE_N), ((60, 220), "cl", LARGE_N),
                                (GM_PATH_GRID, "gm", GM_PATH_N)):
        m = grid_model(torch, *grid)
        pre = ht.sample_prior_perm(gen, m, n_members, r=0.8)
        mm = set_perm(m, pre)
        k_name = transport.NAMES[transport.route(*grid)]
        assert k_name == f"transport_upwind_{rt}", (grid, k_name)
        for smoother, unit in P_GM:
            name = kernel_name(smoother, unit, rt)
            assert pressure.route(*grid, unit, n_members) == rt, (grid, unit)
            t0 = time.perf_counter()
            res, n = launched(lambda: ht.simulate(mm, torch.zeros(m.Nxy, device=dev), DT, 5,
                                                  smoother=smoother, scale_system=unit))
            figs[name][f"launches_simulate_{grid[0]}x{grid[1]}"] = n.get(name, 0)
            figs[k_name][f"launches_simulate_{grid[0]}x{grid[1]}"] = (
                figs[k_name].get(f"launches_simulate_{grid[0]}x{grid[1]}", 0) + n.get(k_name, 0))
            log(f"[23] simulate(smoother={smoother!r}, scale_system={unit}) at {grid[0]}x"
                f"{grid[1]}, N={n_members}, 5 steps: {time.perf_counter() - t0:.3f} s; launches "
                f"{n}; cg_ok {float(res.cg_ok.float().mean()):.1%}")
            assert n == {name: 5, k_name: 5}, n
            assert torch.isfinite(res.wsats).all()
        if rt == "gm":  # P-gm and K-gm a launch each on their path's shapes
            gm_path_kernels(figs, m, pre, res.wsats[:, -1].reshape(n_members, *grid).contiguous())
    gm1_path(figs, gen)
    route_paths(figs, gen)
    capacity_check(figs, gen)

    # the device-memory variants of PR 9's form forced at 64x64 on [6]'s
    # inputs (P-gm there, one block a member, is a card test's)
    args, kw = six["p_args"], six["kw"]
    p_g1 = pressure_solve_cuda(*args, **WINDOW4, force="gm1")[0]
    p_s = pressure_solve_cuda(*args, **WINDOW4)[0]
    p_t = pressure_solve_torch(*args, **WINDOW4)[0]
    err_g1, err_s = rel_err(p_g1, p_t), rel_err(p_s, p_t)
    assert err_g1 <= P_TOL, err_g1
    gm1_ms = cuda_ms(lambda: pressure_solve_cuda(*args, **kw, force="gm1"), 3)
    sm_ms = cuda_ms(lambda: pressure_solve_cuda(*args, **kw), 3)
    t_args = six["t_args"]
    k_err = float((transport_substeps_cuda(*t_args, force="gm")
                   - transport_substeps_torch(*t_args)).abs().max())
    assert k_err == 0.0, k_err
    assert torch.equal(transport_substeps_cuda(*t_args, force="gm1"),
                       transport_substeps_torch(*t_args))
    kgm_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="gm"), 5)
    kgm1_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="gm1"), 5)
    k_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args), 5)
    figs["pressure_pcg_gm1"]["forced_64x64"] = dict(ms=gm1_ms, smem_ms=sm_ms, max_rel_err=err_g1)
    figs["transport_upwind_gm"]["forced_64x64"] = dict(ms=kgm_ms, templated_ms=k_ms)
    figs["transport_upwind_gm1"]["forced_64x64"] = dict(ms=kgm1_ms, templated_ms=k_ms)
    log(f"[23] forced at {NX}x{NY}, N={N}, [6]'s inputs: P-gm1 {gm1_ms:.3f} ms a launch vs P "
        f"{sm_ms:.3f} ms (at [6]: {six['p_ms']['jacobi']:.3f} ms); one window max rel vs plain "
        f"P-gm1 {err_g1:.2e}, P {err_s:.2e}; K-gm "
        f"{kgm_ms:.3f} ms and K-gm1 {kgm1_ms:.3f} ms vs "
        f"K {k_ms:.3f} ms (at [6]: {six['t_ms']:.3f} ms), K-gm max|ds| vs plain {k_err:.1e}, "
        f"K-gm1 0")
    return figs


def gm_path_kernels(figs, m, pre, s5):
    """[23]'s path through P-gm and K-gm (GM_PATH_GRID): on the first step's
    system (s = 0; the unscaled one on the prior scaled by MILD) each P-gm
    instantiation on its route one window against the plain version, then a
    launch at bench settings timed with its bound, the plain version's time
    and P-gm1's (forced, held to the plain version the same way) beside it,
    and its resources (registers, spills, blocks a member, members in
    flight); K-gm on step 6 of the simulated run, bit for bit and timed
    with its bound. Into `figs`' grids."""
    import torch

    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, pressure
    from historymatching_tpu_torch.ops.pressure import (
        kernel_name,
        pressure_solve_cuda,
        pressure_solve_torch,
    )
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    mm = set_perm(m, pre)
    (Nx, Ny), tag, n = mm.shape, f"{mm.shape[0]}x{mm.shape[1]}", pre.shape[0]
    qf = _source_field(mm, mm.inj_rates[:, 0], mm.prd_rates[:, 0])
    systems = {True: p_system(mm, qf, True), False: p_system(set_perm(m, MILD * pre), qf, False)}
    base1 = {k: BASE[k] for k in SOLVE_KEYS}
    said = []
    for smoother, unit in P_GM:
        args, kw = systems[unit], dict(smoother=smoother, unit_diag=unit)
        name, name1 = (kernel_name(smoother, unit, rt) for rt in ("gm", "gm1"))
        assert pressure.route(Nx, Ny, unit, n) == "gm", (tag, unit)
        p_t = pressure_solve_torch(*args, **WINDOW4, **kw)[0]
        (p_k, _, _), nl = launched(lambda: pressure_solve_cuda(*args, **WINDOW4, **kw))
        assert nl == {name: 1}, nl
        p_k1 = pressure_solve_cuda(*args, **WINDOW4, **kw, force="gm1")[0]
        err, err1 = rel_err(p_k, p_t), rel_err(p_k1, p_t)
        assert bool(torch.isfinite(p_k).all()) and err <= P_TOL and err1 <= P_TOL, (
            name, err, err1)
        _, it, rl = pressure_solve_cuda(*args, **base1, **kw)
        ms = cuda_ms(lambda: pressure_solve_cuda(*args, **base1, **kw), 3)
        ms1 = cuda_ms(lambda: pressure_solve_cuda(*args, **base1, **kw, force="gm1"), 2)
        plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **base1, **kw), 1, warm=False)
        vf = P_FLOPS_VCYCLE_CHEB if smoother == "cheb" else P_FLOPS_VCYCLE
        bnd, by = pressure_bound_ms(args[0], args[1], it, vf,
                                    P_FLOPS_FINE + (0 if unit else P_FLOPS_DIAG))
        res = _build.kernel_info(name, Nx, Ny)
        assert res["local_bytes"] == 0, (name, res)  # no spills on the path
        common = dict(bound_ms=bnd, bound_by=by, plain_ms=plain_ms, iters_median=int(it.median()),
                      accepted=int((rl <= 5e-2).sum()))
        figs[name]["grids"][tag] = dict(
            common, ms=ms, share_of_bound=bnd / ms, max_rel_err=err,
            max_abs_err=float((p_k - p_t).abs().max()), gm1_ms=ms1, resources=res)
        figs[name]["max_abs_err"] = max(figs[name]["max_abs_err"],
                                        figs[name]["grids"][tag]["max_abs_err"])
        figs[name1]["grids"][tag] = dict(
            common, ms=ms1, share_of_bound=bnd / ms1, max_rel_err=err1,
            max_abs_err=float((p_k1 - p_t).abs().max()), forced=True)
        figs[name1]["max_abs_err"] = max(figs[name1]["max_abs_err"],
                                         figs[name1]["grids"][tag]["max_abs_err"])
        said.append(f"{name} window rel {err:.2e} (P-gm1 {err1:.2e}), {ms:.3f} ms a launch "
                    f"against P-gm1's {ms1:.3f} (iterations median {int(it.median())}), bound "
                    f"{bnd:.4f} ms ({by}, {bnd / ms:.1%}; P-gm1 {bnd / ms1:.1%}), plain "
                    f"{plain_ms:.3f} ms; {res}")
    log(f"[23] P on its device-memory path at {tag}, N={n}, the first step's system at bench "
        f"settings: " + "; ".join(said))
    mm = set_perm(m, pre)
    _, Fx, Fy, _, _, _ = pressure_step(mm, s5, qf, torch.zeros_like(s5), 2e-3, 4 * max(Nx, Ny),
                                       5e-2)
    Fx, Fy = Fx.contiguous(), Fy.contiguous()
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, DT)
    t_args = (s5, Fx, Fy, qf[None].contiguous(), dtspv, nsub, fluid_of(mm))
    s_t = transport_substeps_torch(*t_args)
    for force in ("gm", "gm1"):  # K-gm on its route, beside K-gm1
        assert torch.equal(transport_substeps_cuda(*t_args, force=force), s_t), force
    k_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="gm"), 5)
    k1_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="gm1"), 3)
    k_plain_ms = cuda_ms(lambda: transport_substeps_torch(*t_args), 1)
    k_bnd, k_by = transport_bound_ms(s5, Fx, Fy, t_args[3], nsub)
    res = _build.kernel_info("transport_upwind_gm", Nx, Ny)
    figs["transport_upwind_gm"]["grids"][tag] = dict(
        ms=k_ms, bound_ms=k_bnd, bound_by=k_by, share_of_bound=k_bnd / k_ms, max_abs_err=0.0,
        plain_ms=k_plain_ms, substeps_median=int(nsub.median()), gm1_ms=k1_ms, resources=res)
    log(f"[23] K on its device-memory path at {tag}, N={s5.shape[0]}: K-gm on step 6 max|ds| 0, "
        f"{k_ms:.3f} ms "
        f"({int(nsub.median())} substeps median; {res}), K-gm1 {k1_ms:.3f} ms (max|ds| 0), "
        f"plain {k_plain_ms:.3f} ms, bound {k_bnd:.5f} ms ({k_by}, K-gm {k_bnd / k_ms:.1%}, "
        f"K-gm1 {k_bnd / k1_ms:.1%})")


def gm1_path(figs, gen):
    """[23]'s path past P-gm's capacity and K-gm's first plan: `simulate` at
    GM1_PATH_GRID, 5 steps through P's route (P-gm1) in each instantiation
    and K's (K-gm on its widened plan: strips of 4 rows and 2 columns a
    thread), counted; then K-gm on step 6 of the first run, bit for bit and
    timed with its bound, the plain version and K-gm1 (forced, bit for bit
    too) beside it, and each P-gm1 instantiation on the first step's system
    (the unscaled one on the prior scaled by MILD), its step over one window
    against the plain version's (the scaled system from seeded noise, as
    from 0 no window improves its residual here; every member's plain step
    nonzero) and a launch at bench settings timed with its bound and the
    plain version's time. Into `figs`."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, pressure, transport
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda, pressure_solve_torch
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    (Nx, Ny), n = GM1_PATH_GRID, GM1_PATH_N
    tag = f"{Nx}x{Ny}"
    bands, strip, cols = transport.gm_plan(Nx, Ny)
    assert transport.route(Nx, Ny) == "gm" and transport.gm_bands(Nx, Ny) is None
    p_name = f"pressure_pcg_{pressure.route(Nx, Ny, True, n)}"
    assert p_name == "pressure_pcg_gm1" and pressure.gm_plan(Nx, Ny) is None
    m = grid_model(torch, Nx, Ny)
    pre = ht.sample_prior_perm(gen, m, n, r=0.8)
    mm = set_perm(m, pre)
    t0 = time.perf_counter()
    res, launches = launched(lambda: ht.simulate(mm, torch.zeros(m.Nxy, device=mm.K.device), DT,
                                                 5, keep_wsats=False))
    wall = time.perf_counter() - t0
    assert launches == {p_name: 5, "transport_upwind_gm": 5}, launches
    assert bool(torch.isfinite(res.wsats).all())
    s5 = res.wsats[:, -1].reshape(n, Nx, Ny).contiguous()
    qf = _source_field(mm, mm.inj_rates[:, 0], mm.prd_rates[:, 0])
    _, Fx, Fy, _, _, _ = pressure_step(mm, s5, qf, torch.zeros_like(s5), 2e-3, 4 * max(Nx, Ny),
                                       5e-2)
    Fx, Fy = Fx.contiguous(), Fy.contiguous()
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, DT)
    t_args = (s5, Fx, Fy, qf[None].contiguous(), dtspv, nsub, fluid_of(mm))
    s_t = transport_substeps_torch(*t_args)
    for force in (None, "gm1"):  # K-gm on its route, beside K-gm1
        assert torch.equal(transport_substeps_cuda(*t_args, force=force), s_t), force
    k_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args), 5)
    k1_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="gm1"), 3)
    k_plain_ms = cuda_ms(lambda: transport_substeps_torch(*t_args), 1)
    k_bnd, k_by = transport_bound_ms(s5, Fx, Fy, t_args[3], nsub)
    figs["transport_upwind_gm"][f"launches_simulate_{tag}"] = launches["transport_upwind_gm"]
    figs[p_name][f"launches_simulate_{tag}"] = launches[p_name]
    base1 = {k: BASE[k] for k in SOLVE_KEYS}
    systems = {True: p_system(mm, qf, True), False: p_system(set_perm(m, MILD * pre), qf, False)}
    said = []
    for smoother, unit in P_GM:
        name = pressure.kernel_name(smoother, unit, "gm1")
        if name != p_name:  # simulate through the other instantiations
            res_i, n_i = launched(lambda: ht.simulate(
                mm, torch.zeros(m.Nxy, device=mm.K.device), DT, 5, keep_wsats=False,
                smoother=smoother, scale_system=unit))
            assert n_i == {name: 5, "transport_upwind_gm": 5}, n_i
            assert bool(torch.isfinite(res_i.wsats).all())
            figs[name][f"launches_simulate_{tag}"] = n_i[name]
        args, kw = systems[unit], dict(smoother=smoother, unit_diag=unit)
        # One window, the kernel's step from the start held to the plain
        # version's. From p0 = 0 no window improves the scaled system's
        # residual at this grid (P's plateau), so both would return the
        # start: that system starts from seeded noise. Every member's plain
        # step is nonzero, so the check cannot pass on the start alone.
        start = noisy_start(args, SEED + 23) if unit else args
        p0 = start[3]
        step_t = pressure_solve_torch(*start, **WINDOW4, **kw)[0] - p0
        step_k = pressure_solve_cuda(*start, **WINDOW4, **kw)[0] - p0
        moved = float(step_t.norm(dim=(-2, -1)).min())
        err = rel_err(step_k, step_t)
        assert moved > 0 and bool(torch.isfinite(step_k).all()) and err <= P_TOL, (
            name, moved, err)
        _, it, _ = pressure_solve_cuda(*args, **base1, **kw)
        ms = cuda_ms(lambda: pressure_solve_cuda(*args, **base1, **kw), 3)
        plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **base1, **kw), 1, warm=False)
        vf = P_FLOPS_VCYCLE_CHEB if smoother == "cheb" else P_FLOPS_VCYCLE
        bnd, by = pressure_bound_ms(args[0], args[1], it, vf,
                                    P_FLOPS_FINE + (0 if unit else P_FLOPS_DIAG))
        floor = inverse_floor_ms(args[1], it)
        plan, plan_said = gm1_said(Nx, Ny, unit)
        used = _build.kernel_info(name, Nx, Ny)
        assert used["local_bytes"] == 0 and used["shared_bytes"] == plan["shared_bytes"], used
        figs[name]["grids"][tag] = dict(
            ms=ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms, max_rel_err=err,
            max_abs_err=float((step_k - step_t).abs().max()), plain_ms=plain_ms,
            start="noise" if unit else "zero", least_step=moved,
            iters_median=int(it.median()), inverse_floor_ms=floor, share_of_floor=floor / ms,
            plan=plan, resources=used)
        figs[name]["max_abs_err"] = max(figs[name]["max_abs_err"],
                                        figs[name]["grids"][tag]["max_abs_err"])
        said.append(f"{name} window from {'noise' if unit else 'zero'} step rel {err:.2e} "
                    f"(least |plain step| {moved:.3g}), {ms:.3f} ms a launch (iterations median "
                    f"{int(it.median())}), bound {bnd:.4f} ms ({by}, {bnd / ms:.1%}), inverse "
                    f"floor {floor:.4f} ms ({floor / ms:.1%}), plain {plain_ms:.3f} ms; "
                    f"{plan_said}; {used}")
    log(f"[23] P-gm1 on its path at {tag}, N={n}: 5 steps of simulate through each "
        f"instantiation; the first step's system at bench settings: " + "; ".join(said))
    res_gm = _build.kernel_info("transport_upwind_gm", Nx, Ny)
    assert res_gm["local_bytes"] == 0, res_gm
    common = dict(bound_ms=k_bnd, bound_by=k_by, max_abs_err=0.0, plain_ms=k_plain_ms,
                  substeps_median=int(nsub.median()))
    figs["transport_upwind_gm"]["grids"][tag] = dict(
        common, ms=k_ms, share_of_bound=k_bnd / k_ms, gm1_ms=k1_ms, resources=res_gm)
    figs["transport_upwind_gm1"]["grids"][tag] = dict(
        common, ms=k1_ms, share_of_bound=k_bnd / k1_ms, forced=True,
        resources=_build.kernel_info("transport_upwind_gm1", Nx, Ny))
    log(f"[23] K past K-gm's first plan at {tag}, N={n}: simulate 5 steps {wall:.3f} s, launches "
        f"{launches}, cg_ok {float(res.cg_ok.float().mean()):.1%}; K-gm ({len(bands)} bands, "
        f"strips of {strip} rows and {cols} columns a thread) on step 6 max|ds| 0, {k_ms:.3f} ms "
        f"({int(nsub.median())} substeps median; {res_gm}) against K-gm1's {k1_ms:.3f} ms "
        f"({k1_ms / k_ms:.2f}x; max|ds| 0), plain {k_plain_ms:.3f} ms, bound {k_bnd:.5f} ms "
        f"({k_by}, K-gm {k_bnd / k_ms:.1%}, K-gm1 {k_bnd / k1_ms:.1%})")


def route_paths(figs, gen):
    """[23]'s paths of the tile body, `simulate` at each grid of ROUTE_PATHS
    (N=4, 5 steps; grids without a multigrid hierarchy, so P is the plain
    Jacobi-PCG in torch ops): K-rt1 at 4x1100 (a row wider than a block of
    the strip body; one block of strips of 4 rows and 2 columns a thread)
    and K-gm1 at 5x6000 (30,000 cells, two fw tiles past a block, a band of
    4 rows past K-gm's; 2-D tiles over co-resident blocks), counted; then
    each on step 6, bit for bit and timed with its bound, its plan and the
    plain version, and K-gm1's device-memory body forced there the same
    way, one member at a time (its route past the tiles' capacity) and one
    block a member (its route at large batches). Into `figs`."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, transport
    from historymatching_tpu_torch.ops.multigrid import n_levels
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    for rt, (Nx, Ny) in ROUTE_PATHS.items():
        name, tag, n = transport.NAMES[rt], f"{Nx}x{Ny}", ROUTE_PATH_N
        assert transport.route(Nx, Ny) == rt and n_levels(Nx, Ny) < 2, (tag, rt)
        m = grid_model(torch, Nx, Ny)
        mm = set_perm(m, ht.sample_prior_perm(gen, m, n, r=0.8))
        t0 = time.perf_counter()
        res, launches = launched(lambda: ht.simulate(mm, torch.zeros(m.Nxy, device=mm.K.device),
                                                     DT, 5, keep_wsats=False))
        wall = time.perf_counter() - t0
        assert launches == {name: 5}, launches
        assert bool(torch.isfinite(res.wsats).all())
        s5 = res.wsats[:, -1].reshape(n, Nx, Ny).contiguous()
        qf = _source_field(mm, mm.inj_rates[:, 0], mm.prd_rates[:, 0])
        _, Fx, Fy, _, _, _ = pressure_step(mm, s5, qf, torch.zeros_like(s5), 2e-3,
                                           4 * max(Nx, Ny), 5e-2)
        Fx, Fy = Fx.contiguous(), Fy.contiguous()
        nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, DT)
        t_args = (s5, Fx, Fy, qf[None].contiguous(), dtspv, nsub, fluid_of(mm))
        assert torch.equal(transport_substeps_cuda(*t_args), transport_substeps_torch(*t_args))
        ms = cuda_ms(lambda: transport_substeps_cuda(*t_args), 5)
        plain_ms = cuda_ms(lambda: transport_substeps_torch(*t_args), 1)
        bnd, by = transport_bound_ms(s5, Fx, Fy, t_args[3], nsub)
        figs[name][f"launches_simulate_{tag}"] = launches[name]
        res = _build.kernel_info(name, Nx, Ny)
        assert res["local_bytes"] == 0, res
        fig = figs[name]["grids"][tag] = dict(
            ms=ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms, max_abs_err=0.0,
            plain_ms=plain_ms, substeps_median=int(nsub.median()), resources=res)
        said = ""
        # the device-memory body, forced: one member at a time (its plan past
        # the tiles) and one block a member (its plan at large batches)
        for key, dplan in (("device_memory_body", transport.DEVICE),
                           ("one_block_a_member", transport.GM1Device(1))) if rt == "gm1" else ():
            dev_run = lambda p=dplan: transport_substeps_cuda(  # noqa: E731
                *t_args, force="gm1", plan=p)
            assert torch.equal(dev_run(), transport_substeps_torch(*t_args)), dplan
            dev_ms = cuda_ms(dev_run, 3)
            dev_res = _build.kernel_info(name, Nx, Ny, dplan)
            assert dev_res["local_bytes"] == 0, dev_res
            fig[key] = dict(ms=dev_ms, share_of_bound=bnd / dev_ms, max_abs_err=0.0,
                            resources=dev_res)
            said += f"; {key.replace('_', ' ')} forced max|ds| 0, {dev_ms:.3f} ms ({dev_res})"
        log(f"[23] {name} on its route at {tag}, N={n}: simulate 5 steps {wall:.3f} s, launches "
            f"{launches}; on step 6 max|ds| 0, {ms:.3f} ms ({int(nsub.median())} substeps "
            f"median; {res}), plain {plain_ms:.3f} ms, bound {bnd:.5f} ms ({by}, "
            f"{bnd / ms:.1%}){said}")


def capacity_check(figs, gen):
    """[23c]: K at a grid past K-gm's first plan's capacity with rows under
    1,024 cells, CAPACITY_GRID (N=4): the first step's inputs (s = 0, one
    pressure step of a prior field at the first pass's settings, solved by
    the diagonally preconditioned `pcg` in torch ops: P's route there,
    P-gm1, reads the 126 MB coarse inverse every V-cycle), K-gm on its
    route (120 bands, strips of 5 rows) bit for bit, timed beside K-gm1
    (forced, bit for bit too), the plain version and the bound, with the
    phase's wall. Into `figs`."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, transport
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    t0 = time.perf_counter()
    (Nx, Ny), n = CAPACITY_GRID, CAPACITY_N
    tag = f"{Nx}x{Ny}"
    bands, strip, cols = transport.gm_plan(Nx, Ny)
    assert transport.route(Nx, Ny) == "gm" and transport.gm_bands(Nx, Ny) is None
    m = grid_model(torch, Nx, Ny)
    mm = set_perm(m, ht.sample_prior_perm(gen, m, n, r=0.8))
    qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
    s0 = torch.zeros(n, Nx, Ny, device=mm.K.device)
    first = dict(BASE, **SCHED[0])
    _, Fx, Fy, it, ok, _ = pressure_step(mm, s0, qf, torch.zeros_like(s0), first["tol"],
                                         first["maxiter"], 5e-2,
                                         patience_iters=first["patience_iters"],
                                         precond="jacobi")
    Fx, Fy = Fx.contiguous(), Fy.contiguous()
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, DT)
    t_args = (s0, Fx, Fy, qf[None].contiguous(), dtspv, nsub, fluid_of(m))
    s_k, n_k = launched(lambda: transport_substeps_cuda(*t_args))
    assert n_k == {"transport_upwind_gm": 1}, n_k
    s_t = transport_substeps_torch(*t_args)
    err = float((s_k - s_t).abs().max())
    assert torch.equal(s_k, s_t), err
    s_1 = transport_substeps_cuda(*t_args, force="gm1")
    assert torch.equal(s_1, s_t)
    k1_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args, force="gm1"), 1, warm=False)
    k_ms = cuda_ms(lambda: transport_substeps_cuda(*t_args), 3)
    plain_ms = cuda_ms(lambda: transport_substeps_torch(*t_args), 1, warm=False)
    bnd, by = transport_bound_ms(s0, Fx, Fy, t_args[3], nsub)
    res = _build.kernel_info("transport_upwind_gm", Nx, Ny)
    assert res["local_bytes"] == 0, res
    wall = time.perf_counter() - t0
    figs["transport_upwind_gm"]["grids"][tag] = dict(
        ms=k_ms, gm1_ms=k1_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
        share_of_bound=bnd / k_ms, max_abs_err=err, substeps_median=int(nsub.median()),
        resources=res, first_step=True, wall_s=wall)
    figs["transport_upwind_gm1"]["grids"][tag] = dict(
        ms=k1_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / k1_ms,
        max_abs_err=0.0, forced=True, first_step=True)
    log(f"[23c] K past K-gm's first plan at {tag}, N={n}, the first step (Jacobi-PCG "
        f"iterations median {int(it.median())}, accepted {int(ok.sum())}/{n}; substeps median "
        f"{int(nsub.median())} max {int(nsub.max())}): K-gm ({len(bands)} bands, strips of "
        f"{strip} rows and {cols} columns a thread; {res}) max|ds| vs plain {err:.1e}, "
        f"{k_ms:.3f} ms a launch against K-gm1's {k1_ms:.3f} ms ({k1_ms / k_ms:.2f}x; max|ds| "
        f"0), plain {plain_ms:.3f} ms, bound {bnd:.5f} ms ({by}, K-gm {bnd / k_ms:.1%}, K-gm1 "
        f"{bnd / k1_ms:.1%}); the phase's wall {wall:.1f} s")


def large_case_phase(dev):
    """Phase 24: the reference's bench case at 128x128, N=1000. Returns its
    figures."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch import parity
    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.ops.pressure import recook_plan
    from historymatching_tpu_torch.parallel.runner import set_perm

    Nx, Ny = BIG
    case = parity.build_case(SEED, N, Nx, Ny, NTIME)
    model, truth, prior = case["model"], case["truth"], case["prior"]
    fl = model.fluid
    kws = [dict(BASE, **ov) for ov in SCHED]
    assert all(recook_plan(N, Ny, kw["maxiter"], kw["two_pass"], kw["twopass_j1"],
                           kw["twopass_div"]) is None for kw in kws + [BASE])
    passes = []

    def make_fwd(kw):
        def fwd(E):
            sync()
            t, before = time.perf_counter(), dict(_build.LAUNCHES)
            wsats, prods, res = ht.forward_model(model, E, dt=DT, nTime=NTIME, return_sim=True,
                                                 **kw)
            sync()
            seconds = time.perf_counter() - t
            assert wsats.shape == (N, NTIME + 1, Nx * Ny)
            for x in (wsats, prods):
                assert torch.isfinite(x).all()
                assert float(x.min()) >= fl.swc and float(x.max()) <= 1.0 - fl.sor
            passes.append(dict(seconds=seconds, cg_ok=float(res.cg_ok.float().mean()),
                               iters_median=int(res.cg_iters.median()),
                               iters_max=int(res.cg_iters.max()),
                               substeps_median=int(res.substeps.median()),
                               launches={k: v - before[k] for k, v in _build.LAUNCHES.items()
                                         if v != before[k]},
                               final=wsats[:, -1].clone()))
            return prods.reshape(N, -1)
        return fwd

    _build.reset_launches()
    sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the earlier phases
    t0 = time.perf_counter()
    _, prod_truth = ht.forward_model(model, truth[None], dt=DT, nTime=NTIME, keep_wsats=False,
                                     **BASE)
    obs = torch.clamp(prod_truth[0].reshape(-1) + case["noise"], 0, 1)
    post = ht.es_mda(prior, [make_fwd(kw) for kw in kws], obs, case["R12"],
                     ht.mda_alphas(PASSES), key=case["key_mda"])
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    for i, st in enumerate(passes):
        log(f"[24] pass {i + 1}: {st['seconds']:.3f} s; cg_ok {st['cg_ok']:.1%}; cg_iters median "
            f"{st['iters_median']} max {st['iters_max']}; substeps median "
            f"{st['substeps_median']}; launches {st['launches']}")
        assert st["launches"] == {"pressure_pcg_cl": NTIME, "transport_upwind_cl": NTIME}
    r_prior, r_post = parity.rmse(prior, truth), parity.rmse(post, truth)
    log(f"[24] bench case seed {SEED} at {Nx}x{Ny}, N={N}, nTime={NTIME}, {PASSES}-pass ES-MDA: "
        f"{wall:.3f} s (truth sim + forward passes + analyses, synchronized); launches "
        f"{launches}; peak device memory {peak / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB the earlier phases hold; rmse vs truth prior "
        f"{r_prior:.4f} -> posterior {r_post:.4f}")
    assert launches == {"pressure_pcg_cl": (1 + PASSES) * NTIME,
                        "transport_upwind_cl": (1 + PASSES) * NTIME}, launches
    assert torch.isfinite(post).all() and post.shape == prior.shape

    pass_figs = [{k: v for k, v in st.items() if k != "final"} for st in passes]
    # 10 steps of a loose pass from the last pass's final states, profiled
    mm = set_perm(model, post)
    wsat = passes[-1]["final"]
    prof_kw = dict(dt=DT, nTime=10, keep_wsats=False, **dict(BASE, **SCHED[0]))
    ht.simulate(mm, wsat, **dict(prof_kw, nTime=1))
    stages, busy, wall_ms, acts = profile_steps(lambda: ht.simulate(mm, wsat, **prof_kw), 10)
    log(f"[24] profile, 10 loose-pass steps at N={N} {Nx}x{Ny}: per step " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in stages.items())
        + f"; device busy {busy:.3f} ms of {wall_ms:.3f} ms unprofiled wall, idle "
        f"{1 - busy / wall_ms:.1%}; {acts:.1f} device activities a step")
    del mm, wsat, passes[:]
    kernels = large_case_kernels(model, prior)
    return dict(wall_s=wall, launches=launches, peak_bytes=peak, held_bytes=held,
                rmse_prior=r_prior, rmse_post=r_post, stages_ms=stages, busy_ms=busy,
                step_wall_ms=wall_ms, kernels=kernels,
                passes=[{k: v for k, v in st.items() if k != "final"} for st in pass_figs])


def layer_case_phase():
    """Phase 24b: the reference's bench case (`parity.build_case(seed=1,
    N=1000)`) on P-cl/d's grids, a 60x220 layer of SPE10 model 2 and
    100x100: 5 steps of the first pass through `forward_model` and P's
    route (P-gm1 at both, past `P_GM_PAST`'s batch), each step one P and
    one K launch, P's device time a step from a profile; on the first
    step's system P-cl/d and P-gm1 (and at 100x100 P-gm) forced, each held
    to the plain version after one window and timed at the first pass's
    settings beside its bound, and P-gm1's plan and its inverse's floor
    (the plain version's time at 60x220). Returns per grid its figures."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch import parity
    from historymatching_tpu_torch.models.ressim import _source_field
    from historymatching_tpu_torch.ops import _build, pressure, transport
    from historymatching_tpu_torch.ops.pressure import (
        cl_plan,
        gm_plan,
        kernel_name,
        pressure_solve_cuda,
        pressure_solve_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    first = dict(BASE, **SCHED[0])
    kw1 = {k: first[k] for k in SOLVE_KEYS}
    out = {}
    for Nx, Ny in LAYER_GRIDS:
        tag = f"{Nx}x{Ny}"
        case = parity.build_case(SEED, N, Nx, Ny, NTIME)
        model, prior = case["model"], case["prior"]
        limit = P_GM_PAST.get((Nx, Ny, True))
        rt = pressure.route(Nx, Ny, True, N)
        # past the batch, P-gm1: it beat P-gm there (`GM_BATCH_MAX`)
        assert rt == ("gm1" if limit and N > limit else "cl"), (tag, rt)
        run = lambda: ht.forward_model(model, prior, dt=DT, nTime=LAYER_STEPS,  # noqa: E731
                                       keep_wsats=False, **first)
        _build.reset_launches()
        wsats, prods = run()
        sync()
        n = {k: v for k, v in _build.LAUNCHES.items() if v}
        names = {"pressure": kernel_name("jacobi", True, rt),
                 "transport": transport.NAMES[transport.route(Nx, Ny)]}
        assert n == {names["pressure"]: LAYER_STEPS, names["transport"]: LAYER_STEPS}, n
        for x in (wsats, prods):
            assert bool(torch.isfinite(x).all())
            assert float(x.min()) >= model.fluid.swc and float(x.max()) <= 1.0 - model.fluid.sor
        stages, busy, wall_ms, _ = profile_steps(run, LAYER_STEPS)

        # the first step's system, each variant forced
        mm = set_perm(model, prior)
        args = p_system(mm, _source_field(model, model.inj_rates[:, 0], model.prd_rates[:, 0]),
                        True)
        p_t = pressure_solve_torch(*args, **WINDOW4)[0]
        plan = cl_plan(Nx, Ny)
        figs, said = {}, []
        # P-gm beside them at 100x100, where it lost to P-gm1 past P-cl/d's batch
        for force in ("cl", "gm1") + (("gm",) if (Nx, Ny) == (100, 100) else ()):
            solve = lambda kw: pressure_solve_cuda(*args, **kw, force=force)  # noqa: E731
            p_k = solve(WINDOW4)[0]
            err = rel_err(p_k, p_t)
            assert bool(torch.isfinite(p_k).all()) and err <= P_TOL, (tag, force, err)
            _, it, rl = solve(kw1)
            ms = cuda_ms(lambda: solve(kw1), 2)
            bnd, by = pressure_bound_ms(args[0], args[1], it)
            figs[force] = dict(ms=ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
                               max_rel_err=err, max_abs_err=float((p_k - p_t).abs().max()),
                               iters_median=int(it.median()), iters_max=int(it.max()),
                               accepted=int((rl <= 5e-2).sum()))
            who = dict(cl=f"P-cl/d {plan}", gm=f"P-gm {gm_plan(Nx, Ny)}", gm1="P-gm1")[force]
            extra = ""
            if force == "gm1":
                floor = inverse_floor_ms(args[1], it)
                figs[force]["plan"], plan_said = gm1_said(Nx, Ny)
                figs[force].update(inverse_floor_ms=floor, share_of_floor=floor / ms)
                extra = f", inverse floor {floor:.4f} ms ({floor / ms:.1%}); {plan_said}"
            said.append(f"{who} window max rel "
                        f"{err:.2e}, {ms:.3f} ms (iterations median {int(it.median())} max "
                        f"{int(it.max())}, accepted {figs[force]['accepted']}), bound {bnd:.4f} "
                        f"ms ({by}, {bnd / ms:.1%})" + extra)
        if (Nx, Ny) == LAYER_GRIDS[0]:
            figs["cl"]["plain_ms"] = cuda_ms(lambda: pressure_solve_torch(*args, **kw1), 1)
            said.append(f"plain {figs['cl']['plain_ms']:.3f} ms")
        del args, p_k, p_t
        out[tag] = dict(route=rt, plan=plan, launches=n, stages_ms=stages, busy_ms=busy,
                        step_wall_ms=wall_ms, kernels=figs)
        log(f"[24b] bench case seed {SEED} at {tag}, N={N}, {LAYER_STEPS} steps of the first pass "
            f"through the route ({rt}): launches {n}; per step " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in stages.items())
            + f"; device busy {busy:.3f} ms of {wall_ms:.3f} ms wall, idle "
            f"{1 - busy / wall_ms:.1%}; first step forced: " + "; ".join(said))
    return out


def large_case_kernels(model, prior):
    """[24]'s kernels at the shapes its path gives them: the bench case's
    first step (N=1000, 128x128, s = 0). P's route, P-cl: one launch after
    one window held to the plain version within P_TOL, then timed at the
    first pass's settings beside P-gm1 forced on the same inputs (held the
    same way), the plain version and the bound, and P-cl's cluster barriers
    an iteration as its probe build counts them (`cl_iteration_barriers`).
    K's route, K-cl: bit for bit, timed beside the runtime-grid variant and
    K-gm forced (each bit for bit too). These
    launches are not the path's: the caller has read its counts."""
    import torch

    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, pressure, transport
    from historymatching_tpu_torch.ops.pressure import (
        cl_plan,
        kernel_name,
        pressure_solve_cuda,
        pressure_solve_torch,
    )
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    Nx, Ny = model.shape
    mm = set_perm(model, prior)
    qf = _source_field(model, model.inj_rates[:, 0], model.prd_rates[:, 0])
    first = dict(BASE, **SCHED[0])
    kw1 = {k: first[k] for k in SOLVE_KEYS}
    args = p_system(mm, qf, True)
    assert pressure.route(Nx, Ny) == "cl"
    c0, place0 = cl_plan(Nx, Ny)
    p_t = pressure_solve_torch(*args, **WINDOW4)[0]
    p_figs, said = {}, []
    for force in ("cl", "gm1"):
        name = kernel_name("jacobi", True, force)
        run = lambda kw: pressure_solve_cuda(*args, **kw, force=force)  # noqa: E731
        (p_k, _, _), n = launched(lambda: run(WINDOW4))
        assert n == {name: 1}, n
        err, abs_err = rel_err(p_k, p_t), float((p_k - p_t).abs().max())
        assert bool(torch.isfinite(p_k).all()) and err <= P_TOL, (force, err)
        _, it_k, rl_k = run(kw1)
        ms = cuda_ms(lambda: run(kw1), 2)
        bnd, by = pressure_bound_ms(args[0], args[1], it_k)
        tag = f"{name}" + (f" c={c0}" if force == "cl" else "")
        p_figs[name] = dict(ms=ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
                            max_rel_err=err, max_abs_err=abs_err,
                            iters_median=int(it_k.median()), accepted=int((rl_k <= 5e-2).sum()))
        if force == "cl":
            # the barriers counted by the probe build, on member 0
            resident = _build.kernel_info(name, Nx, Ny)["max_active_clusters"]
            p_figs[name].update(cluster=c0, clusters_resident=resident,
                                barriers=cl_iteration_barriers(args, True, (c0, place0)))
        said.append(f"{tag} window max rel {err:.2e} (abs {abs_err:.2e}), {ms:.3f} ms a launch "
                    f"(iterations median {p_figs[name]['iters_median']}, accepted "
                    f"{p_figs[name]['accepted']}), bound {bnd:.4f} ms ({by}, {bnd / ms:.1%})"
                    + (f"; {resident} clusters resident, {p_figs[name]['barriers']} cluster "
                       f"barriers an iteration (counted by the probe build), an iteration "
                       f"~{iteration_us(ms, resident, it_k):.2f} us (an estimate)"
                       if force == "cl" else ""))
    plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **kw1), 1)
    del args, p_k, p_t
    cl_fig = dict(p_figs["pressure_pcg_cl"], plain_ms=plain_ms,
                  gm1_ms=p_figs["pressure_pcg_gm1"]["ms"])
    gm1_fig = dict(p_figs["pressure_pcg_gm1"], plain_ms=plain_ms)

    s0 = torch.zeros(prior.shape[0], *model.shape, device=prior.device)
    _, Fx, Fy, _, _, _ = pressure_step(mm, s0, qf, torch.zeros_like(s0), tol_accept=5e-2,
                                     **first)
    Fx, Fy = Fx.contiguous(), Fy.contiguous()
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, DT)
    t_args = (s0, Fx, Fy, qf[None].contiguous(), dtspv, nsub, fluid_of(model))
    assert transport.route(Nx, Ny) == "cl"
    s_t = transport_substeps_torch(*t_args)
    k_ms = {}
    for force in ("cl", "gm1", "gm"):
        s_k, n = launched(lambda: transport_substeps_cuda(*t_args, force=force))
        assert n == {transport.NAMES[force]: 1}, n
        assert torch.equal(s_k, s_t), (force, float((s_k - s_t).abs().max()))
        k_ms[force] = cuda_ms(lambda: transport_substeps_cuda(*t_args, force=force), 3)
    k_plain_ms = cuda_ms(lambda: transport_substeps_torch(*t_args), 1)
    k_bnd, k_by = transport_bound_ms(s0, Fx, Fy, t_args[3], nsub)
    k_figs = {transport.NAMES[f]: dict(ms=ms, plain_ms=k_plain_ms, bound_ms=k_bnd, bound_by=k_by,
                                       share_of_bound=k_bnd / ms, max_abs_err=0.0,
                                       substeps_median=int(nsub.median()))
              for f, ms in k_ms.items()}
    k_res = _build.kernel_info("transport_upwind_cl", Nx, Ny)
    k_sub = iteration_us(k_ms["cl"], k_res["max_active_clusters"], nsub)
    k_figs["transport_upwind_cl"].update(gm1_ms=k_ms["gm1"], gm_ms=k_ms["gm"],
                                         plan=transport.cl_plan(Nx, Ny), resources=k_res)
    log(f"[24] kernels on the first step's system (N={prior.shape[0]}, {Nx}x{Ny}, the first "
        f"pass's settings): " + "; ".join(said) + f"; plain {plain_ms:.3f} ms; K-cl "
        f"({transport.cl_plan(Nx, Ny)}: {k_res['registers']} registers, {k_res['local_bytes']} "
        f"local bytes, {k_res['blocks_per_sm']} ranks an SM, {k_res['max_active_clusters']} "
        f"clusters resident, a substep ~{k_sub:.2f} us by estimate; "
        f"{int(nsub.median())} substeps median) max|ds| 0 on every "
        f"route, ms " + ", ".join(f"{k} {v:.3f}" for k, v in k_ms.items())
        + f", plain {k_plain_ms:.3f}, bound {k_bnd:.5f} ms ({k_by}, K-cl "
        f"{k_bnd / k_ms['cl']:.1%})")
    return {"pressure_pcg_cl": cl_fig, "pressure_pcg_gm1": gm1_fig, **k_figs}


def mesh_phase(dev, cases):
    """Phase 25, on a world of one over NCCL: `forward_model(mesh=)`, then
    [5]'s flagship ES-MDA, [10]'s IES and [14]'s robust StoSAG GD on
    member-sharded inputs (`mesh_legs`)."""
    import torch
    import torch.distributed as dist

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.parallel.mesh import replicate

    mesh = ht.ens_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        model = flagship_model(torch)
        gen = torch.Generator(device=dev).manual_seed(SEED + 25)
        prior = ht.sample_prior_perm(gen, model, MESH_N, r=0.8)
        kw = dict(dt=DT, nTime=MESH_STEPS, return_sim=True, **BASE)
        w0 = torch.zeros(model.Nxy, device=dev)

        sharded = lambda: ht.forward_model(model, ht.shard_ens(prior, mesh),  # noqa: E731
                                           replicate(w0, mesh), mesh=mesh, **kw)
        plain = lambda: ht.forward_model(model, prior, w0, **kw)  # noqa: E731
        _build.reset_launches()
        (w_m, p_m, r_m), first_m = timed(sharded)  # NCCL's communicator starts here
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        (w_u, p_u, r_u), wall_u = timed(plain)
        wall_m = timed(sharded)[1]
        o_m = ht.obs_ens_fn(model, DT, MESH_STEPS, mesh=mesh, **BASE)(ht.shard_ens(prior, mesh))
        same = {k: bool(torch.equal(a.full_tensor(), b)) for k, a, b in (
            ("wsats", w_m, w_u), ("prods", p_m, p_u), ("cg_iters", r_m.cg_iters, r_u.cg_iters),
            ("recooked", r_m.recooked, r_u.recooked),
            ("obs", o_m, p_u.reshape(MESH_N, -1)))}
        local = tuple(w_m.to_local().shape)
        log(f"[25] forward_model(mesh=) on a world of one over NCCL ({mesh}), {NX}x{NY}, "
            f"N={MESH_N}, {MESH_STEPS} steps: {wall_m:.3f} s (without a mesh {wall_u:.3f} s; the "
            f"first call, with NCCL's start, {first_m:.3f} s); member-sharded out, local "
            f"{local}; launches {launches}; equal to the run without a mesh, bit for bit: {same}")
        assert all(same.values()), same
        assert launches["pressure_pcg"] >= MESH_STEPS and launches["transport_upwind"] == MESH_STEPS
        rec = dict(wall_s=wall_m, wall_unsharded_s=wall_u, first_call_s=first_m,
                   launches=launches, equal=same)
        rec["legs"] = mesh_legs(mesh, cases)
        return rec
    finally:
        dist.destroy_process_group()


def timed(fn):
    """(fn(), its wall in seconds), the card synchronized around it."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def mesh_legs(mesh, cases):
    """Phase 25's analysis legs: [5]'s flagship ES-MDA (its truth run, data,
    prior, schedule and obs-error draws), [10]'s IES (its perturbations too)
    and [14]'s robust StoSAG GD (its 31 fields, start and draws), each run
    without a mesh, twice with the ensemble member-sharded on `mesh` (a
    world of one) and again without. Every run must equal the first bit for
    bit (a world of one does the unsharded run's operations in the same
    order) and launch P and K as often as [5], [10] and [14]; where one
    does not, the largest difference and the first callback at which the
    runs part are printed, and the phase fails."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.da.update import decorrelator
    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.parallel.mesh import whole

    f, rb = cases["flagship"], cases["robust"]
    model = f["model"]

    def gen_at(state, like):
        """A generator on `like`'s device in the state a phase drew from."""
        g = torch.Generator(device=like.device)
        g.set_state(state)
        return g

    def es_mda(m):
        E = f["prior"] if m is None else ht.shard_ens(f["prior"], m)
        seen = []
        ht.forward_model(model, f["truth"][None], dt=DT, nTime=NTIME, keep_wsats=False, **BASE)
        fwds = [ht.obs_ens_fn(model, DT, NTIME, mesh=m, **dict(BASE, **ov)) for ov in SCHED]
        post = ht.es_mda(E, fwds, f["obs"], f["R12"], ht.mda_alphas(PASSES),
                         generator=gen_at(f["gen_state"], f["prior"]),
                         callback=lambda info: seen.append(whole(info["E"])))
        return post, seen

    def ies(m):
        sh = (lambda x: x) if m is None else (lambda x: ht.shard_ens(x, m))  # noqa: E731
        seen = []
        fwds = [ht.obs_ens_fn(model, DT, NTIME, mesh=m, **dict(BASE, **ov)) for ov in IES_SCHED]
        post, _ = ht.ies(sh(f["prior"]), fwds, f["obs"], sh(f["perturbs"]),
                         decorrelator(f["R12"]), xStep=IES_STEP, iMax=IES_ITERS,
                         callback=lambda info: seen.append(whole(info["E"])))
        return post, seen

    def stosag(m):
        X = rb["X"] if m is None else ht.shard_ens(rb["X"], m)
        seen = []
        nabla = ht.EnGrad(chol=EN_CHOL, nEns=ROBUST_N, robustly="StoSAG", obj_ux=rb["obj_ux"], X=X)
        path, _, _ = ht.GD(ht.robust_mean(rb["obj_ux"], X), rb["u0"], nabla=nabla,
                           nIter=ROBUST_ITERS, generator=gen_at(rb["gen_state"], rb["X"]),
                           callback=lambda info: seen.append(info["u"].clone()))
        return path, seen

    out = {}
    for name, fn, ref in (("es_mda", es_mda, f["launches"]), ("ies", ies, f["launches_ies"]),
                          ("stosag_gd", stosag, rb["launches"])):
        runs = []
        for m in (None, mesh, mesh, None):  # unsharded first and last: the order shows in both
            _build.reset_launches()
            (res, seen), wall = timed(lambda: fn(m))
            runs.append(dict(sharded=m is not None, res=res, seen=seen, wall=wall,
                             launches={k: _build.LAUNCHES[k] for k in JACOBI_KERNELS}))
        base = runs[0]
        local = tuple(runs[1]["res"].to_local().shape) if name != "stosag_gd" else None
        same = [bool(torch.equal(whole(r["res"]), base["res"])) for r in runs[1:]]
        walls = {tag: [r["wall"] for r in runs if r["sharded"] == (tag == "sharded")]
                 for tag in ("sharded", "unsharded")}
        ref = {k: ref[k] for k in JACOBI_KERNELS}
        log(f"[25] {name} on a world of one, runs unsharded, sharded, sharded, unsharded: walls "
            f"sharded {[round(w, 3) for w in walls['sharded']]} s, unsharded "
            f"{[round(w, 3) for w in walls['unsharded']]} s; launches each run "
            f"{[r['launches'] for r in runs]}, the phase's own {ref}; local members {local}; "
            f"equal to the first (unsharded) run, bit for bit: {same}")
        for r, ok in zip(runs[1:], same):
            if not ok:
                got = whole(r["res"])
                part = next((i + 1 for i, (a, b) in enumerate(zip(r["seen"], base["seen"]))
                             if not torch.equal(a, b)), None)
                log(f"[25] {name}: a {'sharded' if r['sharded'] else 'unsharded'} run is NOT "
                    f"equal: max |d| {float((got - base['res']).abs().max()):.3e}; the runs part at "
                    f"callback {part} of {len(base['seen'])} (None: only the final recomposition "
                    f"differs)")
        assert all(same), (name, same)
        assert all(r["launches"] == ref for r in runs), (name, [r["launches"] for r in runs], ref)
        out[name] = dict(walls_sharded_s=walls["sharded"], walls_unsharded_s=walls["unsharded"],
                         launches=runs[1]["launches"], equal=same, local_shape=local)
    return out


def fluid_of(model):
    fl = model.fluid
    return (fl.vw, fl.vo, fl.swc, fl.sor)


def example_phases():
    """Phase 21: the tutorial examples in this process, their output kept
    for the headline numbers. Returns the launches of each run."""
    import contextlib
    import importlib
    import io

    import numpy as np

    from historymatching_tpu_torch.ops import _build

    runs = []
    for name, argv, must in EXAMPLES:
        mod = importlib.import_module(f"historymatching_tpu_torch.examples.{name}")
        buf = io.StringIO()
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        tag = f"{name} {' '.join(argv)}".strip()
        log(f"[21] {tag}: {wall:.2f} s; kernel launches {launches}")
        if name == "history_match":
            rmse = {k: v[0] for k, v in out["param"].items()}
            log("[21]   rmse vs truth: " + ", ".join(f"{k} {v:.4f}" for k, v in rmse.items()))
            log("[21]   rmse vs future production: "
                + ", ".join(f"{k} {v[0]:.4f}" for k, v in out["future"].items()))
            post = [rmse[k] for k in ("ES", "LES", "IES", "ILES", "MDA")]
            assert np.isfinite(post).all() and min(post) < rmse["Prior"], rmse
        else:
            for line in buf.getvalue().splitlines():
                if line.startswith("[") and "] " in line:
                    log(f"[21]   {line}")
            assert "inj_xy" in out and np.isfinite(out["inj_xy"]["optimum"]), out
        assert all(launches.get(k, 0) > 0 for k in must), (tag, launches)
        runs.append(dict(run=tag, wall_s=wall, launches=launches))
    return runs


def parity_phase(card, out_dir):
    """Phase 22: every rung of `parity.RUNGS`; returns the records."""
    from historymatching_tpu_torch import parity

    t0 = time.perf_counter()
    recs = []
    for name, ref_file, method in parity.RUNGS:
        rec = parity.run_rung(name, ref_file, method, card=card)
        with open(os.path.join(ROOT, "parity", name.replace("GPU", "TPU") + ".json")) as f:
            tpu = json.load(f)
        fig = rec.get("replica0", rec)
        extra = (f"; median over {rec['runs']} runs (seeds x replicas) "
                 f"{rec['ratio_median_all']:.4f}, mean {rec['ratio_mean_all']:.4f}, per-seed "
                 f"medians {[round(v, 4) for v in rec['seed_medians']]}; replica 0"
                 if method == "ies" else "")
        log(f"[22] {name} ({method}, N={rec['N']}, {len(rec['seeds'])} seeds){extra}: median "
            f"{fig['ratio_median']:.4f} worst {fig['ratio_max']:.4f} (TPU: median "
            f"{tpu['ratio_median']} worst {tpu['ratio_max']}); ratios "
            f"{[round(v, 4) for v in fig.get('ratios', [r['ratios'][0] for r in rec['rows']])]}; "
            f"direction {rec['improves_direction_matches']}; ok {rec['ok']}; wall "
            f"{rec['wall_s']:.3f} s; prior rmse vs ref max rel {rec['prior_rel_err_max']:.1e}; "
            f"launches {rec['launches']}")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, name + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        recs.append(rec)
    log(f"[22] {len(recs)} rungs in {time.perf_counter() - t0:.1f} s")
    failed = [f"{r['name']}: {parity.check_record(r)}" for r in recs if parity.check_record(r)]
    assert not failed, failed
    assert all(r["launches"].get(k, 0) > 0 for r in recs for k in JACOBI_KERNELS)
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port's main path once on one GPU.")
    ap.add_argument("--parity-out", default="",
                    help="write each parity rung's record of phase 22 to this directory")
    opts = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        log("chip_smoke: FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: FAIL: no CUDA device (this check runs on the GPU only)")
        return 2
    if not os.path.isdir(os.path.join(ROOT, "historymatching_tpu_torch")):
        log("chip_smoke: FAIL: historymatching_tpu_torch/ is not beside this script")
        return 2
    sys.path.insert(0, ROOT)

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, scaled_system
    from historymatching_tpu_torch.ops import _build
    from historymatching_tpu_torch.da.localization import domain_partition
    from historymatching_tpu_torch.da.update import decorrelator
    from historymatching_tpu_torch.ops.pressure import (
        pressure_solve_cuda,
        pressure_solve_recook,
        pressure_solve_torch,
        recook_plan,
    )
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.ops.stencil import face_fluxes
    from historymatching_tpu_torch.parallel.runner import prod_inds, set_perm

    assert "jax" not in sys.modules, "the port must not import JAX"

    # 1. device
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    log("[1] TF32 off (matmul and cudnn)")

    # 2. build
    t0 = time.perf_counter()
    from historymatching_tpu_torch.ops.pressure import cl_plan

    # and the in-place plans [23] times beside P-cl/d
    _build.prebuild(P_NEW_GRIDS, cl_grids=LARGE_GRIDS + K_RT_GRIDS,
                    cl_plans=[(*g, *cl_plan(*g, True, "device")) for g in LAYER_GRIDS],
                    cl_probes=[(*BIG, *cl_plan(*BIG))],  # [24] counts P-cl's barriers
                    gm_grids=(GM_PATH_GRID,) + LAYER_GRIDS[1:] + _build.GRIDS,  # [2]'s table
                    k_grids=K_RT_GRIDS + ((NX, NY), GM1_PATH_GRID, CAPACITY_GRID, GM_PATH_GRID,
                                          BIG) + LARGE_GRIDS + tuple(ROUTE_PATHS.values()),
                    kt_grids=_build.GRIDS)  # [2]'s table
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(compiled: {_build.build_info['built']}) -> {_build.build_info['paths']}")
    for stem, text in _build.build_info["ptxas"].items():
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes"):
                log(f"[2] ptxas {stem} {fn}: {line.strip()}")
    # clusters: [23]; K-rt, built per grid: [19c]
    for name in (k for k in _build.LAUNCHES if not k.endswith("_cl")
                 and k != "transport_upwind_rt"):
        for grid in _build.GRIDS:
            info = _build.kernel_info(name, *grid)
            log(f"[2] {name} {grid[0]}x{grid[1]}: {info['registers']} registers, "
                f"{info['local_bytes']} local (stack/spill) bytes, {info['shared_bytes']} shared "
                f"bytes, {info['threads']} threads, {info['blocks_per_sm']} resident blocks/SM")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = flagship_model(torch)
    assert model.K.is_cuda, "ResSim.build must default to the card"
    fl = model.fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)

    # 3. K against its plain version
    B = 128
    s = torch.rand(B, NX, NY, generator=gen, device=dev)
    Fx = 0.1 * torch.randn(B, NX + 1, NY, generator=gen, device=dev)
    Fy = 0.1 * torch.randn(B, NX, NY + 1, generator=gen, device=dev)
    Fx[:, 0] = Fx[:, -1] = 0
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = torch.zeros(B, NX, NY, device=dev)
    q[:, NX // 2, NY // 2], q[:, 5, 5], q[:, -6, -6] = 1.0, -0.5, -0.5
    n_sub = torch.randint(1, 513, (B,), generator=gen, device=dev, dtype=torch.int32)
    dts_pv = 0.5 / n_sub.float()
    s_k = transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    s_t = transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    k_err = float((s_k - s_t).abs().max())
    log(f"[3] K vs plain: N={B} {NX}x{NY}, n_sub {int(n_sub.min())}..{int(n_sub.max())}: "
        f"max|ds| = {k_err:.3e} (tol {K_TOL})")
    assert torch.isfinite(s_k).all() and k_err <= K_TOL

    # 4. P against its plain version, on scaled hierarchies of prior fields
    perm = ht.sample_prior_perm(gen, model, B, r=0.8)
    mm = set_perm(model, perm)
    _, _, diag, sd, hier, Ainv = scaled_system(mm, torch.zeros(B, NX, NY, device=dev))
    qf = _source_field(model, model.inj_rates[:, 0], model.prd_rates[:, 0])
    args = (hier, Ainv, (qf * sd).contiguous(), torch.zeros_like(sd), (diag * sd).contiguous())
    # Fixed work is one restart window (8 iterations, then the residual
    # replacement and the best-iterate logic). Over more windows float32 CG
    # on these fields is chaotic: two float32 summation orders, or float32
    # against float64, part by O(1) on some members after 16 iterations.
    fixed = dict(tol=0.0, maxiter=8, patience_iters=160)
    p_k, _, _ = pressure_solve_cuda(*args, **fixed)
    p_t, _, _ = pressure_solve_torch(*args, **fixed)
    # A member whose weighted residual never improves on its start returns
    # the start (zeros) from both; that counts as agreement.
    dn, nt = (p_k - p_t).norm(dim=(-2, -1)), p_t.norm(dim=(-2, -1))
    p_err = float(torch.where((dn == 0) & (nt == 0), 0.0, dn / nt).max())
    p_abs = float((p_k - p_t).abs().max())
    log(f"[4a] P vs plain, fixed work (one window, 8 iterations): max rel |dp| = {p_err:.3e} "
        f"(tol {P_TOL}), max abs {p_abs:.3e} of max |p| {float(p_t.abs().max()):.3e}; "
        f"{int((nt == 0).sum())} members kept their start")
    assert torch.isfinite(p_k).all() and p_err <= P_TOL
    base1 = {k: BASE[k] for k in SOLVE_KEYS}
    _, it_k, rel_k = pressure_solve_cuda(*args, **base1)
    _, it_t, rel_t = pressure_solve_torch(*args, **base1)
    acc_k, acc_t = rel_k <= 5e-2, rel_t <= 5e-2
    close = float(((it_k - it_t).abs() <= 8).float().mean())
    med_k, med_t = int(it_k.median()), int(it_t.median())
    mean_k, mean_t = float(it_k.float().mean()), float(it_t.float().mean())
    log(f"[4b] P vs plain, bench settings: accepted kernel {int(acc_k.sum())}/{B}, "
        f"plain {int(acc_t.sum())}/{B}; iterations median {med_k} vs {med_t}, mean "
        f"{mean_k:.1f} vs {mean_t:.1f}; within 8 for {close:.1%}")
    # Over hundreds of float32 iterations the two summation orders take
    # different paths (see [4a]), so members at their float32 floor near the
    # acceptance line (5e-2) may land on either side. Required: the kernel
    # accepts as many members (within 2% of the batch), a member only the
    # plain version accepts is such a borderline one (kernel rel < 0.13, below
    # the floor of garbage solves, models/ressim.py in the JAX package), and
    # the iteration-count distributions agree (median within a window, mean
    # within 10%).
    only_t = acc_t & ~acc_k
    log(f"[4b] accepted by one side only: plain {int(only_t.sum())} "
        f"(kernel rel {[round(float(v), 4) for v in rel_k[only_t]]}), kernel "
        f"{int((acc_k & ~acc_t).sum())}")
    assert int(acc_k.sum()) >= int(acc_t.sum()) - max(1, B // 50)
    assert bool((rel_k[only_t] < 0.13).all())
    assert abs(med_k - med_t) <= 8 and abs(mean_k - mean_t) <= 0.1 * mean_t

    # 4c. P's Chebyshev instantiation against the plain version with the
    # same smoother, as [4a] and [4b], on N=1000 prior fields drawn from a
    # generator of their own (the later phases draw what they drew before).
    gen_c = torch.Generator(device=dev).manual_seed(SEED + 100)
    mm_c = set_perm(model, ht.sample_prior_perm(gen_c, model, N, r=0.8))
    _, _, diag_c, sd_c, hier_c, Ainv_c = scaled_system(mm_c, torch.zeros(N, NX, NY, device=dev))
    args_c = (hier_c, Ainv_c, (qf * sd_c).contiguous(), torch.zeros_like(sd_c),
              (diag_c * sd_c).contiguous())
    cheb = dict(smoother="cheb")
    pc_k, _, _ = pressure_solve_cuda(*args_c, **fixed, **cheb)
    pc_t, _, _ = pressure_solve_torch(*args_c, **fixed, **cheb)
    dn, nt = (pc_k - pc_t).norm(dim=(-2, -1)), pc_t.norm(dim=(-2, -1))
    pc_err = float(torch.where((dn == 0) & (nt == 0), 0.0, dn / nt).max())
    pc_abs = float((pc_k - pc_t).abs().max())
    log(f"[4c] P cheb vs plain cheb, N={N}, fixed work (one window): max rel |dp| = "
        f"{pc_err:.3e} (tol {P_TOL}), max abs {pc_abs:.3e} of max |p| "
        f"{float(pc_t.abs().max()):.3e}; {int((nt == 0).sum())} members kept their start")
    assert torch.isfinite(pc_k).all() and pc_err <= P_TOL
    _, itc_k, relc_k = pressure_solve_cuda(*args_c, **base1, **cheb)
    _, itc_t, relc_t = pressure_solve_torch(*args_c, **base1, **cheb)
    _, itj_k, relj_k = pressure_solve_cuda(*args_c, **base1)
    acc_k, acc_t = relc_k <= 5e-2, relc_t <= 5e-2
    med_k, med_t = int(itc_k.median()), int(itc_t.median())
    mean_k, mean_t = float(itc_k.float().mean()), float(itc_t.float().mean())
    only_t = acc_t & ~acc_k
    log(f"[4c] P cheb vs plain cheb, bench settings, N={N}: accepted kernel "
        f"{int(acc_k.sum())}/{N}, plain {int(acc_t.sum())}/{N}; iterations median {med_k} vs "
        f"{med_t}, mean {mean_k:.1f} vs {mean_t:.1f}; within 8 for "
        f"{float(((itc_k - itc_t).abs() <= 8).float().mean()):.1%}; accepted by the plain version "
        f"only {int(only_t.sum())} (kernel rel {[round(float(v), 4) for v in relc_k[only_t]]}); "
        f"P jacobi on the same fields: accepted {int((relj_k <= 5e-2).sum())}/{N}, iterations "
        f"median {int(itj_k.median())} mean {float(itj_k.float().mean()):.1f}")
    # Held by acceptance counts and iteration distributions. At N=1000 a
    # member may stall at its start (weighted residual never below the
    # initial one, rel 1.0) on one float32 path and converge on the other:
    # the stall is the algorithm's, it occurs in float64 too (with either
    # smoother), so a per-member bound as in [4b] does not hold here.
    assert int(acc_k.sum()) >= int(acc_t.sum()) - max(1, N // 50)
    assert abs(med_k - med_t) <= 8 and abs(mean_k - mean_t) <= 0.1 * mean_t

    # 5. the flagship workload
    _, R12 = ht.temporal_R(NTIME, model.nPrd, dtype=torch.float32)
    truth = ht.sample_prior_perm(gen, model, 1, r=0.8)[0]
    prior = ht.sample_prior_perm(gen, model, N, r=0.8)
    noise = R12 @ torch.randn(NTIME * model.nPrd, generator=gen, device=dev)

    def p_count():  # P launches of either smoother
        return _build.LAUNCHES["pressure_pcg"] + _build.LAUNCHES["pressure_pcg_cheb"]

    def make_fwd(kw, stats):
        def fwd(E):
            torch.cuda.synchronize()
            t, p_before = time.perf_counter(), p_count()
            wsats, prods, res = ht.forward_model(model, E, dt=DT, nTime=NTIME,
                                                 keep_wsats=False, return_sim=True, **kw)
            torch.cuda.synchronize()
            stats.append(dict(seconds=time.perf_counter() - t, res=res, final=wsats,
                              p_launches=p_count() - p_before))
            return prods.reshape(prods.shape[0], -1)
        return fwd

    def log_passes(tag, stats, kws):
        for i, (st, kw) in enumerate(zip(stats, kws)):
            res = st["res"]
            plan = recook_plan(N, NY, kw["maxiter"], kw["two_pass"], kw["twopass_j1"],
                               kw["twopass_div"])
            log(f"[{tag}] pass {i + 1}: {st['seconds']:.3f} s; recook K={plan and plan[1]}, "
                f"members recooked a step {float(res.recooked.sum()) / NTIME:.2f}, P launches "
                f"{st['p_launches']}; cg_ok {float(res.cg_ok.float().mean()):.1%}; cg_iters "
                f"median {int(res.cg_iters.median())} max {int(res.cg_iters.max())}; substeps "
                f"median {int(res.substeps.median())}")

    def check_states(stats):
        for st in stats:
            for x in (st["final"], st["res"].prd_sats):
                assert torch.isfinite(x).all()
                assert float(x.min()) >= fl.swc and float(x.max()) <= 1.0 - fl.sor

    rmse = lambda E: float(((E.mean(0) - truth) ** 2).mean().sqrt())  # noqa: E731
    spread = lambda E: float(E.std(0).mean())  # noqa: E731
    kws = [dict(BASE, **ov) for ov in SCHED]
    stats = []
    fwds = [make_fwd(kw, stats) for kw in kws]
    gen_state_5 = gen.get_state()  # [15] replays [5]'s draws
    _build.reset_launches()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    _, prod_truth = ht.forward_model(model, truth[None], dt=DT, nTime=NTIME,
                                     keep_wsats=False, **BASE)
    obs = torch.clamp(prod_truth[0].reshape(-1) + noise, 0, 1)
    post = ht.es_mda(prior, fwds, obs, R12, ht.mda_alphas(PASSES), generator=gen)
    torch.cuda.synchronize()
    total = time.perf_counter() - t_start
    launches = dict(_build.LAUNCHES)

    log_passes("5", stats, kws)
    log(f"[5] N={N} {NX}x{NY} nTime={NTIME} {PASSES}-pass ES-MDA total {total:.3f} s "
        f"(truth sim + forward passes + analyses, synchronized)")
    log(f"[5] rmse vs truth: prior {rmse(prior):.4f} -> posterior {rmse(post):.4f}; "
        f"spread prior {spread(prior):.4f} -> posterior {spread(post):.4f}")
    log(f"[5] kernel launches on the main path: {launches}")
    assert all(launches[k] >= (1 + PASSES) * NTIME for k in JACOBI_KERNELS), launches
    assert launches["pressure_pcg_cheb"] == 0, launches
    # the recook engages on every pass of the schedule: three P launches a step
    assert all(st["p_launches"] == 3 * NTIME for st in stats), [st["p_launches"] for st in stats]
    check_states(stats)
    assert torch.isfinite(post).all() and post.shape == prior.shape
    assert spread(post) < spread(prior)

    # 6. kernel vs plain time at the main path's shapes: one step from the
    # last forward pass's final states, at the final pass's solver settings.
    s_end = stats[-1]["final"][:, 0].reshape(N, NX, NY).contiguous()
    mm = set_perm(model, post)
    q1 = _source_field(model, model.inj_rates[:, 0], model.prd_rates[:, 0])
    TX, TY, diag, sd, hier, Ainv = scaled_system(mm, s_end)
    args = (hier, Ainv, (q1 * sd).contiguous(), torch.zeros_like(sd), (diag * sd).contiguous())
    final = dict(BASE, **FINAL)
    kw = {k: final[k] for k in SOLVE_KEYS}
    p_ms = cuda_ms(lambda: pressure_solve_cuda(*args, **kw), 3)
    p_plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **kw), 1)
    y, p_iters, _ = pressure_solve_cuda(*args, **kw)
    p_bound, p_by = pressure_bound_ms(hier, Ainv, p_iters)
    Fx, Fy = (F.contiguous() for F in face_fluxes(TX, TY, y * sd))
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, q1, DT)
    q1 = q1[None].contiguous()  # one source field, read by every member
    t_ms = cuda_ms(lambda: transport_substeps_cuda(s_end, Fx, Fy, q1, dtspv, nsub, fluid), 5)
    t_plain_ms = cuda_ms(lambda: transport_substeps_torch(s_end, Fx, Fy, q1, dtspv, nsub,
                                                          fluid), 1)
    t_bound, t_by = transport_bound_ms(s_end, Fx, Fy, q1, nsub)
    t_err = float((transport_substeps_cuda(s_end, Fx, Fy, q1, dtspv, nsub, fluid)
                   - transport_substeps_torch(s_end, Fx, Fy, q1, dtspv, nsub, fluid)).abs().max())
    log(f"[6] one step at N={N} {NX}x{NY}: pressure kernel {p_ms:.3f} ms vs plain "
        f"{p_plain_ms:.3f} ms, bound {p_bound:.4f} ms ({p_by}; cg_iters median "
        f"{int(p_iters.median())} mean {float(p_iters.float().mean()):.1f}); transport kernel "
        f"{t_ms:.3f} ms vs plain {t_plain_ms:.3f} ms, bound {t_bound:.4f} ms ({t_by}; substeps "
        f"median {int(nsub.median())} max {int(nsub.max())}; max|ds| vs plain {t_err:.3e}, "
        f"tol {K_TOL})")
    assert t_err <= K_TOL
    six = dict(t_args=(s_end, Fx, Fy, q1, dtspv, nsub, fluid), t_ms=t_ms, t_plain_ms=t_plain_ms,
               mm=mm, s_end=s_end, q1=q1[0], kw=kw, p_ms={"jacobi": p_ms}, p_args=args)

    # 6b. the recooked solve of that step: three P launches and the torch
    # ops between them, with the bound of the iterations all passes ran
    rec_ms = cuda_ms(lambda: pressure_solve_recook(*args, **final), 3)
    _, rec_iters, rel_rk, rec_k = pressure_solve_recook(*args, **final)
    rec_bound, rec_by = pressure_bound_ms(hier, Ainv, rec_iters)
    log(f"[6b] recooked solve of one step at N={N}: {rec_ms:.3f} ms (single launch at maxiter "
        f"{kw['maxiter']}: {p_ms:.3f} ms), bound {rec_bound:.4f} ms ({rec_by}; iterations "
        f"summed over the passes: median {int(rec_iters.median())} mean "
        f"{float(rec_iters.float().mean()):.1f}; {int(rec_k.sum())} members recooked)")

    # 7. where a step's device time goes: 10 steps of a loose pass, from the
    # last pass's final states, unprofiled for the wall time, then profiled.
    wsat = s_end.reshape(N, -1)
    prof_kw = dict(dt=DT, nTime=10, keep_wsats=False, **dict(BASE, **LOOSE))
    ht.simulate(mm, wsat, **dict(prof_kw, nTime=1))
    stages, busy, wall_ms, acts = profile_steps(lambda: ht.simulate(mm, wsat, **prof_kw), 10)
    log(f"[7] profile, 10 loose-pass steps at N={N}: per step " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in stages.items())
        + f"; device busy {busy:.3f} ms of {wall_ms:.3f} ms unprofiled wall, idle "
        f"{1 - busy / wall_ms:.1%}; {acts:.1f} device activities a step")

    # 8. the recook on the card against the recook around P's plain version,
    # on [6]'s inputs. The plan comes from shapes, so K is the same; float32
    # ties near the cut may swap a few members, and members at their float32
    # floor near the acceptance line may land on either side (see [4b]).
    plan = recook_plan(N, NY, final["maxiter"], True, final["twopass_j1"], final["twopass_div"])
    _, rec_iters_t, rel_rt, rec_t = pressure_solve_recook(*args, solve=pressure_solve_torch,
                                                          **final)
    both = int((rec_k & rec_t).sum())
    n_k, n_t = int(rec_k.sum()), int(rec_t.sum())
    acc_rk, acc_rt = int((rel_rk <= 5e-2).sum()), int((rel_rt <= 5e-2).sum())
    med_rk, med_rt = int(rec_iters.median()), int(rec_iters_t.median())
    log(f"[8] recook, card vs plain, N={N}: K={plan[1]} of Nb={plan[0]}; recooked {n_k} vs {n_t}, "
        f"{both} in both ({both / min(n_k, n_t):.1%}); accepted {acc_rk} vs {acc_rt}; iterations "
        f"median {med_rk} vs {med_rt}, max {int(rec_iters.max())} vs {int(rec_iters_t.max())}")
    assert 0 < n_k <= plan[1] and 0 < n_t <= plan[1]
    assert both >= 0.95 * min(n_k, n_t)
    assert abs(acc_rk - acc_rt) <= 0.02 * N
    assert abs(med_rk - med_rt) <= 8

    # 9. localized ES-MDA: 4x4-cell domains (256) with the bump taper of
    # radius 1.2 around the producers; p = 160 <= N, the obs-space branch.
    domains, taper_dom = domain_partition(model.grid, prod_inds(model), nTime=NTIME, steps=(4, 4),
                                          radius=1.2, dtype=torch.float32)
    stats_loc = []
    fwds = [make_fwd(kw, stats_loc) for kw in kws]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post_loc = ht.es_mda(prior, fwds, obs, R12, ht.mda_alphas(PASSES), generator=gen,
                         domains=domains, taper_dom=taper_dom)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_loc = dict(_build.LAUNCHES)
    log_passes("9", stats_loc, kws)
    log(f"[9] localized {PASSES}-pass ES-MDA, {domains.shape[0]} domains of {domains.shape[1]} "
        f"cells, p={obs.numel()}: {wall:.3f} s, of which analyses "
        f"{wall - sum(st['seconds'] for st in stats_loc):.3f} s; rmse prior {rmse(prior):.4f} -> "
        f"{rmse(post_loc):.4f}; spread {spread(prior):.4f} -> {spread(post_loc):.4f}; launches "
        f"{launches_loc}")
    assert domains.shape == (NX * NY // 16, 16) and obs.numel() <= N
    assert all(launches_loc[k] >= PASSES * NTIME for k in JACOBI_KERNELS), launches_loc
    check_states(stats_loc)
    assert torch.isfinite(post_loc).all() and post_loc.shape == prior.shape
    assert spread(post_loc) < spread(prior)

    # 10. IES: 10 Gauss-Newton iterations of step 0.4, 8 loose and 2 at the
    # final pass's settings. Its pseudo-inverse is torch.linalg.pinv, an SVD
    # of the N x N weights each iteration; timed on the last weights.
    ies_kws = [dict(BASE, **ov) for ov in IES_SCHED]
    stats_ies, weights = [], []
    fwds = [make_fwd(kw, stats_ies) for kw in ies_kws]
    perturbs = ht.gaussian_noise(N, obs.numel(), L=R12, generator=gen)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post_ies, _ = ht.ies(prior, fwds, obs, perturbs, decorrelator(R12), xStep=IES_STEP,
                         iMax=IES_ITERS, callback=lambda info: weights.append(info["W"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_ies = dict(_build.LAUNCHES)
    pinv_ms = cuda_ms(lambda: torch.linalg.pinv(weights[-1]), 3)
    log_passes("10", stats_ies, ies_kws)
    log(f"[10] IES, {IES_ITERS} iterations, xStep {IES_STEP}: {wall:.3f} s, of which outside the "
        f"forward runs {wall - sum(st['seconds'] for st in stats_ies):.3f} s; pinv of the "
        f"{N}x{N} weights {pinv_ms:.3f} ms; rmse prior {rmse(prior):.4f} -> {rmse(post_ies):.4f}; "
        f"spread {spread(prior):.4f} -> {spread(post_ies):.4f}; launches {launches_ies}")
    assert all(launches_ies[k] >= IES_ITERS * NTIME for k in JACOBI_KERNELS), launches_ies
    check_states(stats_ies)
    assert torch.isfinite(post_ies).all() and post_ies.shape == prior.shape
    assert spread(post_ies) < spread(prior)

    en, robust14 = enopt_phases(dev, gen)

    # 15. the flagship ES-MDA with the Chebyshev smoother: [5]'s truth, data,
    # prior, schedule and obs-error draws, P's cheb instantiation on every
    # solve; then P cheb a launch on [6]'s inputs against its plain version.
    kws_c = [dict(kw, smoother="cheb") for kw in kws]
    stats_c = []
    fwds = [make_fwd(kw, stats_c) for kw in kws_c]
    gen_c = torch.Generator(device=dev)
    gen_c.set_state(gen_state_5)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ht.forward_model(model, truth[None], dt=DT, nTime=NTIME, keep_wsats=False, smoother="cheb",
                     **BASE)
    post_c = ht.es_mda(prior, fwds, obs, R12, ht.mda_alphas(PASSES), generator=gen_c)
    torch.cuda.synchronize()
    total_c = time.perf_counter() - t0
    launches_c = dict(_build.LAUNCHES)
    log_passes("15", stats_c, kws_c)
    log(f"[15] N={N} {NX}x{NY} nTime={NTIME} {PASSES}-pass ES-MDA, Chebyshev smoother: total "
        f"{total_c:.3f} s (damped Jacobi, [5]: {total:.3f} s); cg_iters summed over the members "
        f"and steps per pass {[int(st['res'].cg_iters.sum()) for st in stats_c]} (Jacobi "
        f"{[int(st['res'].cg_iters.sum()) for st in stats]}); rmse prior {rmse(prior):.4f} -> "
        f"{rmse(post_c):.4f} (Jacobi {rmse(post):.4f}); spread {spread(prior):.4f} -> "
        f"{spread(post_c):.4f} (Jacobi {spread(post):.4f}); launches {launches_c}")
    assert launches_c["pressure_pcg"] == 0, launches_c
    assert all(launches_c[k] >= (1 + PASSES) * NTIME
               for k in ("pressure_pcg_cheb", "transport_upwind")), launches_c
    check_states(stats_c)
    assert torch.isfinite(post_c).all() and spread(post_c) < spread(prior)
    p_kw = dict({k: final[k] for k in SOLVE_KEYS}, **cheb)  # [6]'s settings
    pc_ms = cuda_ms(lambda: pressure_solve_cuda(*args, **p_kw), 3)
    pc_plain_ms = cuda_ms(lambda: pressure_solve_torch(*args, **p_kw), 1)
    pc_iters = pressure_solve_cuda(*args, **p_kw)[1]
    pc_bound, pc_by = pressure_bound_ms(hier, Ainv, pc_iters, P_FLOPS_VCYCLE_CHEB)
    six["p_ms"]["cheb"] = pc_ms
    log(f"[15] one step at N={N} {NX}x{NY} ([6]'s inputs): P cheb {pc_ms:.3f} ms vs plain "
        f"{pc_plain_ms:.3f} ms, bound {pc_bound:.4f} ms ({pc_by}, {pc_bound / pc_ms:.1%}; cg_iters "
        f"median {int(pc_iters.median())} mean {float(pc_iters.float().mean()):.1f}); P jacobi "
        f"{p_ms:.3f} ms, cg_iters median {int(p_iters.median())} mean "
        f"{float(p_iters.float().mean()):.1f}")

    # 16. ILES over [9]'s 256 domains at the flagship size: [10]'s prior,
    # data and perturbations, 10 Gauss-Newton iterations of step 0.4, one
    # forward operator at the final pass's settings.
    from historymatching_tpu_torch import profiling
    from historymatching_tpu_torch.da.update import _iles_inner, _taper_weights

    fin = dict(BASE, **FINAL)
    stats_il, last, ends = [], {}, []

    def keep_last(info):
        last.update(info)
        ends.append(info["elapsed_s"])

    fwd_il = make_fwd(fin, stats_il)
    dec = decorrelator(R12)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    post_il, st_il = ht.iles_domains(prior, fwd_il, obs, perturbs, dec, taper_dom, domains,
                                     xStep=IES_STEP, iMax=ILES_ITERS, callback=keep_last)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_il = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outside = wall - sum(st["seconds"] for st in stats_il)
    # An iteration's time outside its forward run (recompose, innovations
    # and the GN step), from the callback's clock.
    per_iter = [1e3 * (b - a - st["seconds"])
                for a, b, st in zip([0.0] + ends[:-1], ends, stats_il)]
    # One more GN step from the final state, timed and then profiled.
    Eo_w = last["Eo"] @ dec
    innov = (obs - last["Eo"] - perturbs) @ dec
    w_dom = _taper_weights(taper_dom)
    gn = lambda: _iles_inner(last["Ws"], Eo_w, innov, IES_STEP, w_dom)  # noqa: E731
    gn_s, gn_first_s = profiling.timed(gn, repeats=2)
    gn_ms, n_pinv_gn = 1e3 * gn_s, gn()[1]
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            gn()
        gn_dev = profiling.parse_trace(d).device
    gn_busy = 1e3 * sum(gn_dev.values())
    top = sorted(gn_dev.items(), key=lambda kv: -kv[1])[:6]
    nDom, p_obs = domains.shape[0], obs.numel()
    gn_bound, gn_by = bound(nDom * ILES_FLOPS(N, p_obs), 4 * 2 * nDom * N * N)
    log_passes("16", stats_il, [fin] * ILES_ITERS)
    log(f"[16] ILES, {nDom} domains of {domains.shape[1]} cells, N={N}, p={p_obs}, "
        f"{ILES_ITERS} iterations, xStep {IES_STEP}: {wall:.3f} s, of which outside the forward "
        f"runs {outside:.3f} s, per iteration (ms) {[round(v, 1) for v in per_iter]}; domains "
        f"through pinv per iteration {st_il['pinv_domains'].tolist()}; peak device memory "
        f"{peak_gb:.2f} GB; rmse prior {rmse(prior):.4f} -> {rmse(post_il):.4f}; spread "
        f"{spread(prior):.4f} -> {spread(post_il):.4f}; launches {launches_il}")
    log(f"[16] one more GN step from the final weights: {gn_ms:.1f} ms of wall (best of 2; first "
        f"{1e3 * gn_first_s:.1f} ms; {n_pinv_gn} domains through pinv), the card busy "
        f"{gn_busy:.1f} ms of it; bound {gn_bound:.2f} ms ({gn_by}, {gn_bound / gn_ms:.1%}); "
        f"device time by activity (ms): "
        + "; ".join(f"{name[:60]} {1e3 * sec:.1f}" for name, sec in top))
    assert all(launches_il[k] >= ILES_ITERS * NTIME for k in JACOBI_KERNELS), launches_il
    check_states(stats_il)
    assert torch.isfinite(post_il).all() and post_il.shape == prior.shape
    assert spread(post_il) < spread(prior)
    del last, st_il

    # 17. resume: a 4-pass ES-MDA at N=200 uninterrupted, then stopped after
    # pass 2 by its callback, checkpointed, loaded and resumed at pass 2.
    from historymatching_tpu_torch import checkpoint

    prior_r = prior[:RESUME_N]
    fwds_r = [make_fwd(kw, []) for kw in kws]
    seed_r = SEED + 17
    mda = lambda E, g, **k: ht.es_mda(E, fwds_r, obs, R12, ht.mda_alphas(PASSES),  # noqa: E731
                                      generator=g, **k)
    t0 = time.perf_counter()
    ref_r = mda(prior_r, torch.Generator(device=dev).manual_seed(seed_r))
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0

    class Stop(Exception):
        pass

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "es_mda.npz")

        def save(info):
            if info["pass_"] == 2:
                checkpoint.save_checkpoint(path, {"E": info["E"], "pass": info["pass_"],
                                                  "gen": info["generator_state"]})
                raise Stop

        t0 = time.perf_counter()
        try:
            mda(prior_r, torch.Generator(device=dev).manual_seed(seed_r), callback=save)
            raise AssertionError("the callback did not stop the run")
        except Stop:
            pass
        st_r = checkpoint.load_checkpoint(path)
        gen_r = torch.Generator(device=dev)
        gen_r.set_state(torch.from_numpy(st_r["gen"]))
        post_r = mda(torch.from_numpy(st_r["E"]).to(dev), gen_r, start_pass=st_r["pass"])
        torch.cuda.synchronize()
        t_resumed = time.perf_counter() - t0
    same = bool(torch.equal(post_r, ref_r))
    log(f"[17] ES-MDA resume, N={RESUME_N}, {PASSES} passes: uninterrupted {t_full:.3f} s; "
        f"2 passes, checkpoint, load, 2 passes {t_resumed:.3f} s; posteriors equal bit for bit: "
        f"{same} (max |d| {float((post_r - ref_r).abs().max()):.3e})")
    assert same

    new = new_grid_phases(dev, six)
    runs = example_phases()
    par = parity_phase(card, opts.parity_out)
    large = large_grid_phases(dev, six)
    big = large_case_phase(dev)
    layer = layer_case_phase()
    mesh_run = mesh_phase(dev, dict(
        flagship=dict(model=model, truth=truth, prior=prior, obs=obs, R12=R12,
                      gen_state=gen_state_5, launches=launches, perturbs=perturbs,
                      launches_ies=launches_ies),
        robust=robust14))

    def record(name, route, source, replaces, err, ms, plain_ms, bound_ms, by):
        return dict(name=name, route=route, source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=by, library_ms=None,
                    share_of_bound=bound_ms / ms,
                    **{f"enopt_20x20_{k}": v for k, v in en[name].items()})

    kernels = [
        record("transport_upwind", "cuda", "historymatching_tpu_torch/csrc/transport_upwind.cu",
               "historymatching_tpu/ops/transport_pallas.py:68", k_err, t_ms, t_plain_ms,
               t_bound, t_by),
        record("pressure_pcg", "cuda", "historymatching_tpu_torch/csrc/pressure_pcg.cu",
               "historymatching_tpu/ops/pressure_pallas.py:34", p_abs, p_ms, p_plain_ms,
               p_bound, p_by),
        # smoother="cheb" of the same TPU kernel; its path is [15]
        dict(name="pressure_pcg_cheb", route="cuda",
             source="historymatching_tpu_torch/csrc/pressure_pcg.cu",
             replaces="historymatching_tpu/ops/pressure_pallas.py:34",
             launches=launches_c["pressure_pcg_cheb"], max_abs_err=pc_abs, ms=pc_ms,
             plain_ms=pc_plain_ms, bound_ms=pc_bound, bound_by=pc_by, library_ms=None,
             share_of_bound=pc_bound / pc_ms),
    ]
    # The new grids of each kernel, and the launches of [21]'s example runs.
    for rec in kernels:
        rec["grids"] = new.get(rec["name"], {}).get("grids", {})
        rec["launches_examples"] = {r["run"]: r["launches"].get(rec["name"], 0) for r in runs}
    rt, rt_large = new["transport_upwind_rt"], large.pop("transport_upwind_rt")
    # K-rt, the strip body built for a grid outside GRIDS: its path is
    # [23]'s simulate at 60x60; timed at [6]'s inputs (64x64, built for it
    # and forced, against the templated K and K-rt1 there), and at [18]'s
    # grids beside K-rt1.
    kernels.append(dict(
        name="transport_upwind_rt", route="cuda",
        source="historymatching_tpu_torch/csrc/transport_upwind.cu",
        replaces="historymatching_tpu/ops/transport_pallas.py:68",
        launches=rt_large["launches_simulate_60x60"], max_abs_err=rt["max_abs_err"],
        ms=rt["ms"], plain_ms=rt["plain_ms"], bound_ms=rt["bound_ms"], bound_by=rt["bound_by"],
        library_ms=None, share_of_bound=rt["bound_ms"] / rt["ms"], templated_ms=rt["templated_ms"],
        rt1_ms=rt["rt1_ms"], grids=rt["grids"],
        launches_examples={r["run"]: r["launches"].get("transport_upwind_rt", 0) for r in runs}))
    # K-rt1, the tile body with a member in one block: its path is [23]'s
    # simulate at ROUTE_PATHS' grid, timed there, and [21]'s optimise
    # --small (12x12); forced at [18]'s grids and at [6]'s inputs.
    rt1, rt1_at = large.pop("transport_upwind_rt1"), "x".join(map(str, ROUTE_PATHS["rt1"]))
    g = rt1["grids"][rt1_at]
    kernels.append(dict(
        name="transport_upwind_rt1", route="cuda",
        source="historymatching_tpu_torch/csrc/transport_upwind.cu",
        replaces="historymatching_tpu/ops/transport_pallas.py:68",
        launches=rt1[f"launches_simulate_{rt1_at}"], max_abs_err=g["max_abs_err"], ms=g["ms"],
        plain_ms=g["plain_ms"], bound_ms=g["bound_ms"], bound_by=g["bound_by"], library_ms=None,
        share_of_bound=g["share_of_bound"], at_grid=rt1_at,
        grids=dict(new["transport_upwind_rt1"]["grids"], **rt1["grids"]),
        forced_64x64=new["transport_upwind_rt1"]["forced_64x64"],
        launches_examples={r["run"]: r["launches"].get("transport_upwind_rt1", 0) for r in runs}))
    # P with an explicit fine diagonal: its path is [19b]'s
    # simulate(scale_system=False); timed at [6]'s shapes.
    for name in ("pressure_pcg_diag", "pressure_pcg_cheb_diag"):
        d = new[name]
        kernels.append(dict(
            name=name, route="cuda", source="historymatching_tpu_torch/csrc/pressure_pcg.cu",
            replaces="historymatching_tpu/ops/pressure_pallas.py:34", launches=d["launches"],
            max_abs_err=d["max_abs_err"], ms=d["ms"], plain_ms=d["plain_ms"],
            bound_ms=d["bound_ms"], bound_by=d["bound_by"], library_ms=None,
            share_of_bound=d["bound_ms"] / d["ms"], grids=d["grids"]))
    # The cluster variants: P-cl's and K-cl's path is [24], each checked and
    # timed on [24]'s first step; the other P-cl instantiations' path is
    # [23]'s simulate at 128x128, timed there at bench settings. P-gm's and
    # K-gm's path is [23]'s simulate at GM_PATH_GRID, each timed there (P-gm
    # in its four instantiations, on the first step's system; K-gm's
    # widened plan at GM1_PATH_GRID and CAPACITY_GRID in its grids), P-gm1's
    # [23]'s simulate at GM1_PATH_GRID and K-gm1's at ROUTE_PATHS' grid,
    # timed there; their times forced on [24]'s first step are kept as
    # `large_case`.
    gm_at = f"{GM_PATH_GRID[0]}x{GM_PATH_GRID[1]}"
    gm1_at = f"{GM1_PATH_GRID[0]}x{GM1_PATH_GRID[1]}"
    k_path = {name: gm_at if name.endswith("_gm") else gm1_at
              for name in large if name.endswith(("_gm", "_gm1"))}
    k_path["transport_upwind_gm1"] = "x".join(map(str, ROUTE_PATHS["gm1"]))
    for name, d in large.items():
        route = name.rsplit("_", 1)[1]
        at = k_path.get(name, f"{BIG[0]}x{BIG[1]}")
        g, err = d["grids"][at], d["max_abs_err"]
        if name in big["kernels"] and name not in k_path:
            at, g = f"{BIG[0]}x{BIG[1]} N={N} ([24]'s first step)", big["kernels"][name]
            err = max(err, g["max_abs_err"])
        if name in k_path:
            d["large_case"] = big["kernels"].get(name)
        if route == "cl":
            launches_path = (big["launches"][name] if name in big["launches"]
                             else d[f"launches_simulate_{BIG[0]}x{BIG[1]}"])
        else:
            launches_path = d[f"launches_simulate_{k_path[name]}"]
        source = ("transport_upwind.cu" if name.startswith("transport")
                  else f"pressure_pcg_{route}.cu")
        kernels.append(dict(
            name=name, route="cuda", source="historymatching_tpu_torch/csrc/" + source,
            replaces=("historymatching_tpu/ops/transport_pallas.py:68"
                      if name.startswith("transport")
                      else "historymatching_tpu/ops/pressure_pallas.py:34"),
            launches=launches_path, max_abs_err=err, ms=g["ms"], plain_ms=g.get("plain_ms"),
            bound_ms=g["bound_ms"], bound_by=g["bound_by"], library_ms=None,
            share_of_bound=g["bound_ms"] / g["ms"], at_grid=at, grids=d["grids"],
            **{k: v for k, v in d.items() if k.startswith("launches_simulate")},
            **{k: d[k] for k in ("forced_64x64", "large_case") if k in d}))
    # P-cl/d, under its P-cl counters: the Jacobi instantiation's path is
    # [24b] at 60x220 where its route takes N (checked and timed on its
    # first step); the others' (and the Jacobi one's past P-cl/d's batch)
    # is [23]'s simulate at 60x220, timed there at bench settings (N=64).
    from historymatching_tpu_torch.ops.pressure import kernel_name

    lay_at = f"{LAYER_GRIDS[0][0]}x{LAYER_GRIDS[0][1]}"
    lay = layer[lay_at]
    for smoother, unit in P_GM:
        name = kernel_name(smoother, unit, "cl")
        d = large[name]
        dist = {t: g for t, g in d["grids"].items() if g.get("inverse") == "distributed"}
        jacobi = (smoother, unit) == ("jacobi", True)
        if jacobi and lay["route"] == "cl":
            g, at = lay["kernels"]["cl"], f"{lay_at} N={N} ([24b]'s first step)"
            launches_path = lay["launches"][name]
        else:  # past P-cl/d's batch [24b]'s route is P-gm1's
            g, at = dist[lay_at], f"{lay_at} N={LARGE_N}"
            launches_path = d[f"launches_simulate_{lay_at}"]
        gm1_ms = lay["kernels"]["gm1"]["ms"] if jacobi else None
        kernels.append(dict(
            name=name + "/d", counter=name, route="cuda",
            source="historymatching_tpu_torch/csrc/pressure_pcg_cl.cu",
            replaces="historymatching_tpu/ops/pressure_pallas.py:34", launches=launches_path,
            max_abs_err=max([g["max_abs_err"]] + [x["max_abs_err"] for x in dist.values()]),
            ms=g["ms"], plain_ms=g.get("plain_ms"), bound_ms=g["bound_ms"],
            bound_by=g["bound_by"], library_ms=None, share_of_bound=g["bound_ms"] / g["ms"],
            at_grid=at, gm1_ms=gm1_ms, grids=dist))
    for rec in kernels:
        rec["launches_parity"] = {p["name"]: p["launches"].get(rec.get("counter", rec["name"]), 0)
                                  for p in par}
    # every kernel in the record was launched on its path
    assert all(rec["launches"] > 0 for rec in kernels), [
        (rec["name"], rec["launches"]) for rec in kernels if not rec["launches"] > 0]
    log(f"[24] record: {json.dumps({k: v for k, v in big.items() if k != 'passes'})}")
    log(f"[24b] record: {json.dumps(layer)}")
    log(f"[25] record: {json.dumps(mesh_run)}")
    log(f"[walls] seconds from the start to each phase's first line: {json.dumps(PHASE_AT)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
