#!/usr/bin/env python3
"""Time each route of kernels P and K against the others on one NVIDIA GPU.

    python3 bench_routes.py [--out FILE] [--kernel P|K|gm1|cl|kcl|k1|tileregs]
                            [--grids 15x15,...]
                            [--root DIR]

The evidence behind `ops/pressure.route` and `ops/transport.route` past one
block: P-cl (a thread-block cluster a member, on the grid's `cl_plan`)
against P-gm (a member over co-resident blocks, on the grid's `gm_plan`)
and P-gm1 (one block a member, its coarse levels and fine faces in
shared memory, the rest in device memory, its inverse streamed through a
ring of bulk copies), and where
that plan distributes the coarsest inverse over the ranks (P-cl/d: 100x100,
60x220) also against the plan that reads it in place from device memory on
two ranks ("cl_device"); P-gm against P-gm1 at 120x440 (no cluster holds
it) at N=16, 64 and 1000, with ladders at the scaled 100x100 (N=128-512),
120x440 (N=16-256) and 60x220 (N=128-512); K-cl
against K-rt1 (the tile body, a member in one block) and K-gm (a member over co-resident
blocks a band of rows); on `chip_smoke.py` [23]'s grids and its kind of
inputs (the flagship geometry, a prior drawn for each grid from seed 1 +
23, the unscaled system on fields of mild contrast), at [23]'s N=64 and
at the bench case's N=1000; on the grids no cluster takes (120x440,
171x171) K-gm against K-gm1 (co-resident 2-D tiles) at N=16, 64 and 1000;
K-rt (the strip body built for the grid) against K-rt1 on
`chip_smoke.py` [18]'s grids, 60x60 and 75x75 at N=64 and 1000;
and K-gm on its widened plans against K-gm1 at 32x1088 and 600x600 at
N=4 to 1000, 1057x440 and 1000x1000 (their step solved by the diagonally
preconditioned `pcg` in torch ops: P's coarse inverse at 600x600 is 126
MB a member, at 1000x1000 1 GB; 1057x440 has no hierarchy) at N=4, 64
and (1057x440) 1000.
P runs one launch at the bench settings (tol 2e-4, maxiter 768, patience
256) and K the substeps of the first step. Each line gives each variant's
milliseconds a launch (CUDA events, the mean of `--reps` after a warm-up),
P's iteration median and maximum (a launch lasts as long as its slowest
member), P's bound (`chip_smoke.pressure_bound_ms` on that run's
iterations) and, for a variant that reads the inverse from device memory
every V-cycle (P-gm1, the in-place plan), the floor that reading sets
(`chip_smoke.inverse_floor_ms`: its bytes once a V-cycle of each member at
the card's memory rate) and its share of the time, and P-gm1's plan; each
variant's members accepted (rel <= 5e-2); for P-cl its clusters resident
on the card, its cluster barriers an iteration (where the checkout has
P-cl's probe build: `chip_smoke.cl_iteration_barriers`) and an estimate
of an iteration's time (the launch's time x clusters resident / members /
mean iterations, which counts the last wave's idle tail). The card's name
and power limit come first; `--out` writes the rows as JSON; `--grids`
keeps the rows of those grids only. Raises without CUDA.

`--kernel gm1` times P-gm1's own choices instead (`gm1_row`, GM1_CASES):
its route's plan (`ops/pressure.gm1_plan`) and a whole block's, with the
coarsest inverse streamed through the ring or read by plain loads (the
ring's control, `_build.pressure_gm1_loads_lib`), at fixed work, p bit for
bit the same across them; and the route's plan at the bench settings.
`--kernel cl` times P-cl on `chip_smoke.py` [24]'s first step (the bench
case at 128x128, N=1000, the first pass's settings; `cl_row`): the route's
plan held to the plain version after one window (`chip_smoke.P_TOL`),
with its iterations, members accepted, bound, clusters resident, barriers
and iteration estimate, and a hash of p (equal hashes: the same bits); then P's, K's and the wall's time a step over 10
first-pass steps, profiled. `--kernel kcl` times K-cl on the same first
step's substeps (`kcl_row`): its route's plan and, where the checkout has
K-cl's plans, a ladder of them (KCL_LADDER), each bit for bit with the
plain version, with its registers, spills, ranks an SM, clusters
resident, an estimate of a substep's time (the launch's time x clusters
resident / members / mean substeps, which counts the last wave's tail)
and a hash of s, then its candidate plans (`cl_candidates`) at its grids
at N=64 and 1000. A K row carries the same figures for K-cl's plan; at
80x80, 88x88 and 96x96 K-cl and K-rt are also timed at N=128 and 256
(K_CL_MEMBERS). `--kernel k1` times K-rt1 and K-gm1 (`k1_row`) on the
first step's substeps (`k_inputs`, the pressure step by the diagonally
preconditioned `pcg` in torch ops) at K1_ROWS' grids and batches: the
route's body, K-rt1 where it takes the grid, K-gm1 where the route is
another, K-rt on small grids, and in a checkout with K-gm1's
device-memory plans (`ops/transport.GM1Device`) K-gm1's tiles and one
block a member, or past its tiles the card's blocks spread over the
batch, beside its route's plan; each with a hash of
s (equal hashes: the same bits; every variant equal to the first); the
parent's first forms come from its checkout through `--root`. `--kernel
tileregs` builds the tile body on every strip shape and face placement of
TILE_REG_SHAPES at every register cap of TILE_REG_CAPS (the most threads
a block that leaves the cap) and prints each build's registers and local
(spill) bytes, the source of `ops/transport.TILE_SHAPES`.
`--root DIR` times the package and
`chip_smoke.py` of another
checkout (an unpacked `git archive` of an earlier commit) on this file's
cases, each variant that checkout has: to compare two commits in one call,
run parent, change, change, parent.
"""

import argparse
import json
import os
import subprocess
import sys

# the checkout whose package and chip_smoke.py are timed: this one, or --root
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = HERE
if "--root" in sys.argv[:-1]:
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# (grid, scaled system) of P, Jacobi; grids of K.
P_CASES = [((60, 60), True), ((88, 88), True), ((96, 96), True), ((100, 100), True),
           ((128, 128), True), ((60, 220), True), ((192, 192), True), ((256, 256), True),
           ((120, 440), True),
           ((60, 60), False), ((88, 88), False), ((96, 96), False), ((100, 100), False),
           ((128, 128), False), ((60, 220), False), ((192, 192), False), ((120, 440), False)]
K_GRIDS = [(80, 80), (88, 88), (96, 96), (100, 100), (128, 128)]
MEMBERS = (64, 1000)
# K-cl against K-rt where K-rt once ran faster (`ops/transport.route`'s
# batch rule): these grids at these batches too.
K_CL_GRIDS, K_CL_MEMBERS = [(80, 80), (88, 88), (96, 96)], (128, 256)
# K-cl's plans timed on [24]'s first step (`--kernel kcl`): (c, strip),
# and its candidates at its grids (`cl_candidates`) at N=64 and 1000.
KCL_GRIDS = [(80, 80), (88, 88), (96, 96), (100, 100), (128, 128), (60, 220), (192, 192),
             (256, 256)]
KCL_LADDER = [(4, 4), (8, 4), (16, 4), (4, 8), (8, 8), (4, 16), (8, 16), (16, 8)]
# K's grids that no cluster takes, and their batches.
K_GM_GRIDS, K_GM_MEMBERS = [(120, 440), (171, 171)], (16, 64, 1000)
# K's grids whose route moved to K-rt (the strip body built for the grid,
# from K-rt1) and to K-gm's widened plans (from K-gm1), by the pressure
# step's preconditioner.
K_RT_ROWS = [(15, 15), (12, 9), (10, 10), (12, 12), (24, 16), (80, 80), (60, 60), (75, 75),
             (28, 28), (30, 30), (36, 36), (40, 40), (48, 48)]
# (pressure step's preconditioner, batches): K-gm keeps 16 members in
# flight at 32x1088 and 1 at the others.
K_LADDER = (4, 16, 32, 64, 128, 256, 1000)
K_WIDE_ROWS = {(32, 1088): ("mg", K_LADDER), (600, 600): ("jacobi", K_LADDER),
               (1057, 440): ("jacobi", (4, 64, 1000)), (1000, 1000): ("jacobi", (4, 64))}
# `--kernel k1`: K-rt1's and K-gm1's grids and batches. K-gm1: rows wider
# than K-gm's (5x6000 [23]'s path, 8x5000, 16x2056) and a member past its
# capacity (1090x1090); K-rt1: a row wider than a block of the strip body
# (4x1100, [23]'s path), the grids past one block's strips that it took
# before (8x3632, 150x150, 99x199) and small grids ([18]'s, [21]'s 12x12).
SWITCH = (64, 128, 256, 1000)  # the batches that place a route's switch
GM1_SWITCH = (4, 16, 32, 48, *SWITCH)  # K-gm1's tiles against one block a member
K1_ROWS = {(5, 6000): (4, *SWITCH), (8, 5000): GM1_SWITCH, (16, 2056): GM1_SWITCH,
           (1090, 1090): (4, 64), (4, 1100): (4, 64, 1000), (8, 3632): GM1_SWITCH,
           (150, 150): (64, 1000), (99, 199): (64, 1000), (12, 12): SWITCH,
           (10, 10): SWITCH, (15, 15): SWITCH, (24, 16): SWITCH, (12, 9): SWITCH,
           (28, 28): SWITCH}
# `--kernel tileregs`: (face placement, strip rows, columns a thread), "tiles"
# K-gm1's build with the edge logic, and the register caps with the most
# threads a block that leaves each (`ops/transport.reg_budget`).
TILE_REG_SHAPES = ([("registers", a, 1) for a in (1, 2, 4)]
                   + [("shared", a, c) for a, c in ((4, 1), (5, 1), (6, 1), (4, 2), (5, 2),
                                                     (4, 3), (5, 3), (6, 2), (4, 4), (8, 1),
                                                     (8, 2))]
                   + [("tiles", a, c) for a, c in ((4, 1), (5, 1), (6, 1), (8, 1), (4, 2),
                                                    (5, 2))])
TILE_REG_CAPS = {64: 1024, 72: 896, 80: 768, 96: 640, 128: 512}
# P's cases whose route takes the batch (`ops/pressure.DIST_BATCH_MAX`,
# `GM_BATCH_MAX`), timed at these batches too, between the two of MEMBERS
# (120x440 also at [23]'s N=16).
LADDER = {((100, 100), True): (128, 192, 256, 512), ((120, 440), True): (16, 96, 128, 192),
          ((120, 440), False): (16, 96, 128, 192, 256), ((60, 220), True): (128, 256, 512)}
# P-gm1's choices (`--kernel gm1`): (grid, batch), on [23]'s kind of inputs
# (the scaled system, Jacobi): its routes at N=1000, past and within one
# wave of 132 members (one block an SM) at 120x440 and 100x100, and [23]'s
# 32x1088 path. Fixed work: 64 iterations in windows of 8, so 72 V-cycles a
# member.
GM1_CASES = [((100, 100), 1000), ((60, 220), 1000), ((120, 440), 1000), ((120, 440), 264),
             ((120, 440), 128), ((100, 100), 128), ((100, 100), 64), ((32, 1088), 4)]
GM1_FIXED = dict(tol=0.0, maxiter=64, restart_every=8, patience_iters=100_000)
# The plan of a whole block timed beside the route's (`ops/pressure.gm1_plan`'s
# shared bytes at most, ring held back and least stage): 227 KB, two stages
# of at least 64 KB.
GM1_WHOLE_BLOCK = (232_448, 131_072, 65_536)


def p_row(Nx, Ny, unit, n_members, reps, variants=None):
    """One row of P at a grid, system and batch: each variant (by default
    `p_variants`) timed."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field
    from historymatching_tpu_torch.ops import _build, pressure
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda
    from historymatching_tpu_torch.parallel.runner import set_perm

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    m = cs.grid_model(torch, Nx, Ny)
    pre = ht.sample_prior_perm(gen, m, n_members, r=0.8)
    qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
    args = cs.p_system(set_perm(m, pre if unit else cs.MILD * pre), qf, unit)
    solve = {k: cs.BASE[k] for k in cs.SOLVE_KEYS}
    plan, gplan = pressure.cl_plan(Nx, Ny, unit), pressure.gm_plan(Nx, Ny, unit)
    row = dict(kernel="P", grid=f"{Nx}x{Ny}", N=n_members, unit_diag=unit,
               route=pressure.route(Nx, Ny, unit, n_members), plan=plan, gm_plan=gplan,
               clusters=plan and _build.kernel_info(pressure.kernel_name("jacobi", unit, "cl"),
                                                    Nx, Ny)["max_active_clusters"],
               gm_groups=gplan and _build.kernel_info(pressure.kernel_name("jacobi", unit, "gm"),
                                                      Nx, Ny)["groups_resident"])
    for tag, kw in (variants or p_variants(Nx, Ny, unit)).items():
        _, it, rel = pressure_solve_cuda(*args, **solve, unit_diag=unit, **kw)
        row[f"{tag}_ms"] = cs.cuda_ms(lambda: pressure_solve_cuda(
            *args, **solve, unit_diag=unit, **kw), reps)
        row[f"{tag}_iters"] = (int(it.median()), int(it.max()))
        row[f"{tag}_accepted"] = int((rel <= 5e-2).sum())
        if "plan" in kw:
            row.update({f"{tag}_{k}": v for k, v in cl_figures(
                args, unit, kw["plan"], row[f"{tag}_ms"], it).items()})
        row[f"{tag}_bound_ms"] = cs.pressure_bound_ms(
            args[0], args[1], it,
            fine_flops=cs.P_FLOPS_FINE + (0 if unit else cs.P_FLOPS_DIAG))[0]
        if kw.get("force") == "gm1" or kw.get("plan", (0, ""))[1] == "device":
            # the inverse read every V-cycle
            row[f"{tag}_inverse_floor_ms"] = cs.inverse_floor_ms(args[1], it)
            row[f"{tag}_floor_share"] = row[f"{tag}_inverse_floor_ms"] / row[f"{tag}_ms"]
        if kw.get("force") == "gm1":
            row["gm1_plan"] = cs.gm1_said(Nx, Ny, unit)[0]
    return row


def probes(plans):
    """`_build.prebuild`'s P-cl probe builds for `plans` (Nx, Ny, c, place),
    where the checkout has them."""
    return {"cl_probes": plans} if hasattr(cs, "cl_iteration_barriers") else {}


def cl_figures(args, unit, plan, ms, it):
    """P-cl's clusters resident on the card for `plan`, its cluster barriers
    an iteration on P's arguments `args` (where the checkout has the probe
    build) and an estimate of an iteration's time in microseconds: the
    launch's `ms` x clusters resident / members / mean iterations (`it`)."""
    from historymatching_tpu_torch.ops import _build, pressure

    Nx, Ny = args[2].shape[1:]
    resident = _build.kernel_info(pressure.kernel_name("jacobi", unit, "cl"), Nx, Ny,
                                  plan)["max_active_clusters"]
    out = dict(resident=resident, iteration_us_estimate=1e3 * ms * min(resident, len(it))
               / len(it) / float(it.float().mean()))
    if hasattr(cs, "cl_iteration_barriers"):
        out["cluster_barriers"] = cs.cl_iteration_barriers(args, unit, plan)
    return out


def cl_row(reps):
    """P-cl on [24]'s first step (`chip_smoke.large_case_kernels`' system):
    the bench case (seed 1) at 128x128, N=1000, s = 0, the first pass's
    settings; the route's plan, held to the plain version after one window
    within `chip_smoke.P_TOL`, then timed, with its iterations, members
    accepted, bound, `cl_figures` and a hash of p. Then P's device time a
    step on the route (`step_ms`, with K's and the wall's): 10 steps of the
    first pass from s = 0, profiled as `chip_smoke.py` [24] profiles its
    loose-pass steps."""
    import hashlib

    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch import parity
    from historymatching_tpu_torch.models.ressim import _source_field
    from historymatching_tpu_torch.ops import _build, pressure
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda, pressure_solve_torch
    from historymatching_tpu_torch.parallel.runner import set_perm

    Nx, Ny = cs.BIG
    case = parity.build_case(cs.SEED, cs.N, Nx, Ny, cs.NTIME)
    model, prior = case["model"], case["prior"]
    qf = _source_field(model, model.inj_rates[:, 0], model.prd_rates[:, 0])
    args = cs.p_system(set_perm(model, prior), qf, True)
    first = dict(cs.BASE, **cs.SCHED[0])
    kw1 = {k: first[k] for k in cs.SOLVE_KEYS}
    plan = pressure.cl_plan(Nx, Ny)
    _build.prebuild(cl_plans=[(Nx, Ny, *plan)], **probes([(Nx, Ny, *plan)]))
    row = dict(kernel="P-cl", case="[24] first step", grid=f"{Nx}x{Ny}", N=cs.N, root=ROOT,
               plan=plan)
    solve = lambda kw: pressure_solve_cuda(*args, **kw, plan=plan)  # noqa: E731
    err = cs.rel_err(solve(cs.WINDOW4)[0], pressure_solve_torch(*args, **cs.WINDOW4)[0])
    assert err <= cs.P_TOL, err
    p, it, rel = solve(kw1)
    ms = cs.cuda_ms(lambda: solve(kw1), reps)
    row.update(cl_ms=ms, cl_window_rel=err,
               cl_iters=(int(it.median()), float(it.float().mean()), int(it.max())),
               cl_accepted=int((rel <= 5e-2).sum()),
               cl_bound_ms=cs.pressure_bound_ms(args[0], args[1], it)[0],
               cl_p_hash=hashlib.sha1(p.cpu().numpy().tobytes()).hexdigest()[:16])
    row.update({f"cl_{k}": v for k, v in cl_figures(args, True, plan, ms, it).items()})
    steps = dict(dt=cs.DT, nTime=10, keep_wsats=False, **first)
    mm, s0 = set_perm(model, prior), torch.zeros(model.Nxy, device=prior.device)
    ht.simulate(mm, s0, **dict(steps, nTime=1))
    stages, busy, wall_ms, _ = cs.profile_steps(lambda: ht.simulate(mm, s0, **steps), 10)
    row.update(step_ms=stages, step_busy_ms=busy, step_wall_ms=wall_ms)
    return row


def kcl_figures(Nx, Ny, ms, nsub, plan=None):
    """K-cl's resources on `plan` (the route's where not given) and an
    estimate of a substep's time in microseconds (`chip_smoke.iteration_us`:
    the launch's `ms` x clusters resident / members / mean substeps)."""
    from historymatching_tpu_torch.ops import _build

    info = _build.kernel_info("transport_upwind_cl", Nx, Ny, *([plan] if plan else []))
    return dict(info, substep_us_estimate=cs.iteration_us(ms, info["max_active_clusters"], nsub))


def kcl_row(reps):
    """K-cl on [24]'s first step: the bench case (seed 1) at 128x128,
    N=1000, s = 0, the substeps of the first pass's pressure step; the
    route's plan and, where the checkout has K-cl's plans, KCL_LADDER, each
    held to the plain version bit for bit and timed, with `kcl_figures` and
    a hash of s."""
    import hashlib

    import torch

    from historymatching_tpu_torch import parity
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, transport
    from historymatching_tpu_torch.ops.transport import (
        transport_substeps_cuda,
        transport_substeps_torch,
    )
    from historymatching_tpu_torch.parallel.runner import set_perm

    Nx, Ny = cs.BIG
    case = parity.build_case(cs.SEED, cs.N, Nx, Ny, cs.NTIME)
    model, prior = case["model"], case["prior"]
    mm = set_perm(model, prior)
    qf = _source_field(model, model.inj_rates[:, 0], model.prd_rates[:, 0])
    first = dict(cs.BASE, **cs.SCHED[0])
    s0 = torch.zeros(prior.shape[0], Nx, Ny, device=prior.device)
    _, Fx, Fy, _, _, _ = pressure_step(mm, s0, qf, torch.zeros_like(s0), tol_accept=5e-2, **first)
    Fx, Fy = Fx.contiguous(), Fy.contiguous()
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, cs.DT)
    t_args = (s0, Fx, Fy, qf[None].contiguous(), dtspv, nsub, cs.fluid_of(model))
    plans = [None]
    if hasattr(transport, "cl_plans"):
        plans += [transport.ClPlan(*p) for p in KCL_LADDER]
        _build.prebuild(kcl_plans=[(Nx, Ny, p or transport.cl_plan(Nx, Ny)) for p in plans])
    ref = transport_substeps_torch(*t_args)
    row = dict(kernel="K-cl", case="[24] first step", grid=f"{Nx}x{Ny}", N=cs.N, root=ROOT,
               substeps=(int(nsub.median()), float(nsub.float().mean()), int(nsub.max())),
               bound_ms=cs.transport_bound_ms(s0, Fx, Fy, t_args[3], nsub)[0], variants=[])
    for plan in plans:
        run = lambda: transport_substeps_cuda(  # noqa: E731
            *t_args, force="cl", **({"plan": plan} if plan else {}))
        out = run()
        assert torch.equal(out, ref), (plan, float((out - ref).abs().max()))
        ms = cs.cuda_ms(run, reps)
        fig = dict(plan=plan or "route", ms=ms,
                   s_hash=hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16],
                   **kcl_figures(Nx, Ny, ms, nsub, plan))
        row["variants"].append(fig)
        print(json.dumps(fig), flush=True)
    return row


def gm1_row(Nx, Ny, n_members, reps):
    """P-gm1 at a grid and batch: at fixed work (GM1_FIXED) its route's plan
    ("plan") and a whole block's (GM1_WHOLE_BLOCK, "block"), each with its
    inverse read through the ring ("ring") or by plain loads ("loads"),
    every p equal bit for bit; then the route's plan at the bench settings,
    with its iterations and the inverse's floor. A checkout without these
    choices (`--root`) times its P-gm1 as it runs ("route")."""
    import inspect

    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field
    from historymatching_tpu_torch.ops import pressure
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda
    from historymatching_tpu_torch.parallel.runner import set_perm

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    m = cs.grid_model(torch, Nx, Ny)
    pre = ht.sample_prior_perm(gen, m, n_members, r=0.8)
    qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
    args = cs.p_system(set_perm(m, pre), qf, True)
    row = dict(kernel="P-gm1", grid=f"{Nx}x{Ny}", N=n_members, root=ROOT)
    variants = {"route": dict(force="gm1")}
    if "inverse_loads" in inspect.signature(pressure_solve_cuda).parameters:
        plans = dict(plan=pressure.gm1_plan(Nx, Ny),
                     block=pressure.gm1_plan(Nx, Ny, True, *GM1_WHOLE_BLOCK))
        variants = {f"{tag}_{'loads' if ld else 'ring'}": dict(plan=plan, inverse_loads=ld)
                    for tag, plan in plans.items() for ld in (False, True)}
        row["plans"] = {tag: cs.gm1_said(Nx, Ny, True, plan)[0] for tag, plan in plans.items()}
    first = None
    for tag, kw in variants.items():
        solve = lambda: pressure_solve_cuda(*args, **GM1_FIXED, **kw)  # noqa: E731
        p = solve()[0]
        first = p if first is None else first
        assert torch.equal(p, first), (Nx, Ny, n_members, tag)
        row[f"{tag}_ms"] = cs.cuda_ms(solve, reps)
    bench = {k: cs.BASE[k] for k in cs.SOLVE_KEYS}
    solve = lambda: pressure_solve_cuda(*args, **bench, force="gm1")  # noqa: E731
    _, it, _ = solve()
    row["bench_ms"] = cs.cuda_ms(solve, reps)
    row["bench_iters"] = (int(it.median()), int(it.max()))
    if len(variants) > 1:
        row["bench_inverse_floor_ms"] = cs.inverse_floor_ms(args[1], it)
        row["bench_floor_share"] = row["bench_inverse_floor_ms"] / row["bench_ms"]
    return row


def device_ms(fn, reps):
    """Mean milliseconds of `fn` on the card alone over `reps` runs: the
    launches are queued behind a ~0.1 s spin of the card, so that the host
    has queued them all before the first starts, and the events time the
    card's work only, not the host's launch of each (which is longer than a
    small grid's launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tile_regs_rows():
    """`--kernel tileregs`: each tile body build of TILE_REG_SHAPES at each
    cap of TILE_REG_CAPS, built at once: {library key: [registers, local
    bytes]} as the CUDA runtime reports them."""
    import ctypes

    from historymatching_tpu_torch.ops import _build

    builds = [(faces, a, c, t) for faces, a, c in TILE_REG_SHAPES for t in TILE_REG_CAPS.values()]
    spec = lambda f, a, c, t: _build._tile_spec(  # noqa: E731
        a, c, "shared" if f == "tiles" else f, f == "tiles", t)
    _build._load([spec(*b) for b in builds])
    rows = {}
    for faces, a, c, t in builds:
        key = spec(faces, a, c, t)[0]
        out = (ctypes.c_int * 7)()
        lib = _build._get(_build._tile_spec, a, c, "shared" if faces == "tiles" else faces,
                          faces == "tiles", t)
        _build.check(lib.hm_transport_tile_info(a, c, 1, 1, 32, out), key)  # any launch shape
        rows[key] = [out[0], out[1]]
    return rows


def k1_row(Nx, Ny, n_members, reps):
    """K-rt1 and K-gm1 at a grid and batch on the first step's substeps: the
    route's body, K-rt1 where it takes the grid (its tiles fit one block;
    here, where `rt1_plan` gives a plan), K-gm1 where the route is another,
    on a grid of up to RT1_CELLS cells K-rt, and where the route is K-gm1
    its tiles ("gm1_tiles") and its device-memory body on one block a
    member ("gm1_block") where its tiles take the grid, past them that
    body on the card's blocks spread evenly over the batch ("gm1_spread"),
    each where it is not the route's plan; each timed with a hash
    of s and held to the first bit for bit; on grids of up to 4,400 cells
    each also timed on the card alone (`device_ms`, 20 runs)."""
    import hashlib

    import torch

    from historymatching_tpu_torch.ops import _build, transport
    from historymatching_tpu_torch.ops.transport import transport_substeps_cuda

    t_args = k_inputs(Nx, Ny, n_members, "jacobi")
    s0, Fx, Fy, _, _, nsub, _ = t_args
    rt = transport.route(Nx, Ny, n_members)
    new = hasattr(transport, "GM1Device")
    rt1 = (transport.rt1_plan(Nx, Ny) if hasattr(transport, "rt1_plan")
           else transport.smem_bytes(Nx, Ny) <= _build.SMEM_LIMIT)
    dev = {}
    if new and rt == "gm1":  # K-gm1's plans beside its route's
        tiles = transport.gm1_plan(Nx, Ny)
        resident = _build.gm1_resident(s0.device)
        plans = ({"gm1_tiles": tiles, "gm1_block": transport.GM1Device(1)} if tiles else
                 {"gm1_spread": transport.GM1Device(resident // min(n_members, resident))})
        dev = {k: dict(force="gm1", plan=p) for k, p in plans.items()
               if p != transport._plan("gm1", Nx, Ny, n_members, None)}
    runs = {"route": {}, **({"rt1": dict(force="rt1")} if rt1 and rt != "rt1" else {}),
            **({"gm1": dict(force="gm1")} if rt != "gm1" else {}),
            **({"rt": dict(force="rt")} if Nx * Ny <= transport.RT1_CELLS and rt != "rt"
               else {}), **dev}
    row = dict(kernel="K1", grid=f"{Nx}x{Ny}", N=n_members, root=ROOT, route=rt,
               substeps=(int(nsub.median()), float(nsub.float().mean()), int(nsub.max())),
               bound_ms=cs.transport_bound_ms(s0, Fx, Fy, t_args[3], nsub)[0], variants={})
    if new:
        row["plans"] = {"rt1": transport.rt1_plan(Nx, Ny), "gm1": transport.gm1_plan(Nx, Ny),
                        "route": transport._plan(rt, Nx, Ny, n_members, None)}
    first = None
    for tag, kw in runs.items():
        run = lambda: transport_substeps_cuda(*t_args, **kw)  # noqa: E731
        out = run()
        first = out if first is None else first
        assert torch.equal(out, first), (Nx, Ny, n_members, tag)
        row["variants"][tag] = dict(
            ms=cs.cuda_ms(run, reps if Nx * Ny < 10**6 else 2),
            s_hash=hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16])
        if Nx * Ny <= 4400:
            row["variants"][tag]["device_ms"] = device_ms(run, 20)
    return row


def p_variants(Nx, Ny, unit, extra=True):
    """P's variants at a grid: P-cl on the grid's plan ("cl", where a
    cluster holds it), P-gm ("gm", where `gm_plan` cuts it) and P-gm1
    ("gm1"); with `extra`, where the plan distributes the inverse, also
    the in-place plan ("cl_device") and the distributed plan on 16 ranks
    ("cl_16")."""
    from historymatching_tpu_torch.ops import pressure

    plan = pressure.cl_plan(Nx, Ny, unit)
    variants = {"cl": dict(plan=plan)} if plan else {}
    if pressure.gm_plan(Nx, Ny, unit):
        variants["gm"] = dict(force="gm")
    variants["gm1"] = dict(force="gm1")
    if extra and plan and plan[1] == "distributed":
        if pressure.cl_plan(Nx, Ny, unit, "device"):
            variants["cl_device"] = dict(plan=pressure.cl_plan(Nx, Ny, unit, "device"))
        if plan[0] < 16:
            variants["cl_16"] = dict(plan=(16, "distributed"))
    return variants


def k_inputs(Nx, Ny, n_members, precond="mg"):
    """K's arguments on the substeps of the first step at a grid and batch
    (`chip_smoke.py` [23]'s kind of inputs: the flagship geometry, a prior
    drawn from seed 1 + 23, s = 0), its pressure step with `precond`."""
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.parallel.runner import set_perm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
    m = cs.grid_model(torch, Nx, Ny)
    mm = set_perm(m, ht.sample_prior_perm(gen, m, n_members, r=0.8))
    qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
    s0 = torch.zeros(n_members, Nx, Ny, device=dev)
    solve = {k: cs.BASE[k] for k in cs.SOLVE_KEYS}
    _, Fx, Fy, _, _, _ = pressure_step(mm, s0, qf, torch.zeros_like(s0), tol_accept=5e-2,
                                       precond=precond, **solve)
    Fx, Fy = Fx.contiguous(), Fy.contiguous()
    nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, cs.DT)
    return s0, Fx, Fy, qf[None].contiguous(), dtspv, nsub, cs.fluid_of(m)


def cl_candidates(Nx, Ny):
    """K-cl's plans timed at a grid by `--kernel kcl`: the route's, strips
    of MIN_STRIP rows on the fewest ranks (the parent's layout), one strip
    a band on twice the route's ranks, every plan whose strips divide the
    band and that puts the most members on an SM (its ranks an SM over its
    ranks a member), and for each cluster the plan of the fewest strips a
    band."""
    from historymatching_tpu_torch.ops import transport

    regs, route = transport.cl_plans(Nx, Ny), transport.cl_plan(Nx, Ny)
    four = [p for p in regs if p.strip == transport.MIN_STRIP]
    more = [p for p in regs if p.c == 2 * route.c and transport.cl_strips(Nx, p) == 1]
    most = max(transport.cl_ranks(Nx, Ny, p) / p.c for p in regs)
    tall = [min((p for p in regs if p.c == c), key=lambda p: (transport.cl_strips(Nx, p),
                                                               p.strip))
            for c in sorted({p.c for p in regs})]
    return list(dict.fromkeys(
        [route, *four[:1], *more[:1], *tall]
        + [p for p in regs if transport.cl_ranks(Nx, Ny, p) / p.c == most
           and (Nx // p.c) % p.strip == 0]))


def kcl_grid_row(Nx, Ny, n_members, reps):
    """K-cl's `cl_candidates` at a grid and batch (`k_inputs`), each held to
    the route's plan bit for bit and timed, with `kcl_figures`."""
    import torch

    from historymatching_tpu_torch.ops.transport import transport_substeps_cuda

    t_args = k_inputs(Nx, Ny, n_members)
    nsub = t_args[5]
    row = dict(kernel="K-cl", grid=f"{Nx}x{Ny}", N=n_members, substeps=int(nsub.median()),
               bound_ms=cs.transport_bound_ms(*t_args[:4], nsub)[0], variants=[])
    first = None
    for plan in cl_candidates(Nx, Ny):
        run = lambda: transport_substeps_cuda(*t_args, force="cl", plan=plan)  # noqa: E731
        out = run()
        first = out if first is None else first
        assert torch.equal(out, first), (Nx, Ny, plan)
        ms = cs.cuda_ms(run, reps)
        info = kcl_figures(Nx, Ny, ms, nsub, plan)
        row["variants"].append(dict(plan=plan, ms=ms, **{k: info[k] for k in (
            "registers", "local_bytes", "threads", "blocks_per_sm", "max_active_clusters",
            "substep_us_estimate")}))
    return row


def k_row(Nx, Ny, n_members, reps, forces=None, precond="mg"):
    """One row of K at a grid and batch, on the substeps of the first step
    (its pressure step with `precond`): each variant of `forces`, by
    default each that takes the grid (K-cl, K-rt1 where one block holds
    the grid (`rt1_plan`; in a checkout without it, where its tiles fit),
    K-rt where a strip plan fits, K-gm where `gm_plan` splits it, and
    K-gm1 where no cluster does), timed, each held to the first bit for
    bit."""
    import torch

    from historymatching_tpu_torch.ops import _build, transport
    from historymatching_tpu_torch.ops.transport import transport_substeps_cuda

    t_args = k_inputs(Nx, Ny, n_members, precond)
    s0, Fx, Fy, _, _, nsub, _ = t_args
    plan = transport.gm_plan(Nx, Ny)
    cl_plan = getattr(transport, "cl_plan", getattr(transport, "cl_shape", None))(Nx, Ny)
    row = dict(kernel="K", grid=f"{Nx}x{Ny}", N=n_members,
               route=transport.route(Nx, Ny, n_members),
               cl_plan=cl_plan, rt_plan=transport.rt_plan(Nx, Ny),
               gm_plan=plan and (len(plan[0]), *plan[1:]), substeps=int(nsub.median()),
               precond=precond, bound_ms=cs.transport_bound_ms(s0, Fx, Fy, t_args[3], nsub)[0])
    fits = transport.smem_bytes(Nx, Ny) <= _build.SMEM_LIMIT
    rt1 = transport.rt1_plan(Nx, Ny) if hasattr(transport, "rt1_plan") else fits
    forces = forces or ((["cl"] if cl_plan else ["gm1"])
                        + (["rt1"] if rt1 else [])
                        + (["rt"] if fits and transport.rt_plan(Nx, Ny) else [])
                        + (["gm"] if plan else []))
    first = None
    for force in forces:
        out = transport_substeps_cuda(*t_args, force=force)
        first = out if first is None else first
        assert torch.equal(out, first), (Nx, Ny, force)
        row[f"{force}_ms"] = cs.cuda_ms(
            lambda: transport_substeps_cuda(*t_args, force=force), reps)
    if "cl" in forces:
        row.update({f"cl_{k}": v for k, v in kcl_figures(Nx, Ny, row["cl_ms"], nsub).items()})
    if plan and "gm" in forces:
        gm = _build.kernel_info("transport_upwind_gm", Nx, Ny)
        row.update(gm_bands=gm["bands"], gm_groups_resident=gm["groups_resident"],
                   gm_registers=gm["registers"], gm_blocks_per_sm=gm["blocks_per_sm"])
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--kernel", choices=("P", "K", "gm1", "cl", "kcl", "k1", "tileregs"),
                    default=None,
                    help="time one kernel's routes only (default: P's and K's), or P-gm1's "
                         "choices, or P-cl or K-cl on [24]'s first step, or K-rt1 and K-gm1, "
                         "or read the tile body's registers")
    ap.add_argument("--grids", default="",
                    help="comma-separated NXxNY: time the rows of these grids only")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package and chip_smoke.py to time")
    opts = ap.parse_args(argv)
    keep = {tuple(map(int, g.split("x"))) for g in opts.grids.split(",") if g}
    do_p, do_k = opts.kernel in (None, "P"), opts.kernel in (None, "K")
    import torch

    from historymatching_tpu_torch.ops import _build, transport

    if not torch.cuda.is_available():
        raise RuntimeError("bench_routes.py runs on a CUDA device only")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rows = []
    if opts.kernel == "cl":
        rows.append(cl_row(opts.reps))
        print(json.dumps(rows[-1]), flush=True)
    if opts.kernel == "kcl":
        rows.append(kcl_row(opts.reps))
        grids = [g for g in KCL_GRIDS if not keep or g in keep]
        if grids and hasattr(transport, "cl_plans"):
            _build.prebuild(kcl_plans=[(*g, p) for g in grids for p in cl_candidates(*g)])
            for n_members in MEMBERS:
                for Nx, Ny in grids:
                    rows.append(kcl_grid_row(Nx, Ny, n_members, opts.reps))
                    print(json.dumps(rows[-1]), flush=True)
    if opts.kernel == "tileregs":
        rows.append(dict(kernel="tileregs", builds=tile_regs_rows()))
        print(json.dumps(rows[-1]), flush=True)
    if opts.kernel == "k1":
        grids = [g for g in K1_ROWS if not keep or g in keep]
        _build.prebuild(k_grids=grids)
        if hasattr(transport, "rt1_plan"):
            _build._load([sp for g in grids for sp in _build._kt_specs(*g)])
        for Nx, Ny in grids:
            for n_members in K1_ROWS[(Nx, Ny)]:
                rows.append(k1_row(Nx, Ny, n_members, opts.reps))
                print(json.dumps(rows[-1]), flush=True)
    if opts.kernel == "gm1":
        for (Nx, Ny), n_members in GM1_CASES:
            if not keep or (Nx, Ny) in keep:
                rows.append(gm1_row(Nx, Ny, n_members, opts.reps))
                print(json.dumps(rows[-1]), flush=True)
    kept = lambda gs: [g for g in gs if not keep or g in keep]  # noqa: E731
    p_grids = kept(g for g, _ in P_CASES) if do_p else []
    k_grids = kept(K_GRIDS + K_RT_ROWS + list(K_WIDE_ROWS)) if do_k else []
    plans = {(*g, *kw["plan"]) for g, unit in P_CASES if g in p_grids
             for kw in p_variants(*g, unit).values() if "plan" in kw}
    if p_grids or k_grids:
        _build.prebuild(cl_grids=sorted(set(p_grids) | set(k_grids)), cl_plans=plans,
                        gm_grids=p_grids, k_grids=k_grids, **probes(plans))

    def emit(row_fn, Nx, Ny, *args):
        if keep and (Nx, Ny) not in keep:
            return
        row = row_fn(Nx, Ny, *args)
        rows.append(row)
        print(json.dumps(row), flush=True)

    for n_members in MEMBERS:
        for (Nx, Ny), unit in P_CASES if do_p else ():
            emit(p_row, Nx, Ny, unit, n_members, opts.reps)
        for Nx, Ny in K_GRIDS if do_k else ():
            emit(k_row, Nx, Ny, n_members, opts.reps)
    for n_members in K_CL_MEMBERS if do_k else ():
        for Nx, Ny in K_CL_GRIDS:
            emit(k_row, Nx, Ny, n_members, opts.reps, ["cl", "rt"])
    for n_members in K_GM_MEMBERS if do_k else ():
        for Nx, Ny in K_GM_GRIDS:
            emit(k_row, Nx, Ny, n_members, opts.reps)
    for n_members in MEMBERS if do_k else ():
        for Nx, Ny in K_RT_ROWS:
            emit(k_row, Nx, Ny, n_members, opts.reps,
                 ["rt", "rt1"] + (["cl"] if transport.route(Nx, Ny) == "cl" else []))
    for (Nx, Ny), (precond, batches) in K_WIDE_ROWS.items() if do_k else ():
        for n_members in batches:
            emit(k_row, Nx, Ny, n_members, opts.reps, ["gm", "gm1"], precond)
    for ((Nx, Ny), unit), batches in LADDER.items() if do_p else ():
        for n_members in batches:
            emit(p_row, Nx, Ny, unit, n_members, opts.reps, p_variants(Nx, Ny, unit, False))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
