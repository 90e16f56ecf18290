#!/usr/bin/env python3
"""Time each route of kernels P and K against the others on one NVIDIA GPU.

    python3 bench_routes.py [--out FILE]

The evidence behind `ops/pressure.route` and `ops/transport.route` past one
block: P-cl (a thread-block cluster a member) against P-gm (device memory),
K-cl against K's runtime-grid variant, on `chip_smoke.py` [23]'s grids and
its kind of inputs (the flagship geometry, a prior drawn for each grid from
seed 1 + 23, the unscaled system on fields of mild contrast), at [23]'s
N=64 and at the bench case's N=1000.
P runs one launch at the bench settings (tol 2e-4, maxiter 768, patience
256) and K the substeps of the first step. Each line gives both routes'
milliseconds a launch (CUDA events, the mean of `--reps` after a warm-up)
and P's iteration median and maximum, since a launch lasts as long as its
slowest member. The card's name and power limit come first; `--out`
writes the rows as JSON. Raises without CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

# (grid, scaled system) of P, Jacobi; grids of K. The unscaled system at
# 60x220 has no cluster and is left out.
P_CASES = [((60, 60), True), ((88, 88), True), ((96, 96), True), ((100, 100), True),
           ((128, 128), True), ((60, 220), True),
           ((60, 60), False), ((88, 88), False), ((96, 96), False), ((128, 128), False),
           ((192, 192), False)]
K_GRIDS = [(80, 80), (88, 88), (96, 96), (100, 100), (128, 128)]
MEMBERS = (64, 1000)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    opts = ap.parse_args(argv)
    import torch

    import historymatching_tpu_torch as ht
    from historymatching_tpu_torch.models.ressim import _source_field, cfl_substeps, pressure_step
    from historymatching_tpu_torch.ops import _build, pressure, transport
    from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda
    from historymatching_tpu_torch.ops.transport import transport_substeps_cuda
    from historymatching_tpu_torch.parallel.runner import set_perm

    if not torch.cuda.is_available():
        raise RuntimeError("bench_routes.py runs on a CUDA device only")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    grids = sorted({g for g, _ in P_CASES} | set(K_GRIDS))
    _build.prebuild(cl_grids=grids)
    solve = {k: cs.BASE[k] for k in cs.SOLVE_KEYS}
    rows = []
    for n_members in MEMBERS:
        for (Nx, Ny), unit in P_CASES:
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
            m = cs.grid_model(torch, Nx, Ny)
            pre = ht.sample_prior_perm(gen, m, n_members, r=0.8)
            qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
            args = cs.p_system(set_perm(m, pre if unit else cs.MILD * pre), qf, unit)
            row = dict(kernel="P", grid=f"{Nx}x{Ny}", N=n_members, unit_diag=unit,
                       route=pressure.route(Nx, Ny, unit), plan=pressure.cl_plan(Nx, Ny, unit))
            for force in ("cl", "gm"):
                _, it, _ = pressure_solve_cuda(*args, **solve, unit_diag=unit, force=force)
                row[f"{force}_ms"] = cs.cuda_ms(lambda: pressure_solve_cuda(
                    *args, **solve, unit_diag=unit, force=force), opts.reps)
                row[f"{force}_iters"] = (int(it.median()), int(it.max()))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del args
        for Nx, Ny in K_GRIDS:
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
            m = cs.grid_model(torch, Nx, Ny)
            mm = set_perm(m, ht.sample_prior_perm(gen, m, n_members, r=0.8))
            qf = _source_field(m, m.inj_rates[:, 0], m.prd_rates[:, 0])
            s0 = torch.zeros(n_members, Nx, Ny, device=dev)
            _, Fx, Fy, _, _, _ = pressure_step(mm, s0, qf, torch.zeros_like(s0), tol_accept=5e-2,
                                               **solve)
            Fx, Fy = Fx.contiguous(), Fy.contiguous()
            nsub, dtspv = cfl_substeps(mm, Fx, Fy, qf, cs.DT)
            t_args = (s0, Fx, Fy, qf[None].contiguous(), dtspv, nsub, cs.fluid_of(m))
            row = dict(kernel="K", grid=f"{Nx}x{Ny}", N=n_members, route=transport.route(Nx, Ny),
                       shape=transport.cl_shape(Nx, Ny), substeps=int(nsub.median()))
            for force in ("cl", "rt"):
                row[f"{force}_ms"] = cs.cuda_ms(
                    lambda: transport_substeps_cuda(*t_args, force=force), opts.reps)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
