"""Production-optimisation (EnOpt) tutorial workflow on the PyTorch/CUDA port.

The counterpart of the JAX package's `examples/optimise.py`, case for case:
the NPV objective with an exhaustive search over injector positions,
injector placement (x, y), x only, two injectors through the coordinate
transform, one rate, four rates against a grid sweep, time-dependent
rates, robust optimisation (StoSAG, Paired, Mean-model) under uncertain
permeability with its per-member verification, the Pareto sweep over the
injection price, and the toy-objective GD trial table. Objectives are
batched: one `npv_value` call simulates every control of a batch at once
(an ensemble gradient's perturbations, a line search's trials, a
landscape). Draws come from a `torch.Generator` seeded by `--seed`, so
the numbers differ from the JAX example's. It runs on the card unless
`--cpu` is given.

With `--plot`, the robust case's NPV densities go to `--outdir` (needs
matplotlib and scipy, which the card's host may lack).

Run:  python -m historymatching_tpu_torch.examples.optimise [--small] [--cpu] [--plot]
          [--cases inj_xy,rate,...]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import historymatching_tpu_torch as ht
from historymatching_tpu_torch.opt.transforms import (
    balance_rates,
    coordinate_transform,
    equalize,
    rate_transform,
)
from historymatching_tpu_torch.utils import mesh2list, pCircle

CASES = "inj_xy,x_only,two_inj,rate,multi_rate,time_rates,robust,pareto,toys"


def main(argv=None):
    """Run the chosen cases; returns their headline numbers by case."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--plot", action="store_true", help="write figures to --outdir")
    ap.add_argument("--outdir", default="figs")
    args = ap.parse_args(argv)
    cases = set(args.cases.split(","))
    dev = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
    uniform = lambda n: torch.rand(n, generator=gen, dtype=dtype, device=dev)  # noqa: E731
    out = {}

    # ---- Base model (reference Optimise.py:64-89) ---------------------------
    Lx, Ly = 2.0, 1.0
    Nx = Ny = 12 if args.small else 20
    rate0 = 1.5
    near01 = np.array([0.12, 0.87])
    xy_4corners = [[x, y] for y in Ly * near01 for x in Lx * near01]
    base = ht.ResSim.build(Nx=Nx, Ny=Ny, Lx=Lx, Ly=Ly, name="Base model", dtype=dtype,
                           device=dev)
    perm_field = ht.sample_prior_perm(gen, base, 1, r=0.8, dtype=dtype)[0]
    K = (0.1 + torch.exp(5 * perm_field)).reshape(base.shape)
    base = base.replace(K=torch.stack([K, K]), inj_xy=[[Lx / 2, Ly / 2]], prd_xy=xy_4corners,
                        inj_rates=rate0 * np.ones((1, 1)),
                        prd_rates=rate0 * np.ones((4, 1)) / 4).validate()

    nTime = 20 if args.small else 40
    cfg = ht.NPVConfig(dt=0.025, nTime=nTime, rate0=rate0)
    nIter = 10 if args.small else 30
    box = t([Lx, Ly])

    def report(name, objs, extra=""):
        objs = objs.tolist()
        print(f"[{name}] NPV {objs[0]:.3f} -> {objs[-1]:.3f} in {len(objs) - 1} steps {extra}")

    # ---- Case: injector (x, y) + exhaustive search (reference :431-468) -----
    if "inj_xy" in cases:
        def obj(U):
            return ht.npv_value(base, cfg, inj_xy=U.reshape(-1, 1, 2))

        t0 = time.perf_counter()
        pts = mesh2list(*base.mesh, device=dev).to(dtype)
        npvs = obj(pts)
        amax = int(torch.argmax(npvs))
        xy_best = base.ind2xy(amax).numpy()
        print(f"[inj_xy] exhaustive optimum {float(npvs[amax]):.4f} at "
              f"(x={xy_best[0]:.2f}, y={xy_best[1]:.2f}) [{time.perf_counter() - t0:.1f}s]")
        u0 = uniform(2) * box
        path, objs, info = ht.GD(obj, u0, nabla=ht.EnGrad(chol=0.1), nIter=nIter, generator=gen)
        report("inj_xy EnOpt", objs,
               f"final u={path[-1].cpu().numpy().round(2)} ({info['cause']})")
        out["inj_xy"] = dict(optimum=float(npvs[amax]), at=(float(xy_best[0]), float(xy_best[1])),
                             enopt=float(objs[-1]))

    # ---- Case: x-coordinate only (reference :495-527) ------------------------
    if "x_only" in cases:
        y_fix = Ly / 2

        def obj_x(X):
            xy = torch.stack([X[:, 0], torch.full_like(X[:, 0], y_fix)], -1)
            return ht.npv_value(base, cfg, inj_xy=xy.reshape(-1, 1, 2))

        path, objs, info = ht.GD(obj_x, t([0.1 * Lx]), nabla=ht.EnGrad(chol=0.3), nIter=nIter,
                                 generator=gen)
        report("x_only EnOpt", objs, f"x*={float(path[-1][0]):.2f}")
        out["x_only"] = float(objs[-1])

    # ---- Case: 2 injectors, coordinate transform (reference :541-626) --------
    if "two_inj" in cases:
        m2 = base.replace(name="Lower 2 corners", prd_xy=xy_4corners[:2],
                          prd_rates=rate0 * np.ones((2, 1)) / 2,
                          inj_rates=rate0 * np.ones((2, 1)) / 2,
                          inj_xy=coordinate_transform(t([-1.0, 0, 1.0, 0]), Lx, Ly).reshape(2, 2))

        def obj2(U):
            return ht.npv_value(m2, cfg, inj_xy=coordinate_transform(U, Lx, Ly).reshape(-1, 2, 2))

        path, objs, info = ht.GD(obj2, t([-1.0, 0, 1.0, 0]), nabla=ht.EnGrad(chol=0.1),
                                 nIter=nIter, generator=gen)
        xy_fin = coordinate_transform(path[-1], Lx, Ly).cpu().numpy().round(2)
        report("two_inj EnOpt", objs, f"inj_xy*={xy_fin}")
        out["two_inj"] = float(objs[-1])

    # ---- Case: single rate (reference :637-673) -------------------------------
    if "rate" in cases:
        def obj_r(R):
            inj = R.reshape(-1, 1, 1)
            return ht.npv_value(base, cfg, inj_rates=inj, prd_rates=equalize(inj, base.nPrd))

        path, objs, info = ht.GD(obj_r, t([0.3]), nabla=ht.EnGrad(chol=0.1), nIter=nIter,
                                 generator=gen)
        report("rate EnOpt", objs, f"rate*={float(path[-1][0]):.2f}")
        out["rate"] = dict(rate=float(path[-1][0]), npv=float(objs[-1]))

    # ---- Case: multiple rates, manual + EnOpt (reference :676-733) ------------
    # The reference's `interactive_rate_optim` lets you hand-tune 4 injector
    # rates against EnOpt ("Were you able to beat EnOpt?"). Headless stand-in:
    # a coarse grid sweep over the 4 rates plays the human.
    triangle = [0, 135, -135]
    m_tri = base.replace(name="Triangle case",
                         inj_xy=[[Lx / 2, Ly / 2]] + [pCircle(th + 90, Lx, Ly) for th in triangle],
                         prd_xy=[pCircle(th - 90, Lx, Ly) for th in triangle],
                         inj_rates=rate0 * np.ones((4, 1)) / 4,
                         prd_rates=rate0 * np.ones((3, 1)) / 3)
    if "multi_rate" in cases:
        def obj_mr(U):
            inj = U.reshape(-1, m_tri.nInj, 1)
            return ht.npv_value(m_tri, cfg, inj_rates=inj, prd_rates=equalize(inj, m_tri.nPrd))

        n1d = 3 if args.small else 5
        g1 = np.linspace(0.1, 1.4, n1d)
        U = np.stack(np.meshgrid(*[g1] * 4, indexing="ij"), -1).reshape(-1, 4)
        t0 = time.perf_counter()
        vals = obj_mr(t(U)).cpu().numpy()
        i_best = int(vals.argmax())
        print(f"[multi_rate] manual (grid {n1d}^4) best NPV {vals[i_best]:.3f} at "
              f"rates {U[i_best].round(2)} [{time.perf_counter() - t0:.1f}s]")
        path, objs, info = ht.GD(obj_mr, 0.7 * torch.ones(m_tri.nInj, dtype=dtype, device=dev),
                                 nabla=ht.EnGrad(chol=0.1), nIter=nIter, generator=gen)
        beat = "EnOpt beat the grid" if objs[-1] > vals[i_best] else "grid beat EnOpt"
        report("multi_rate EnOpt", objs, f"rates*={path[-1].cpu().numpy().round(2)} ({beat})")
        out["multi_rate"] = dict(grid=float(vals[i_best]), enopt=float(objs[-1]))

    # ---- Case: time-dependent multi-well rates (reference :732-777) -----------
    if "time_rates" in cases:
        nInterval = 5 if args.small else 10
        split_at = nInterval * m_tri.nInj

        def obj_tr(U):
            inj = rate_transform(U[:, :split_at], m_tri.nInj, nInterval, nTime)
            prd = rate_transform(U[:, split_at:], m_tri.nPrd, nInterval, nTime)
            inj, prd = balance_rates(inj, prd)
            return ht.npv_value(m_tri, cfg, inj_rates=inj, prd_rates=prd)

        n_u = (m_tri.nInj + m_tri.nPrd) * nInterval
        u0 = -1.4 + 1e-2 * torch.randn(n_u, generator=gen, dtype=dtype, device=dev)
        path, objs, info = ht.GD(obj_tr, u0, nabla=ht.EnGrad(chol=0.6, nEns=20), nIter=nIter,
                                 generator=gen)
        report("time_rates EnOpt", objs)
        out["time_rates"] = float(objs[-1])

    # ---- Robust optimisation under uncertain permeability (reference :809-950) -
    if "robust" in cases:
        nEns = 8 if args.small else 31
        uq_pre = ht.sample_prior_perm(gen, base, nEns, r=0.8, dtype=dtype)
        uq_ens = 0.1 + torch.exp(5 * uq_pre)  # permeability fields (nEns, Nxy)

        def obj1(U, X):
            Kx = X.reshape(-1, *base.shape)
            return ht.npv_value(base, cfg, inj_xy=U.reshape(-1, 1, 2),
                                K=torch.stack([Kx, Kx], 1))

        def obj_robust(U):
            J = obj1(U.repeat_interleave(nEns, 0), uq_ens.repeat(len(U), 1))
            return J.reshape(len(U), nEns).mean(1)

        u0 = uniform(2) * box
        gd_state = gen.get_state()
        ctrl_robust = None
        for strategy in ["StoSAG", "Paired", "Mean-model"]:
            gen.set_state(gd_state)  # every strategy from the same draws
            ng = ht.EnGrad(chol=0.1, nEns=nEns, robustly=strategy, obj_ux=obj1, X=uq_ens)
            path, objs, info = ht.GD(obj_robust, u0, nabla=ng, nIter=nIter, generator=gen)
            report(f"robust[{strategy}]", objs, f"u*={path[-1].cpu().numpy().round(2)}")
            if strategy == "StoSAG":
                ctrl_robust = path[-1]

        # -- Per-member exhaustive verification (reference :958-997) ----------
        # For each uncertainty member: EnOpt its nominal optimum AND find the
        # global optimum by exhausting the objective on the grid; count
        # members whose EnOpt answer is significantly suboptimal.
        t0 = time.perf_counter()
        ctrl_nominal = []
        for n in range(nEns):
            u0n = uniform(2) * box
            pth, _, _ = ht.GD(lambda U, x=uq_ens[n]: obj1(U, x.expand(len(U), -1)), u0n,
                              nabla=ht.EnGrad(chol=0.1), nIter=nIter, generator=gen)
            ctrl_nominal.append(pth[-1])
        ctrl_nominal = torch.stack(ctrl_nominal)
        pts = mesh2list(*base.mesh, device=dev).to(dtype)  # (Nxy, 2) cell centres
        npv_mesh = obj1(pts.repeat(nEns, 1), uq_ens.repeat_interleave(len(pts), 0))
        best = torch.argmax(npv_mesh.reshape(nEns, -1), dim=1)
        ctrl_global = base.ind2xy(best.cpu()).T.numpy()
        err = (ctrl_global - ctrl_nominal.cpu().numpy()) / np.array([Lx, Ly])
        RMS = np.sqrt(np.mean(err**2, -1))
        n_bad = int((RMS > 0.1).sum())
        print(f"[robust] Number of significantly suboptimal EnOpt answer: "
              f"{n_bad} of {len(RMS)} [{time.perf_counter() - t0:.1f}s]")

        # -- Performance: robust vs nominal controls (reference :1009-1066) ---
        npvs_robust = obj1(ctrl_robust.expand(nEns, -1), uq_ens).cpu().numpy()
        npvs_condnl = obj1(ctrl_nominal.repeat_interleave(nEns, 0),
                           uq_ens.repeat(nEns, 1)).cpu().numpy()
        print("[robust]          Mean    Min")
        print(f"[robust] Robust:  {npvs_robust.mean():<6.3g}  {npvs_robust.min():.3g}")
        print(f"[robust] Nominal: {npvs_condnl.mean():<6.3g}  {npvs_condnl.min():.3g}")
        out["robust"] = dict(robust_mean=float(npvs_robust.mean()),
                             nominal_mean=float(npvs_condnl.mean()), suboptimal=n_bad)
        if args.plot:
            from historymatching_tpu_torch import plotting

            os.makedirs(args.outdir, exist_ok=True)
            plotting.npv_kde(npvs_condnl, npvs_robust).savefig(
                os.path.join(args.outdir, "npv_kde.png"), dpi=120)
            print(f"[robust] KDE figure written to {args.outdir}/npv_kde.png")

    # ---- Multi-objective: Pareto sweep over inj price (reference :1069-1139) ---
    if "pareto" in cases:
        m5 = base.replace(name="Angga2022-5spot", prd_xy=[[Lx / 2, Ly / 2]], inj_xy=xy_4corners,
                          prd_rates=rate0 * np.ones((1, 1)),
                          inj_rates=rate0 * np.ones((4, 1)) / 4)
        sales, emissions = [], []
        for xCost in ([0.2, 0.6] if args.small else np.arange(0.1, 1.0, 0.2)):
            cfg_x = cfg.replace(price_inj=20.0 * float(xCost))

            def obj_p(R, cfg_x=cfg_x):
                prd = R.reshape(-1, 1, 1)
                return ht.npv_value(m5, cfg_x, prd_rates=prd, inj_rates=equalize(prd, m5.nInj))

            path, objs, _ = ht.GD(obj_p, t([2.0]), nabla=ht.EnGrad(chol=0.1), nIter=nIter,
                                  generator=gen)
            r_opt = path[-1].reshape(1, 1)
            _, other = ht.npv(m5, cfg_x, prd_rates=r_opt, inj_rates=equalize(r_opt, m5.nInj))
            led = other["ledgr"]
            sales.append(float(led["oil"]))
            emissions.append(-(float(led["inj"]) + float(led["wat"])))
        print("[pareto] sales:", np.round(sales, 2), " emissions:", np.round(emissions, 2))
        out["pareto"] = dict(sales=sales, emissions=emissions)

    # ---- Case: toy-objective GD trial sweep (reference Optimise.py:352-421) -
    # Headless analogue of the reference's interactive trial dashboard: a
    # grid of configurations x random starts, each trial one `gd_scan`,
    # printed as a table of median initial -> final objective. The rastrigin
    # row with sdev 0.3 shows the EnOpt smoothing effect (a large mutation
    # radius averages out the ripples and escapes local minima that trap
    # the sdev 0.05 row).
    if "toys" in cases:
        def quadratic(u):
            return torch.mean(u * u, dim=-1)

        def rosenbrock(u):
            u = u * 3.0
            t1 = u[..., 1:] - u[..., :-1] ** 2
            t2 = u[..., :-1] - 1
            return torch.sum(100 * t1 * t1 + t2 * t2, dim=-1)

        def rastrigin(u):
            u = u * 5.12
            return 20 + torch.sum(u * u - 5 * torch.cos(2 * np.pi * u), dim=-1)

        toys = dict(quadratic=quadratic, rosenbrock=rosenbrock, rastrigin=rastrigin)
        nTrial = 3 if args.small else 5
        nIter_t = 20 if args.small else 40
        grid = [
            # (case, aspect, sdev, nEns, precond, nrmlz)
            ("quadratic", 0.0, 0.1, 10, False, True),
            ("quadratic", -1.0, 0.1, 10, False, True),   # anisotropic
            ("quadratic", -1.0, 0.1, 10, True, True),    # precond fixes it
            ("rosenbrock", 0.0, 0.05, 30, False, True),
            ("rosenbrock", 0.0, 0.05, 30, False, False),
            ("rastrigin", 0.0, 0.05, 40, False, True),   # trapped
            ("rastrigin", 0.0, 0.3, 40, False, True),    # smoothing escapes
        ]
        print(f"[toys] GD trial sweep ({nTrial} starts, {nIter_t} iters)")
        print(f"  {'case':<11}{'aspect':>7}{'sdev':>6}{'nEns':>5}"
              f"{'precond':>8}{'nrmlz':>6}{'med(J0)':>10}{'med(Jend)':>10}")
        rows = []
        for name, aspect, sdev, nEns, precond, nrmlz in grid:
            f = toys[name]
            scale = t([1.0, 10.0 ** aspect])
            J0s, Jns = [], []
            for i in range(nTrial):
                g = torch.Generator(device=dev).manual_seed(100 * args.seed + i)
                u0 = 2.0 * (torch.rand(2, generator=g, dtype=dtype, device=dev) - 0.5)
                _, objs_t, _ = ht.gd_scan(lambda u, f=f, scale=scale: f(u * scale), u0,
                                          chol=sdev, nEns=nEns, precond=precond, nrmlz=nrmlz,
                                          sign=-1, nIter=nIter_t, generator=g)
                J0s.append(float(objs_t[0]))
                Jns.append(float(objs_t[-1]))
            rows.append((name, float(np.median(J0s)), float(np.median(Jns))))
            print(f"  {name:<11}{aspect:>7.1f}{sdev:>6.2f}{nEns:>5}"
                  f"{str(precond):>8}{str(nrmlz):>6}"
                  f"{np.median(J0s):>10.3f}{np.median(Jns):>10.3f}")
        out["toys"] = rows
    return out


if __name__ == "__main__":
    main()
