"""End-to-end history-matching tutorial workflow on the PyTorch/CUDA port.

The counterpart of the JAX package's `examples/history_match.py`: the
tutorial case (20x20, centre injector, four corner producers), the truth
and its noisy observations, a prior ensemble of N=40, then ES, localized
ES, IES, ILES, ES-MDA and the data-space ES0, the accuracy of each against
the truth's field, its past production and a restart-based forecast, the
correlation probe, the taper-radius sweep and the prior spectrum. Draws
come from a `torch.Generator` seeded by `--seed`, so the numbers differ
from the JAX example's, which draws with `jax.random`. It runs on the
card unless `--cpu` is given; `--f64` runs float64.

With `--plot`, the figures of the JAX example go to `--outdir`: the
posterior means, the past production, the correlation probe and the
taper-radius sweep (needs matplotlib, which the card's host may lack).

Run:  python -m historymatching_tpu_torch.examples.history_match [--small] [--cpu] [--f64] [--plot]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import historymatching_tpu_torch as ht
from historymatching_tpu_torch.da.localization import (
    corr_wells,
    dist_to_obs,
    suggest_taper_radius,
)
from historymatching_tpu_torch.da.update import decorrelator
from historymatching_tpu_torch.parallel.runner import obs_ens_fn, prod_inds

METHODS = ("ES", "LES", "IES", "ILES", "MDA")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """Run the workflow; returns the printed accuracy tables as
    {"param" | "past" | "future": {series: (rms err, rms dev)}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="small/fast configuration")
    ap.add_argument("--f64", action="store_true", help="float64")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--plot", action="store_true", help="write figures to --outdir")
    ap.add_argument("--outdir", default="figs")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kw = dict(dtype=dtype, device=dev)

    # ---- Case setup (reference HistoryMatch.py:97,177-190) -----------------
    Lx, Ly = 2.0, 1.0
    Nx = Ny = 20
    near01 = np.array([0.12, 0.87])
    prd_xy = [[x, y] for y in Ly * near01 for x in Lx * near01]
    model = ht.ResSim.build(Nx=Nx, Ny=Ny, Lx=Lx, Ly=Ly, inj_xy=[[Lx / 2, Ly / 2]],
                            prd_xy=prd_xy, inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4,
                            name="HistoryMatch tutorial case", **kw).validate()
    T, dt = 1.0, 0.025
    nTime = 20 if args.small else round(T / dt)
    N = 20 if args.small else 40

    # ---- Truth + prior (same law; reference HistoryMatch.py:151-167,289) ---
    truth = ht.sample_prior_perm(gen, model, 1, r=0.8, dtype=dtype)[0]
    prior = ht.sample_prior_perm(gen, model, N, r=0.8, dtype=dtype)
    perm = {"Truth": truth[None], "Prior": prior}

    # ---- Truth simulation + noisy obs (reference :219-267) ------------------
    wsat0 = torch.zeros(model.Nxy, **kw)
    t0 = time.perf_counter()
    wsats_t, prod_truth = ht.forward_model(model, truth[None], wsat0, dt, nTime)
    prod_truth = prod_truth[0]
    nPrd = model.nPrd
    _, R12 = ht.temporal_R(nTime, nPrd, **kw)
    noise = (R12 @ torch.randn(nTime * nPrd, generator=gen, **kw)).reshape(nTime, nPrd)
    prod_noisy = torch.clamp(prod_truth + noise, 0, 1)

    # ---- Prior ensemble forward run (reference :400-401) -------------------
    wsats_prior, prod_prior = ht.forward_model(model, prior, wsat0, dt, nTime)
    _sync(dev)
    print(f"forward runs ({N + 1} sims x {nTime} steps): {time.perf_counter() - t0:.2f}s")

    # ---- Common update arguments (reference hm_setup0, :635-640) -----------
    setup = dict(obs_ens=ht.vect(prod_prior), obs=ht.vect(prod_noisy),
                 perturbs=ht.gaussian_noise(N, nTime * nPrd, L=R12, generator=gen, **kw),
                 decorr=decorrelator(R12))
    no_obs_ens = {k: v for k, v in setup.items() if k != "obs_ens"}

    # ---- ES (reference :652) ------------------------------------------------
    perm["ES"] = ht.ens_update0(prior, **setup)

    # ---- Localized ES (reference :863, radius 1.2 bump taper) ---------------
    pinds = prod_inds(model).cpu().numpy()
    dists = dist_to_obs(model.grid, pinds, nTime=nTime, **kw)
    taper = ht.bump(dists / 1.2)
    perm["LES"] = ht.ens_update0_loc(prior, **setup, taper=taper)

    # ---- IES / ILES (reference :961,1075; xStep=0.4, iMax=10) --------------
    fwd_obs = obs_ens_fn(model, dt, nTime)
    iMax = 3 if args.small else 10
    t0 = time.perf_counter()
    perm["IES"], _ = ht.ies(prior, fwd_obs, **no_obs_ens, xStep=0.4, iMax=iMax)
    _sync(dev)
    print(f"IES ({iMax} iters): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    perm["ILES"], _ = ht.iles(prior, fwd_obs, **no_obs_ens, taper=taper, xStep=0.4, iMax=iMax)
    _sync(dev)
    print(f"ILES ({iMax} iters): {time.perf_counter() - t0:.2f}s")

    # ---- ES-MDA --------------------------------------------------------------
    perm["MDA"] = ht.es_mda(prior, fwd_obs, setup["obs"], R12, ht.mda_alphas(4, **kw),
                            generator=gen, noise_dtype=dtype)

    # ---- Diagnostics wrt truth (reference :1114-1115) ------------------------
    print("\nAccuracy wrt (supposedly unknown) parameter field")
    tables = {"param": ht.utils.print_RMSMs(perm, ref="Truth")}

    # ---- Data mismatch: re-run posteriors (reference :1142-1145) -------------
    prod = {"Truth": prod_truth, "Noisy": prod_noisy, "Prior": prod_prior}
    wsat_cur = {"Truth": wsats_t[0, -1], "Prior": wsats_prior[:, -1]}
    for methd in METHODS:
        w, p = ht.forward_model(model, perm[methd], wsat0, dt, nTime)
        prod[methd] = p
        wsat_cur[methd] = w[:, -1]

    # ---- ES0: data-space inversion (reference :1156) --------------------------
    prod["ES0"] = ht.vect(ht.ens_update0(ht.vect(prod_prior), **setup), nTime, undo=True)

    print("\nAccuracy wrt past production (vs noisy obs)")
    tables["past"] = ht.utils.print_RMSMs(prod, ref="Noisy")

    # ---- Future prediction via restart (reference :1212-1231) ----------------
    nFutr = 10 if args.small else 20
    futr = {"Truth": ht.forward_model(model, truth[None], wsat_cur["Truth"][None], dt,
                                      nFutr)[1][0]}
    for methd in ("Prior",) + METHODS:
        futr[methd] = ht.forward_model(model, perm[methd], wsat_cur[methd], dt, nFutr)[1]
    print("\nAccuracy wrt future production (vs truth)")
    tables["future"] = ht.utils.print_RMSMs(futr, ref="Truth")

    # ---- Correlation study (reference :478-494, non-interactive) -------------
    i_mid = int(model.xy2ind(Lx / 2 + 0.3, Ly / 2))
    C = ht.corr(prior, wsats_prior[:, -1, i_mid])
    print(f"\ncorr(pre-perm, final sat @ probe cell): range [{float(C.min()):.2f}, "
          f"{float(C.max()):.2f}]")

    # ---- Taper tuning: corr_wells sweep (reference :738-769, headless) -------
    # The radius whose tapered small-ensemble correlation fields best
    # resemble the full ensemble's (the reference's suggested answer: 0.8).
    best_r, best_s, scores = suggest_taper_radius(prior, prod_prior, dists, nPrd,
                                                  n_small=max(4, N // 2))
    print(f"taper tuning (corr_wells sweep): suggested radius {best_r} "
          f"sharpness {best_s} (reference suggestion: 0.8; run uses 1.2)")
    for (r, s), v in sorted(scores.items(), key=lambda kv: kv[1])[:5]:
        print(f"  radius {r:<4} sharp {s:<4}: score {v:.4f}")
    # Prior singular spectrum (reference :332-333).
    sv = ht.svals(prior).cpu().numpy()
    print(f"prior spectrum: s[0]={sv[0]:.2f}, s[-1]={sv[-1]:.3f}, "
          f"s[0]/s[-1]={sv[0] / max(sv[-1], 1e-12):.1f}")

    if args.plot:
        from historymatching_tpu_torch import plotting

        os.makedirs(args.outdir, exist_ok=True)
        save = lambda fig, name: fig.savefig(os.path.join(args.outdir, name), dpi=120)  # noqa: E731
        means = {k: v.reshape(-1, model.Nxy).mean(0) for k, v in perm.items()}
        save(plotting.fields(model, means, "pperm", "Posterior means")[0], "perm_means.png")
        save(plotting.productions(prod, "Past production")[0], "productions.png")
        save(plotting.fields(model, {"corr": C}, "corr", "Correlation probe")[0],
             "correlation.png")
        cw = {f"r={r}": corr_wells(prior, prod_prior, dists, nTime - 1, 0, nPrd,
                                   N=max(4, N // 2), radius=r) for r in (0.4, best_r, 2.0)}
        cw["full ens"] = corr_wells(prior, prod_prior, dists, nTime - 1, 0, nPrd)
        save(plotting.fields(model, cw, "corr", "corr_wells taper tuning (well 0)")[0],
             "corr_wells.png")
        print(f"figures written to {args.outdir}/")
    return tables


if __name__ == "__main__":
    main()
