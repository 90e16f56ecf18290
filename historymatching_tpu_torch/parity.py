"""Workload-level parity: the port's float32 analyses on the reference
bench case, held to the exact float64 oracle's posterior RMSE.

The counterpart of the JAX package's parity harness (`bench.build_case`,
`bench.run_case`, `bench._ies_one`, `scripts/parity.py run`). Each seed's
truth field, prior, observation noise and analysis perturbations are the
draws `bench.build_case` makes from that seed, computed here by `prng`,
so the committed oracle refs (`parity/cpu_f64_refs*.json`, posterior
RMSEs of the same draws through an exact-solve float64 pipeline) are the
denominators. A rung runs one analysis over the ref's seeds and scores
each seed by rmse_post(port) / rmse_post(ref):

- ES-MDA, localized ES-MDA and the ensemble-size ladder: median <= 1.05
  and worst seed <= 1.12 (`bench.py`'s parity-in-N criterion);
- IES: the reference's own gate, median <= 1.05 (`scripts/parity.py`),
  read over seeds x replicas, and the improve/worsen direction of each
  seed's posterior matching the ref's at the unperturbed draw. Replica k
  scales the float32 prior by (1 + k 1e-6), as
  `scripts/ies_chaos_probe.py` does: the 10-iteration Gauss-Newton map
  amplifies rounding, so one draw's median moves by more than the gate's
  margin (the exact oracle itself moves by 0.95-1.07 under the same
  perturbation), and the gate reads the distribution instead.

`run_rung` runs one rung and returns its record; `bench_gpu.py` at the
repo root runs them all on the card and writes `parity/PARITY_GPU*.json`.
`run_case(oracle=True)` runs a seed through the port's own float64 oracle
(`models.oracle`), and `run_oracle_seed` holds that to the seed's
committed row (`bench_gpu.py --oracle`, `parity/ORACLE_GPU.json`).
"""

from __future__ import annotations

import json
import os
import statistics
import time

import numpy as np
import torch

from historymatching_tpu_torch import prng
from historymatching_tpu_torch.da.geostat import gaussian_fields_fft
from historymatching_tpu_torch.da.localization import domain_partition
from historymatching_tpu_torch.da.update import decorrelator, es_mda, ies, mda_alphas
from historymatching_tpu_torch.models.oracle import forward_oracle
from historymatching_tpu_torch.models.ressim import ResSim
from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.parallel.runner import forward_model, obs_ens_fn, prod_inds
from historymatching_tpu_torch.utils import gaussian_noise, temporal_R

REFS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "parity")
DT = 0.025
# The reference bench's solver settings (bench.bench_sim_kwargs without
# `packed`, `coarse_warm` and `warm_start`: TPU layouts, or off), its
# per-pass ES-MDA schedule (bench.DEFAULT_SCHED) and its per-iteration IES
# schedule (bench.IES_DEFAULT_SCHED).
BASE = dict(tol=2e-4, maxiter=768, patience_iters=256, two_pass=True, twopass_j1=64,
            twopass_div=4, refine=True)
_LOOSE = dict(tol=2e-3, maxiter=256, patience_iters=128, twopass_j1=8, twopass_div=8)
_FINAL = dict(twopass_div=8, twopass_j1=8, maxiter=128)
DEFAULT_SCHED = [_LOOSE] * 3 + [_FINAL]
IES_DEFAULT_SCHED = [_LOOSE] * 8 + [_FINAL] * 2
IES_XSTEP = 0.4  # the reference's IES, HistoryMatch.py:961, 10 iterations
THRESHOLD, MAX_RATIO = 1.05, 1.12
IES_REPLICAS, IES_PERTURB = 8, 1e-6
# A seed's prior RMSE against its ref's: the port drew JAX's inputs.
PRIOR_RTOL = 1e-6
# The port's float64 oracle on the card against the committed refs
# (`bench_gpu.py --oracle`): each posterior RMSE within ORACLE_RTOL of its
# row, or, for IES, within the oracle's own spread at that seed: the
# largest move of its posterior RMSE when the prior is scaled by 1 + k
# ORACLE_PERTURB, k = 1, 2.
ORACLE_RTOL, ORACLE_PERTURB = 1e-6, 1e-12
CRITERION = {
    "es_mda": f"median ratio <= {THRESHOLD} and worst seed <= {MAX_RATIO}",
    "ies": (f"median ratio over seeds x {IES_REPLICAS} replicas <= {THRESHOLD}, and the "
            "improve/worsen direction matches the f64 ref on every seed at replica 0"),
}
IES_NOTE = ("No worst-seed bound: the reference's IES gate has none "
            "(scripts/parity.py), and a single seed's ratio is chaos-bound, the "
            "10-iteration Gauss-Newton map moving it by up to ~0.2 under a 1e-6 "
            "perturbation of the prior.")
# Rungs: output name, ref file, analysis. N and seeds come from the ref.
RUNGS = (
    ("PARITY_GPU", "cpu_f64_refs.json", "es_mda"),
    ("PARITY_GPU_LOC", "cpu_f64_refs_loc.json", "es_mda_loc"),
    ("PARITY_GPU_IES", "cpu_f64_refs_ies.json", "ies"),
    ("PARITY_GPU_N384", "cpu_f64_refs_N384.json", "es_mda"),
    ("PARITY_GPU_N768", "cpu_f64_refs_N768.json", "es_mda"),
    ("PARITY_GPU_N1000", "cpu_f64_refs_N1000.json", "es_mda"),
)


def build_model(Nx, Ny, device="cuda"):
    """The bench case (bench.build_model): 2x1 domain, centre injector,
    4 producers at (0.12, 0.87) x (Lx, Ly), balanced unit rates."""
    Lx, Ly = 2.0, 1.0
    near01 = np.array([0.12, 0.87])
    prd_xy = [[x, y] for y in Ly * near01 for x in Lx * near01]
    return ResSim.build(Nx=Nx, Ny=Ny, Lx=Lx, Ly=Ly, inj_xy=[[Lx / 2, Ly / 2]], prd_xy=prd_xy,
                        inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4,
                        dtype=torch.float32, device=device)


def build_case(seed, N, Nx=64, Ny=64, nTime=40, device="cuda"):
    """`bench.build_case`: the seed's truth field, prior (N, Nxy), noise
    (nTime * nPrd,), R12 and the analysis key `key_mda`, drawn in float32
    from `PRNGKey(seed)` split four ways, as the JAX package draws them."""
    model = build_model(Nx, Ny, device)
    k_truth, k_prior, k_noise, k_mda = prng.split(prng.PRNGKey(seed, device), 4)
    f32 = torch.float32
    field = lambda n, k: gaussian_fields_fft(model.grid, N=n, r=0.8, key=k, dtype=f32,  # noqa: E731
                                             device=device)
    _, R12 = temporal_R(nTime, model.nPrd, dtype=f32, device=device)
    noise = R12 @ prng.normal(k_noise, (nTime * model.nPrd,))
    return dict(model=model, truth=field(1, k_truth)[0], prior=field(N, k_prior), noise=noise,
                R12=R12, key_mda=k_mda, nTime=nTime, seed=seed, N=N, Nx=Nx, Ny=Ny)


def rmse(E, truth):
    """Posterior-mean RMSE against the truth field, in float64."""
    return float(((E.double().mean(0) - truth.double()) ** 2).mean().sqrt())


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_case(method, seed, N, Nx=64, Ny=64, nTime=40, sim_kwargs=None, sched=None,
             replicas=1, dtype=torch.float32, device="cuda", oracle=False,
             perturb=IES_PERTURB):
    """One seed of one analysis, `bench.run_case` / `bench._ies_one`:
    the truth simulated at `sim_kwargs` (default `BASE`) gives the
    observations, then ES-MDA ("es_mda", or "es_mda_loc" over 4x4-cell
    domains with the radius-1.2 bump taper) with `sched` per pass
    (default `DEFAULT_SCHED`), or IES with `sched` per iteration (default
    `IES_DEFAULT_SCHED`, its length the iteration count), xStep 0.4. IES
    (and any analysis on the oracle) runs `replicas` times, replica k on
    the prior scaled by (1 + k `perturb`) in float32. The pipeline runs in
    `dtype` on inputs drawn in float32.

    With `oracle` every forward run (the truth's and each pass's or
    iteration's) is the exact float64 oracle (`models.oracle.forward_oracle`,
    `bench.run_case(oracle=True)` / `bench.run_ies_case(oracle=True)`):
    `dtype` must be float64, the solver settings are ignored, IES's
    replicas scale the prior in float64, and the seed's draws (the fields,
    the noise, the analysis's perturbations) are made on the CPU and moved
    to `device`: the card's DFTs and normals round otherwise, and the
    CPU's draws are the same on every host (they differ from JAX's by
    float32 rounding of the DFTs, `PRIOR_RTOL`).
    Returns {seed, rmse_prior, rmse_post: [per replica], elapsed_s: [per
    replica], the workload's wall without the truth run}."""
    sim_kwargs = BASE if sim_kwargs is None else sim_kwargs
    ies_method = method == "ies"
    if sched is None:
        sched = IES_DEFAULT_SCHED if ies_method else DEFAULT_SCHED
    if oracle and dtype != torch.float64:
        raise ValueError("the oracle is a float64 reference: pass dtype=torch.float64")
    forward = forward_oracle if oracle else forward_model
    if oracle:  # the CPU's draws, the same on every host (oracle_cpu_check.py --port-draws)
        cpu = build_case(seed, N, Nx, Ny, nTime, "cpu")
        case = dict(cpu, model=build_model(Nx, Ny, device),
                    **{k: cpu[k].to(device) for k in ("truth", "prior", "noise", "R12")})
    else:
        cpu = case = build_case(seed, N, Nx, Ny, nTime, device)
    model = case["model"]
    truth, prior, R12, noise = (case[k].to(dtype) for k in ("truth", "prior", "R12", "noise"))
    _, prod_truth = forward(model, truth[None], dt=DT, nTime=nTime, keep_wsats=False,
                            **sim_kwargs)
    obs = torch.clamp(prod_truth[0].reshape(-1) + noise, 0, 1)
    if oracle:
        def oracle_fn(E):
            return forward_oracle(model, E, dt=DT, nTime=nTime)[1].reshape(E.shape[0], -1)

        fwds = [oracle_fn] * len(sched)
    else:
        fwds = [obs_ens_fn(model, DT, nTime, **dict(sim_kwargs, **ov)) for ov in sched]
    sdtype = torch.float64 if oracle else torch.float32
    scales = [torch.tensor(1 + k * perturb, dtype=sdtype) for k in range(replicas)]

    def prior_of(k):
        return (case["prior"].to(sdtype) * scales[k].to(device)).to(dtype)

    if ies_method:
        # drawn with the float32 R12, as bench._ies_one
        perturbs = gaussian_noise(N, obs.numel(), L=cpu["R12"], key=cpu["key_mda"]).to(device,
                                                                                         dtype)
        dec = decorrelator(R12)

        def workload(k):
            return ies(prior_of(k), fwds, obs, perturbs, dec, xStep=IES_XSTEP, iMax=len(sched))[0]
    else:
        if replicas != 1 and not oracle:
            raise ValueError("replicas are for IES and the oracle")
        loc_kw = {}
        if method == "es_mda_loc":
            domains, taper_dom = domain_partition(model.grid, prod_inds(model), nTime=nTime,
                                                  steps=(4, 4), radius=1.2, dtype=dtype,
                                                  device=device)
            loc_kw = dict(domains=domains, taper_dom=taper_dom)
        elif method != "es_mda":
            raise ValueError(f"unknown method {method!r}")
        alphas = mda_alphas(len(sched), dtype=dtype, device=device)
        draw_kw = dict(key=case["key_mda"])
        if oracle:  # es_mda's per-pass draws, made on the CPU
            draws, key = [], cpu["key_mda"]
            for _ in sched:
                key, sub = prng.split(key)
                draws.append(gaussian_noise(N, obs.numel(), L=cpu["R12"], key=sub))
            draw_kw = dict(noise=draws)

        def workload(k):
            return es_mda(prior_of(k), fwds, obs, R12, alphas, **draw_kw, **loc_kw)
    posts, walls = [], []
    for k in range(replicas):
        _sync(device)
        t0 = time.perf_counter()
        post = workload(k)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        if not (bool(torch.isfinite(post).all()) and post.shape == prior.shape):
            raise FloatingPointError(f"seed {seed} replica {k}: posterior not finite")
        posts.append(rmse(post, truth))
    return dict(seed=seed, rmse_prior=rmse(prior, truth), rmse_post=posts, elapsed_s=walls)


def gate(method, rows):
    """The rung's statistics and verdict from its rows, each {ratios: [per
    replica], improves_matches_f64: at replica 0}. ES-MDA rungs hold one
    replica a seed."""
    ratios0 = [r["ratios"][0] for r in rows]
    dirs = sum(bool(r["improves_matches_f64"]) for r in rows)
    out = dict(ratio_median=statistics.median(ratios0), ratio_max=max(ratios0),
               ratio_min=min(ratios0), improves_direction_matches=f"{dirs}/{len(rows)}")
    if method != "ies":
        out["ok"] = out["ratio_median"] <= THRESHOLD and out["ratio_max"] <= MAX_RATIO
        return out
    every = [x for r in rows for x in r["ratios"]]
    return dict(
        ratio_median_all=statistics.median(every), ratio_mean_all=statistics.fmean(every),
        runs=len(every), seed_medians=[statistics.median(r["ratios"]) for r in rows],
        improves_direction_matches=out["improves_direction_matches"],
        replica0=dict(out, ratios=ratios0),
        ok=statistics.median(every) <= THRESHOLD and dirs == len(rows))


def load_ref(ref_file):
    with open(os.path.join(REFS_DIR, ref_file)) as f:
        return json.load(f)


def run_rung(name, ref_file, method, device="cuda", sim_kwargs=None, card=None, log=None):
    """One rung over its ref's seeds at its N, 64x64, 40 steps, at the
    reference's settings (`sim_kwargs` replaces `BASE`). Returns the
    record that `bench_gpu.py` writes: rows, gate, walls and the kernels'
    launches over the rung."""
    ref = load_ref(ref_file)
    sim_kwargs = BASE if sim_kwargs is None else sim_kwargs
    ies_method = method == "ies"
    sched = IES_DEFAULT_SCHED if ies_method else DEFAULT_SCHED
    replicas = IES_REPLICAS if ies_method else 1
    refs = {r["seed"]: r for r in ref["rows"]}
    _build.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    rows = []
    for seed in ref["seeds"]:
        r = run_case(method, seed, ref["N"], sim_kwargs=sim_kwargs, sched=sched,
                     replicas=replicas, device=device)
        rr = refs[seed]
        r.update(rmse_prior_ref=rr["rmse_prior"], rmse_post_ref=rr["rmse_post"],
                 prior_rel_err=abs(r["rmse_prior"] - rr["rmse_prior"]) / rr["rmse_prior"],
                 ratios=[x / rr["rmse_post"] for x in r["rmse_post"]],
                 improves_matches_f64=bool((r["rmse_post"][0] < r["rmse_prior"])
                                           == (rr["rmse_post"] < rr["rmse_prior"])))
        rows.append(r)
        if log:
            log(f"{name} seed {seed}: ratios {[round(x, 4) for x in r['ratios']]}, "
                f"{sum(r['elapsed_s']):.2f} s")
    _sync(device)
    wall = time.perf_counter() - t0
    family = "ies" if ies_method else "es_mda"
    rec = dict(
        name=name, N=ref["N"], seeds=ref["seeds"], method=method, config=ref["config"],
        sim_kwargs=dict(sim_kwargs, **{"ies_sched" if ies_method else "sched": sched}),
        ref_sim_kwargs=ref["sim_kwargs"], refs=ref_file,
        backend=torch.device(device).type, torch=torch.__version__,
        device=torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
        card=card, threshold=THRESHOLD, max_threshold=None if ies_method else MAX_RATIO,
        criterion=CRITERION[family], **gate(family, rows),
        prior_rel_err_max=max(r["prior_rel_err"] for r in rows),
        inputs_match_refs=all(r["prior_rel_err"] <= PRIOR_RTOL for r in rows),
        wall_s=wall, launches={k: v for k, v in _build.LAUNCHES.items() if v}, rows=rows)
    if ies_method:
        rec.update(iMax=len(sched), xStep=IES_XSTEP, replicas=IES_REPLICAS,
                   perturbation=IES_PERTURB, note=IES_NOTE)
    return rec


def run_oracle_seed(name, ref, method, seed, device="cuda", spread=False):
    """One seed of a ref file through the port's float64 oracle
    (`run_case(oracle=True)`), held to the ref's row: the prior's and the
    posterior's RMSE, their gaps relative to the row, and, for IES (any
    method with `spread`), the oracle's own spread (replicas 1 and 2 at
    ORACLE_PERTURB). Returns the row that `bench_gpu.py --oracle` writes."""
    ies_method = method == "ies"
    row = {r["seed"]: r for r in ref["rows"]}[seed]
    _sync(device)
    t0 = time.perf_counter()
    r = run_case(method, seed, ref["N"], sched=IES_DEFAULT_SCHED if ies_method else DEFAULT_SCHED,
                 replicas=3 if ies_method or spread else 1, dtype=torch.float64, device=device,
                 oracle=True, perturb=ORACLE_PERTURB)
    _sync(device)
    out = dict(rung=name, method=method, N=ref["N"], seed=seed, rmse_prior=r["rmse_prior"],
               rmse_post=r["rmse_post"][0], rmse_prior_ref=row["rmse_prior"],
               rmse_post_ref=row["rmse_post"],
               prior_rel_gap=abs(r["rmse_prior"] - row["rmse_prior"]) / row["rmse_prior"],
               post_rel_gap=abs(r["rmse_post"][0] - row["rmse_post"]) / row["rmse_post"],
               wall_s=time.perf_counter() - t0, workload_s=r["elapsed_s"][0],
               cpu_first_call_s=row.get("first_call_s"))
    ok_post = out["post_rel_gap"] <= ORACLE_RTOL
    if len(r["rmse_post"]) > 1:
        moved = max(abs(x - r["rmse_post"][0]) for x in r["rmse_post"][1:])
        out.update(rmse_post_perturbed=r["rmse_post"][1:], spread=moved,
                   post_within_spread=abs(r["rmse_post"][0] - row["rmse_post"]) <= moved)
        if ies_method and not ok_post and out["post_within_spread"]:
            out["exception"] = "IES: the posterior's gap is within the oracle's own spread"
        ok_post = ok_post or (ies_method and out["post_within_spread"])
    out["ok"] = out["prior_rel_gap"] <= PRIOR_RTOL and ok_post
    return out


def check_record(rec):
    """Reasons a written record fails its stated gate (empty when it
    passes): the gate recomputed from its rows, its inputs against the
    refs, and its replica count."""
    family = "ies" if rec["method"] == "ies" else "es_mda"
    bad = []
    if rec["criterion"] != CRITERION[family]:
        bad.append(f"criterion {rec['criterion']!r}")
    if not gate(family, rec["rows"])["ok"] or not rec["ok"]:
        bad.append("gate failed")
    if not all(r["prior_rel_err"] <= PRIOR_RTOL for r in rec["rows"]):
        bad.append(f"prior rmse off its ref by {rec['prior_rel_err_max']:.2e}")
    if family == "ies" and any(len(r["ratios"]) != IES_REPLICAS for r in rec["rows"]):
        bad.append("replica count")
    return bad
