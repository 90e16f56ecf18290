#!/usr/bin/env python3
"""Workload-level parity of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 bench_gpu.py [--out DIR] [--two-pass off]
    python3 bench_gpu.py --oracle [--out DIR] [--spread] [--seeds RUNG:SEED,...]

Runs the reference's parity rungs (`historymatching_tpu_torch.parity`)
on the card in float32, on the inputs `bench.build_case` draws for each
seed (computed by the port's `prng`, no JAX), at the reference bench's
solver settings and schedules, and holds each posterior RMSE to the
committed exact float64 oracle's:

    PARITY_GPU        ES-MDA, N=192, seeds 1-10    cpu_f64_refs.json
    PARITY_GPU_LOC    localized ES-MDA, N=192      cpu_f64_refs_loc.json
    PARITY_GPU_IES    IES, N=192, seeds 1-5 x 8    cpu_f64_refs_ies.json
    PARITY_GPU_N384   ES-MDA ladder, N=384         cpu_f64_refs_N384.json
    PARITY_GPU_N768   ES-MDA ladder, N=768         cpu_f64_refs_N768.json
    PARITY_GPU_N1000  ES-MDA ladder, N=1000        cpu_f64_refs_N1000.json

Each rung's record (rows per seed, the gate and its criterion, the card
and its power limit, the torch version, the walls and the kernels'
launches) goes to DIR/<name>.json (default: parity/). `--two-pass off`
runs every solve without the straggler recook, for comparison.
The last line printed is one compact JSON object; the exit code is 1 if
any rung fails its gate or its inputs do not match the refs'. Without a
CUDA device it raises.

`--oracle` runs instead every seed of every committed ref file (38 seed
runs) through the port's own exact float64 oracle on the card
(`models.oracle`, its banded Cholesky kernel; `parity.run_oracle_seed`)
and holds each seed's prior and posterior RMSE to the committed row: the
prior within `parity.PRIOR_RTOL`, the posterior within
`parity.ORACLE_RTOL`, or, for IES, within the oracle's own spread at that
seed. The rows (each RMSE, its gap to the row, the wall) go to
DIR/ORACLE_GPU.json; the exit code is 1 if a seed fails both. `--spread`
measures the oracle's own spread at every seed, not only IES's (three runs
a seed, as IES's); `--seeds` runs those seeds only (e.g.
PARITY_GPU:5,PARITY_GPU_N1000:5).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def compact(records, card, wall):
    """One line: each rung's median, worst and verdict, IES's median over
    its replicas, and the run's wall."""
    line = {"metric": "parity_gpu", "card": card, "wall_s": round(wall, 3),
            "ok": all(r["ok"] and r["inputs_match_refs"] for r in records)}
    for r in records:
        fig = r.get("replica0", r)
        line[r["name"]] = [round(fig["ratio_median"], 4), round(fig["ratio_max"], 4), r["ok"],
                           round(r["wall_s"], 3)]
        if "ratio_median_all" in r:
            line[r["name"] + "_median_all"] = round(r["ratio_median_all"], 4)
    return json.dumps(line)


def oracle_main(out_dir, card, spread=False, seeds=None):
    """Every committed ref's seeds (or `seeds`, a set of (rung, seed))
    through the port's float64 oracle; see the module's docstring."""
    import torch

    from historymatching_tpu_torch import parity
    from historymatching_tpu_torch.ops import _build

    rows = []
    _build.reset_launches()
    t0 = time.perf_counter()
    for name, ref_file, method in parity.RUNGS:
        ref = parity.load_ref(ref_file)
        for seed in ref["seeds"]:
            if seeds and (name, seed) not in seeds:
                continue
            row = parity.run_oracle_seed(name, ref, method, seed, spread=spread)
            rows.append(dict(row, refs=ref_file))
            print(f"{name} seed {seed}: prior gap {row['prior_rel_gap']:.2e}, posterior gap "
                  f"{row['post_rel_gap']:.2e}"
                  + (f" (spread {row['spread']:.2e})" if "spread" in row else "")
                  + f", ok {row['ok']}, {row['wall_s']:.2f} s", flush=True)
    wall = time.perf_counter() - t0
    rec = dict(metric="oracle_gpu", card=card, device=torch.cuda.get_device_name(0),
               torch=torch.__version__, dtype="float64", prior_rtol=parity.PRIOR_RTOL,
               post_rtol=parity.ORACLE_RTOL, perturbation=parity.ORACLE_PERTURB,
               criterion=(f"prior RMSE within {parity.PRIOR_RTOL} relative of the row; posterior "
                          f"within {parity.ORACLE_RTOL}, or (IES) within the oracle's own "
                          f"spread under the prior scaled by 1 + k {parity.ORACLE_PERTURB}, "
                          "k = 1, 2"),
               seeds=len(rows), ok=all(r["ok"] for r in rows), wall_s=wall,
               launches={k: v for k, v in _build.LAUNCHES.items() if v}, rows=rows)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ORACLE_GPU.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(dict(
        metric="oracle_gpu", card=card, wall_s=round(wall, 3), seeds=len(rows),
        prior_within=sum(r["prior_rel_gap"] <= parity.PRIOR_RTOL for r in rows),
        post_within=sum(r["post_rel_gap"] <= parity.ORACLE_RTOL for r in rows),
        exceptions=[f"{r['rung']}:{r['seed']}" for r in rows if "exception" in r],
        failed=[f"{r['rung']}:{r['seed']}" for r in rows if not r["ok"]],
        prior_gap_max=max(r["prior_rel_gap"] for r in rows),
        post_gap_max=max(r["post_rel_gap"] for r in rows), ok=rec["ok"])))
    return 0 if rec["ok"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "parity"))
    ap.add_argument("--two-pass", choices=("on", "off"), default="on")
    ap.add_argument("--oracle", action="store_true",
                    help="run the committed refs' seeds through the port's float64 oracle")
    ap.add_argument("--spread", action="store_true",
                    help="with --oracle: the oracle's own spread at every seed")
    ap.add_argument("--seeds", default="",
                    help="with --oracle: RUNG:SEED,... to run those seeds only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_gpu.py runs on a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    from historymatching_tpu_torch import parity

    card = card_line()
    if args.oracle:
        seeds = {(rung, int(seed)) for rung, seed in
                 (item.split(":") for item in args.seeds.split(",") if item)}
        return oracle_main(args.out, card, args.spread, seeds)
    sim_kwargs = dict(parity.BASE, two_pass=args.two_pass == "on")
    os.makedirs(args.out, exist_ok=True)
    records = []
    t0 = time.perf_counter()
    for name, ref_file, method in parity.RUNGS:
        rec = parity.run_rung(name, ref_file, method, sim_kwargs=sim_kwargs, card=card,
                              log=lambda s: print(s, flush=True))
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"{name}: {json.dumps({k: rec[k] for k in ('ratio_median', 'ratio_max', 'ok')})}"
              if "ratio_median" in rec else
              f"{name}: median over {rec['runs']} runs {rec['ratio_median_all']:.4f}, replica 0 "
              f"median {rec['replica0']['ratio_median']:.4f} worst "
              f"{rec['replica0']['ratio_max']:.4f}, ok {rec['ok']}", flush=True)
        records.append(rec)
    print(compact(records, card, time.perf_counter() - t0))
    return 0 if all(r["ok"] and r["inputs_match_refs"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
