#!/usr/bin/env python3
"""Workload-level parity of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 bench_gpu.py [--out DIR] [--two-pass off]

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "parity"))
    ap.add_argument("--two-pass", choices=("on", "off"), default="on")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_gpu.py runs on a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    from historymatching_tpu_torch import parity

    card = card_line()
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
