#!/usr/bin/env python3
"""Rerun the JAX package's exact float64 oracle on the CPU for one seed of a
committed ref file, on JAX's own draws or on the port's.

    python3 oracle_cpu_check.py --seed 1 [--ref cpu_f64_refs.json] [--port-draws]
                                [--out FILE]

`bench.run_case(oracle=True)` (or `bench.run_ies_case(oracle=True)` for
the IES refs), as `scripts/parity.py ref` wrote the committed rows, at the
ref's N, 64x64, 40 steps. With `--port-draws` the case is the port's
`parity.build_case` on the CPU (the draws `bench_gpu.py --oracle` gives
the port's oracle on the card) instead of `bench.build_case`: the two
differ by float32 rounding of the fields' DFTs, so this run and the card's
see the same inputs. Prints (and with `--out` writes) one JSON object: the
seed, the draws, rmse_prior, rmse_post, the committed row's and the wall.
It needs JAX and runs on a CPU host: about 15-80 minutes a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ref", default="cpu_f64_refs.json")
    ap.add_argument("--port-draws", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    import bench

    with open(os.path.join(ROOT, "parity", args.ref)) as f:
        ref = json.load(f)
    row = {r["seed"]: r for r in ref["rows"]}[args.seed]
    if args.port_draws:
        from historymatching_tpu_torch import parity

        def build_case(seed, N, Nx=64, Ny=64, nTime=40):
            case = parity.build_case(seed, N, Nx, Ny, nTime, device="cpu")
            arrays = {k: jnp.asarray(case[k].numpy()) for k in ("truth", "prior", "noise", "R12")}
            return dict(case, **arrays, model=bench.build_model(Nx, Ny),
                        key_mda=jnp.asarray(case["key_mda"].numpy().astype(np.uint32)))

        bench.build_case = build_case
    t0 = time.perf_counter()
    if ref.get("method") == "ies":
        out = bench.run_ies_case(args.seed, ref["N"], dtype=jnp.float64, oracle=True,
                                 iMax=ref["sim_kwargs"]["iMax"], xStep=ref["sim_kwargs"]["xStep"])
    else:
        out = bench.run_case(args.seed, ref["N"], dtype=jnp.float64, timed=False,
                             loc=ref["loc"], oracle=True)
    rec = dict(seed=args.seed, ref=args.ref, N=ref["N"],
               draws="port (parity.build_case, CPU)" if args.port_draws else "jax (bench.build_case)",
               rmse_prior=out["rmse_prior"], rmse_post=out["rmse_post"],
               rmse_prior_ref=row["rmse_prior"], rmse_post_ref=row["rmse_post"],
               wall_s=time.perf_counter() - t0)
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
