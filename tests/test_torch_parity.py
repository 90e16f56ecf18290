"""The workload-level parity harness (`historymatching_tpu_torch.parity`,
`bench_gpu.py`):

- its gate on synthetic rows: the ES-MDA rungs' median and worst-seed
  bounds, and the IES gate over seeds x replicas, which passes a set
  whose unperturbed draw alone has a median over 1.05 and fails one whose
  replicas' median is over it or whose direction differs from the ref's;
- the committed `parity/PARITY_GPU*.json` (written on the card by the
  harness) meet the gates they state, name the card and its power limit,
  and drew the refs' inputs;
- one ES-MDA and one IES case end to end on the CPU at 16x16, N=16,
  against the JAX package's `bench.run_case` / `bench.run_ies_case` on
  the same seed and the same inputs, in float64. Steps of dt=0.1 (both
  sides' DT patched) bring water to the producers in 10 steps, so the
  analyses move the ensemble. Tolerance 1e-12 relative on the prior RMSE
  and 1e-7 on IES's posterior RMSE (3 iterations), for the reason
  tests/test_torch_slice.py gives (solves at tol 1e-10 with differently
  computed coarse inverses, statistics of a few members). ES-MDA's 4
  passes are held to 1e-4: the passes agree to 4e-10 after the first,
  but the second pass's forward run of that same ensemble differs by
  2e-7 between the packages (where the water front meets the producers,
  the solves' 1e-10 differences reach the produced saturations), and the
  update with 16 members carries that to ~1e-5 in the posterior.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from historymatching_tpu_torch import parity

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(ratios, dirs=None):
    dirs = dirs or [True] * len(ratios)
    return [dict(ratios=r if isinstance(r, list) else [r], improves_matches_f64=d)
            for r, d in zip(ratios, dirs)]


def test_es_mda_gate():
    ok = parity.gate("es_mda", _rows([0.97, 1.0, 1.04, 1.1, 1.06]))
    assert ok["ok"] and ok["ratio_median"] == 1.04 and ok["ratio_max"] == 1.1
    assert ok["improves_direction_matches"] == "5/5"
    assert not parity.gate("es_mda", _rows([0.97, 1.0, 1.04, 1.13, 1.06]))["ok"]  # worst seed
    assert not parity.gate("es_mda", _rows([1.06, 1.0, 1.07, 1.1]))["ok"]  # median
    # ES-MDA's gate states no direction requirement
    assert parity.gate("es_mda", _rows([1.0, 1.0, 1.0], [True, False, True]))["ok"]


def test_ies_gate_reads_seeds_times_replicas():
    # replica 0 alone: median 1.07 (over 1.05), worst 1.15; all 40 runs: 1.036
    base = [[0.87, 0.95, 0.95, 0.90, 0.94, 0.98, 0.93, 0.93],
            [0.85, 0.89, 0.97, 0.92, 0.91, 0.97, 0.90, 0.88],
            [1.15, 1.19, 1.05, 1.03, 1.05, 1.02, 1.19, 1.06],
            [1.08, 1.04, 1.22, 1.17, 1.13, 1.10, 1.06, 1.08],
            [1.07, 1.16, 1.10, 1.07, 0.98, 1.03, 1.08, 1.07]]
    g = parity.gate("ies", _rows(base))
    assert g["replica0"]["ratio_median"] == 1.07 and g["replica0"]["ratio_max"] == 1.15
    assert g["ratio_median_all"] == pytest.approx(1.035) and g["runs"] == 40
    assert g["seed_medians"][0] == pytest.approx(0.935) and g["ok"]
    # the replicas' median over the bound fails, whatever replica 0 says
    worse = [[x + 0.08 for x in r] for r in base]
    worse[0][0] = 0.5
    assert not parity.gate("ies", _rows(worse))["ok"]
    # a seed whose posterior improves where the ref's worsens fails
    assert not parity.gate("ies", _rows(base, [True, True, False, True, True]))["ok"]


@pytest.mark.parametrize("name, ref_file, method", parity.RUNGS)
def test_committed_gpu_parity_meets_its_gate(name, ref_file, method):
    with open(os.path.join(parity.REFS_DIR, name + ".json")) as f:
        rec = json.load(f)
    ref = parity.load_ref(ref_file)
    assert parity.check_record(rec) == [], parity.check_record(rec)
    assert rec["ok"] and rec["inputs_match_refs"] and rec["method"] == method
    assert rec["N"] == ref["N"] and rec["seeds"] == ref["seeds"] == [r["seed"] for r in rec["rows"]]
    for r, rr in zip(rec["rows"], ref["rows"]):
        assert r["rmse_post_ref"] == rr["rmse_post"] and r["rmse_prior_ref"] == rr["rmse_prior"]
    # on the card, which the record names with its power limit
    assert rec["backend"] == "cuda" and rec["device"] in rec["card"] and rec["card"].endswith("W")
    assert rec["launches"]["transport_upwind"] > 0 and rec["launches"]["pressure_pcg"] > 0
    if method == "ies":
        assert rec["replicas"] == parity.IES_REPLICAS and rec["runs"] == 8 * len(rec["seeds"])
        assert rec["max_threshold"] is None and rec["note"]


@pytest.fixture
def same_inputs(monkeypatch):
    """dt=0.1 on both sides, and the JAX bench run on the port's case: the
    port's draws (held to `bench.build_case`'s within float32 rounding by
    tests/test_torch_prng.py) given to both, so the pipelines alone
    differ."""
    monkeypatch.setattr(bench, "DT", 0.1)
    monkeypatch.setattr(parity, "DT", 0.1)

    def build_case(seed, N, Nx=64, Ny=64, nTime=40):
        case = parity.build_case(seed, N, Nx, Ny, nTime, device="cpu")
        arrays = {k: jnp.asarray(case[k].numpy()) for k in ("truth", "prior", "noise", "R12")}
        return dict(case, **arrays, model=bench.build_model(Nx, Ny),
                    key_mda=jnp.asarray(case["key_mda"].numpy().astype(np.uint32)))

    monkeypatch.setattr(bench, "build_case", build_case)


def test_es_mda_case_matches_jax_bench(same_inputs):
    seed, N, n, nTime = 2, 16, 16, 10
    ref = bench.run_case(seed, N, n, n, nTime, dtype=jnp.float64, timed=False)
    out = parity.run_case("es_mda", seed, N, n, n, nTime, sim_kwargs={}, sched=[{}] * 4,
                          dtype=F64, device="cpu")
    assert out["rmse_prior"] == pytest.approx(ref["rmse_prior"], rel=1e-12)
    assert out["rmse_post"][0] == pytest.approx(ref["rmse_post"], rel=1e-4)
    assert abs(out["rmse_post"][0] - out["rmse_prior"]) > 1e-3  # the data moved it


def test_ies_case_matches_jax_bench(same_inputs):
    seed, N, n, nTime, iMax = 3, 16, 16, 10, 3
    ref = bench.run_ies_case(seed, N, n, n, nTime, dtype=jnp.float64, iMax=iMax)
    out = parity.run_case("ies", seed, N, n, n, nTime, sim_kwargs={}, sched=[{}] * iMax,
                          replicas=2, dtype=F64, device="cpu")
    assert out["rmse_prior"] == pytest.approx(ref["rmse_prior"], rel=1e-12)
    assert out["rmse_post"][0] == pytest.approx(ref["rmse_post"], rel=1e-7)
    assert abs(out["rmse_post"][0] - out["rmse_prior"]) > 1e-3
    # replica 1 runs the prior scaled by 1 + 1e-6: close to replica 0, not equal
    assert out["rmse_post"][1] != out["rmse_post"][0]
    assert out["rmse_post"][1] == pytest.approx(out["rmse_post"][0], rel=1e-3)
