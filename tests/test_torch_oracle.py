"""The exact float64 oracle of the port (`models.oracle`, `ops.banded`)
against the JAX package's (`historymatching_tpu/models/oracle.py`) on the
CPU, in float64. Inputs are NumPy draws from a seed given to both.

Tolerances, and why:
- the band storage is built by the same assignments: equal, exactly;
- its matvec against the stencil's: 1e-13 relative (sums of 5 terms in
  another order);
- the plain banded Cholesky against LAPACK (`scipy.linalg.solveh_banded`):
  1e-12 relative (max|dp| / max|p|) on pinned TPFA bands of fields drawn
  at the tests' usual scale (condition numbers ~1e6). Both are backward
  stable, and LAPACK's products are fused; their gap grows with the
  condition number (measured 1e-11 at 64x64 on fields of scale 1);
- the forward run: 1e-10 absolute on the final saturations and the
  productions after 12 steps. Fields of scale 1 (permeabilities over
  e^+-10) differ between the packages by 2e-12 to 5e-12, as much as the
  port moves under a 1e-15 scaling of its own prior;
- ES-MDA's posterior: 1e-9 absolute, on the same per-pass draws (the JAX
  package's own, replayed as `es_mda(noise=)`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import solveh_banded

from historymatching_tpu.da import update as update_j
from historymatching_tpu.models import oracle as oracle_j
from historymatching_tpu.models.ressim import relperm as relperm_j
from historymatching_tpu.ops.stencil import stencil_diag as stencil_diag_j
from historymatching_tpu.ops.stencil import transmissibilities as transmissibilities_j
from historymatching_tpu.parallel.runner import perm_transf as perm_transf_j
from historymatching_tpu.utils import gaussian_noise as gaussian_noise_j
from historymatching_tpu.utils import temporal_R as temporal_R_j
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.da.update import es_mda, mda_alphas
from historymatching_tpu_torch.models import oracle as oracle_t
from historymatching_tpu_torch.ops import banded
from historymatching_tpu_torch.ops.stencil import stencil_matvec
from historymatching_tpu_torch.parallel.runner import perm_transf
from tests.torch_helpers import default_model, perm_fields, rel_err, t64

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bands(shape, N, seed, scale=0.5):
    """N members' pinned TPFA faces and diagonals, from the JAX package's
    functions on NumPy fields: (TX, TY, diag) as (N, ...) NumPy arrays."""
    rng = np.random.default_rng(seed)
    m = default_model(*shape)
    out = []
    for _ in range(N):
        K = 0.1 + np.exp(5.0 * scale * rng.normal(size=(2, *shape)))
        Mw, Mo = relperm_j(jnp.asarray(rng.uniform(0.0, 1.0, shape)), m.fluid)
        TX, TY = transmissibilities_j(K[0] * (Mw + Mo), K[1] * (Mw + Mo), m.grid.hx, m.grid.hy)
        out.append((TX, TY, stencil_diag_j(TX, TY)))
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(3)]


def _model(m):
    return convert.ressim_from_reference(m, dtype=F64, device="cpu")


@pytest.mark.parametrize("shape", [(12, 9), (16, 16)])
def test_banded_operator_equals_jax(shape):
    TX, TY, diag = _bands(shape, 3, seed=1)
    ab_t = oracle_t.banded_operator(t64(TX), t64(TY), t64(diag))  # batched
    assert ab_t.shape == (3, shape[1] + 1, shape[0] * shape[1])
    for i in range(3):
        ab_j = np.asarray(oracle_j.banded_operator(TX[i], TY[i], diag[i]))
        np.testing.assert_array_equal(ab_t[i].numpy(), ab_j)
        np.testing.assert_array_equal(
            oracle_t.banded_operator(t64(TX[i]), t64(TY[i]), t64(diag[i])).numpy(), ab_j)


@pytest.mark.parametrize("shape", [(12, 9), (16, 16)])
def test_banded_matvec_equals_stencil_matvec(shape):
    TX, TY, diag = _bands(shape, 3, seed=2, scale=1.0)
    ab = oracle_t.banded_operator(t64(TX), t64(TY), t64(diag))
    x = np.random.default_rng(3).normal(size=(3, *shape))
    y_band = oracle_t.banded_matvec(ab, t64(x))
    y_sten = stencil_matvec(t64(TX), t64(TY), t64(diag), t64(x)).reshape(3, -1)
    assert rel_err(y_band, y_sten) < 1e-13
    for i in range(3):  # the JAX package's NumPy helper, one member
        assert rel_err(y_band[i], oracle_j.banded_matvec(ab[i].numpy(), x[i])) < 1e-13


@pytest.mark.parametrize("shape", [(12, 9), (16, 16)])
def test_banded_solve_matches_solveh_banded(shape):
    TX, TY, diag = _bands(shape, 3, seed=4)
    ab = oracle_t.banded_operator(t64(TX), t64(TY), t64(diag))
    q = np.random.default_rng(5).normal(size=(3, shape[0] * shape[1]))
    q -= q.mean(axis=1, keepdims=True)  # balanced sources
    p = banded.banded_solve(ab, t64(q))  # the CPU dispatch: the plain version
    for i in range(3):
        ref = solveh_banded(ab[i].numpy(), q[i], lower=False)
        assert rel_err(p[i], ref) < 1e-12
        r = q[i] - oracle_t.banded_matvec(ab[i], p[i]).numpy()
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(q[i])


def test_non_spd_member_raises():
    TX, TY, diag = _bands((12, 9), 3, seed=6)
    diag[1, 3, 4] = -1.0  # member 1 loses definiteness at column 3*9+4
    ab = oracle_t.banded_operator(t64(TX), t64(TY), t64(diag))
    q = t64(np.ones((3, 108)))
    with pytest.raises(torch.linalg.LinAlgError, match=r"members \[1\]"):
        banded.banded_solve(ab, q)
    with pytest.raises(np.linalg.LinAlgError):  # as LAPACK does
        solveh_banded(ab[1].numpy(), q[1].numpy(), lower=False)
    with pytest.raises(ValueError, match="float64"):
        banded.banded_solve_torch(ab.float(), q.float())


def test_forward_oracle_matches_jax():
    m = default_model(Nx=16, Ny=16)
    prior = perm_fields(7, 4, m.Nxy, scale=1.0)
    last_j, prods_j = oracle_j.forward_oracle(m, prior, dt=0.025, nTime=12)
    last_t, prods_t = oracle_t.forward_oracle(_model(m), t64(prior), dt=0.025, nTime=12,
                                              tol=1e-3, maxiter=5)  # ignored, as JAX's
    assert last_t.shape == (4, 1, m.Nxy) and prods_t.shape == (4, 12, m.nPrd)
    assert last_t.dtype == F64
    assert np.abs(last_t.numpy() - np.asarray(last_j)).max() <= 1e-10
    assert np.abs(prods_t.numpy() - np.asarray(prods_j)).max() <= 1e-10
    assert float(prods_t.max()) > 0.05  # water reached the producers


@pytest.mark.parametrize("case", ["keep_wsats_restart", "transf"])
def test_forward_oracle_options_match_jax(case):
    """keep_wsats and restart (tests/test_oracle.py:90), and `transf`
    (:111), each against the JAX oracle on the same case."""
    m = default_model(Nx=16, Ny=16)
    mt = _model(m)
    if case == "transf":
        x = np.zeros((1, m.Nxy))
        _, prods_id = oracle_t.forward_oracle(mt, t64(x), dt=0.025, nTime=3,
                                              transf=lambda v: perm_transf(v))
        _, prods_def = oracle_t.forward_oracle(mt, t64(x), dt=0.025, nTime=3)
        np.testing.assert_array_equal(prods_id.numpy(), prods_def.numpy())
        prior = perm_fields(8, 2, m.Nxy)
        _, p_t = oracle_t.forward_oracle(mt, t64(prior), dt=0.025, nTime=6,
                                         transf=lambda v: perm_transf(2.0 * v))
        _, p_j = oracle_j.forward_oracle(m, prior, dt=0.025, nTime=6,
                                         transf=lambda v: perm_transf_j(2.0 * v))
        assert np.abs(p_t.numpy() - np.asarray(p_j)).max() <= 1e-10
        return
    prior = perm_fields(9, 3, m.Nxy)
    wsats, prods = oracle_t.forward_oracle(mt, t64(prior), dt=0.025, nTime=8, keep_wsats=True)
    assert wsats.shape == (3, 9, m.Nxy)
    np.testing.assert_array_equal(wsats[:, 0].numpy(), 0.0)
    wsats_j, _ = oracle_j.forward_oracle(m, prior, dt=0.025, nTime=8, keep_wsats=True)
    assert np.abs(wsats.numpy() - np.asarray(wsats_j)).max() <= 1e-10
    last_a, _ = oracle_t.forward_oracle(mt, t64(prior), dt=0.025, nTime=4)
    last_b, prods_b = oracle_t.forward_oracle(mt, t64(prior), wsat0=last_a[:, 0], dt=0.025,
                                              nTime=4)
    np.testing.assert_allclose(prods_b.numpy(), prods[:, 4:].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(last_b[:, 0].numpy(), wsats[:, -1].numpy(), rtol=0, atol=1e-12)


def test_es_mda_through_both_oracles():
    N, nTime, dt, passes = 8, 10, 0.1, 4
    m = default_model(Nx=16, Ny=16)
    rng = np.random.default_rng(10)
    truth, prior = perm_fields(11, 1, m.Nxy)[0], perm_fields(12, N, m.Nxy)
    _, R12 = temporal_R_j(nTime, m.nPrd)
    noise = np.asarray(R12) @ rng.normal(size=nTime * m.nPrd)
    _, pt = oracle_j.forward_oracle(m, truth[None], dt=dt, nTime=nTime)
    obs = np.clip(np.asarray(pt[0]).reshape(-1) + noise, 0, 1)
    key = jax.random.PRNGKey(13)

    def fwd_j(E):
        return oracle_j.forward_oracle(m, E, dt=dt, nTime=nTime)[1].reshape(N, -1)

    post_j = update_j.es_mda(jnp.asarray(prior), fwd_j, jnp.asarray(obs), R12,
                             update_j.mda_alphas(passes), key)
    draws, k = [], key  # the draws es_mda made, per pass
    for _ in range(passes):
        k, sub = jax.random.split(k)
        draws.append(np.array(gaussian_noise_j(sub, N, nTime * m.nPrd,
                                               L=jnp.asarray(R12, jnp.float32))))

    mt = _model(m)

    def fwd_t(E):
        return oracle_t.forward_oracle(mt, E, dt=dt, nTime=nTime)[1].reshape(N, -1)

    post_t = es_mda(t64(prior), fwd_t, t64(obs), t64(R12),
                    mda_alphas(passes, dtype=F64, device="cpu"), noise=draws)
    assert post_t.shape == (N, m.Nxy) and post_t.dtype == F64
    assert np.abs(post_t.numpy() - np.asarray(post_j)).max() <= 1e-9
    assert np.abs(post_t.numpy() - prior).max() > 1e-2  # the data moved it


@pytest.mark.parametrize("method", ["es_mda", "ies"])
def test_parity_oracle_case_matches_jax_bench(monkeypatch, method):
    """`parity.run_case(oracle=True)`, the path `bench_gpu.py --oracle` runs,
    against `bench.run_case(oracle=True)` / `bench.run_ies_case(oracle=True)`,
    the path that wrote the committed refs, on the same seed's draws (the
    port's, given to both, as tests/test_torch_parity.py does: they are
    held to `bench.build_case`'s within float32 rounding by
    tests/test_torch_prng.py): the prior RMSE to 1e-12 relative, the
    posterior's to 1e-9. Steps of dt=0.1 (both sides) bring water to the
    producers in 8 steps."""
    import bench
    from historymatching_tpu_torch import parity

    monkeypatch.setattr(bench, "DT", 0.1)
    monkeypatch.setattr(parity, "DT", 0.1)

    def build_case(seed, N, Nx=64, Ny=64, nTime=40):
        case = parity.build_case(seed, N, Nx, Ny, nTime, device="cpu")
        arrays = {k: jnp.asarray(case[k].numpy()) for k in ("truth", "prior", "noise", "R12")}
        return dict(case, **arrays, model=bench.build_model(Nx, Ny),
                    key_mda=jnp.asarray(case["key_mda"].numpy().astype(np.uint32)))

    monkeypatch.setattr(bench, "build_case", build_case)
    seed, N, n, nTime = 2, 8, 16, 8
    if method == "ies":
        ref = bench.run_ies_case(seed, N, n, n, nTime, dtype=jnp.float64, iMax=2, oracle=True)
    else:
        ref = bench.run_case(seed, N, n, n, nTime, dtype=jnp.float64, timed=False, oracle=True)
    out = parity.run_case(method, seed, N, n, n, nTime, sched=[{}] * (2 if method == "ies" else 4),
                          dtype=F64, device="cpu", oracle=True)
    assert out["rmse_prior"] == pytest.approx(ref["rmse_prior"], rel=1e-12)
    assert out["rmse_post"][0] == pytest.approx(ref["rmse_post"], rel=1e-9)
    assert abs(out["rmse_post"][0] - out["rmse_prior"]) > 1e-3  # the data moved it
    with pytest.raises(ValueError, match="float64"):
        parity.run_case(method, seed, N, n, n, nTime, dtype=torch.float32, device="cpu",
                        oracle=True)


def test_kernel_constants_and_plan():
    """The wrapper's layout constants are the CUDA source's; every band
    width the wrapper takes fits the kernel's pair packing (kd + 1 <= 208)
    and one block's shared memory, and its threads hold every pair."""
    import os
    import re

    from historymatching_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "banded_cholesky.cu")) as f:
        text = f.read()

    def num(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (num("kStages"), num("kChunk")) == (banded.STAGES, banded.CHUNK)
    assert num("kBack") * 208 <= banded.STAGES * 209 * banded.CHUNK  # its ring fits the stages'
    kd_max = banded.max_kd()
    assert kd_max + 1 <= 208 and banded.smem_bytes(kd_max) <= _build.SMEM_LIMIT
    assert banded.smem_bytes(kd_max + 1) > _build.SMEM_LIMIT
    for kd in (1, 9, 16, 64, 165, kd_max):
        per, threads = banded.launch_plan(kd)
        assert per in (16, 32) and threads % 32 == 0 and threads <= 1024
        assert per * threads >= (kd + 1) * (kd + 2) // 2
    assert banded.launch_plan(64) == (16, 160) and banded.smem_bytes(64) == 35_112
    import bench_routes  # its cut copies of the source (`--kernel banded`) still apply

    assert bench_routes._BACK_CUT[0] in text and bench_routes._banded_update_cut(text)[0]
    assert "banded_cholesky" in _build.LAUNCHES and "banded_cholesky" in _build._MAIN


def test_cuda_wrapper_refuses_what_it_does_not_take():
    """The kernel's wrapper takes float64 CUDA tensors alone (no CPU
    fallback) and refuses bands past one block's window."""
    ab, q = torch.ones(2, 3, 8, dtype=F64), torch.ones(2, 8, dtype=F64)
    with pytest.raises(ValueError, match="CUDA"):
        banded.banded_solve_cuda(ab, q)
    if torch.cuda.is_available():  # the card's own refusals
        with pytest.raises(ValueError, match="float64"):
            banded.banded_solve_cuda(ab.float().cuda(), q.float().cuda())
        kd = banded.max_kd() + 1
        with pytest.raises(ValueError, match="outside"):
            banded.banded_solve_cuda(torch.ones(1, kd + 1, 400, dtype=F64, device="cuda"),
                                     torch.ones(1, 400, dtype=F64, device="cuda"))


def test_background_build_starts_then_waits(monkeypatch, tmp_path):
    """`prebuild(wait=False)` builds the main libraries and starts the
    others' compilers in the background, `start`'s few at a time; `_load`
    then waits for a started compiler instead of starting another."""
    import threading

    from historymatching_tpu_torch.ops import _build

    started, running, most = [], [0], [0]
    lock, gate = threading.Lock(), threading.Event()

    def compile_(stem, flags, so):
        with lock:
            started.append(os.path.basename(so))
            running[0] += 1
            most[0] = max(most[0], running[0])

        def finish():
            if os.path.basename(so)[3:-3] not in _build._MAIN:
                gate.wait(10)
            with lock:
                running[0] -= 1
            return so, str(tmp_path / "lib.so.tmp"), 0, "ptxas report"

        return finish

    def spec(stem, grid=None, key=None, flags=None, sigs=None):
        key = key or (stem if grid is None else f"{stem}_{grid[0]}x{grid[1]}")
        return key, stem, [], str(tmp_path / f"lib{key}.so"), sigs or stem

    for name, value in (("BUILD_DIR", str(tmp_path)), ("_compile", compile_), ("_pending", {}),
                        ("_done", {}), ("_libs", {}), ("_spec", spec)):
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setattr(_build.os, "replace", lambda a, b: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda so: None)
    monkeypatch.setattr(_build, "_SIGNATURES", {k: {} for k in _build._SIGNATURES})
    grids = [(8, 8), (10, 10), (12, 12), (24, 16), (80, 80)]
    _build.prebuild(pressure_grids=grids, wait=False)
    assert set(_build._MAIN) <= set(_build._libs)  # the main libraries: built and loaded
    others = {f"pressure_pcg_{g[0]}x{g[1]}" for g in grids}
    assert set(_build._pending) == others and not others & set(_build._libs)
    for _ in range(200):  # the background threads take their slots
        if len(started) >= len(_build._MAIN) + 3:
            break
        gate.wait(0.01)
    assert len(started) == len(_build._MAIN) + 3  # 3 compilers at a time
    gate.set()
    _build._load([spec("pressure_pcg", g) for g in grids])
    assert others <= set(_build._libs) and not _build._pending
    assert len(started) == len(_build._MAIN) + len(grids) and most[0] <= len(_build._MAIN) + 3
    assert _build.build_info["ptxas"]["pressure_pcg_8x8"] == "ptxas report"


def test_committed_oracle_record():
    """`parity/ORACLE_GPU.json` (written on the card by `bench_gpu.py
    --oracle`) covers every seed of every committed ref, names the card and
    its power limit, drew each seed's inputs within `PRIOR_RTOL` of the
    ref's, and its gaps, exceptions and verdicts follow from its numbers."""
    import json
    import os

    from historymatching_tpu_torch import parity

    with open(os.path.join(parity.REFS_DIR, "ORACLE_GPU.json")) as f:
        rec = json.load(f)
    want = {(name, s) for name, ref_file, _ in parity.RUNGS
            for s in parity.load_ref(ref_file)["seeds"]}
    assert {(r["rung"], r["seed"]) for r in rec["rows"]} == want and rec["seeds"] == 38
    assert "H100" in rec["card"] and " W" in rec["card"] and rec["dtype"] == "float64"
    assert rec["launches"]["banded_cholesky"] > 0
    for r in rec["rows"]:
        row = {x["seed"]: x for x in parity.load_ref(r["refs"])["rows"]}[r["seed"]]
        assert (r["rmse_prior_ref"], r["rmse_post_ref"]) == (row["rmse_prior"], row["rmse_post"])
        assert r["prior_rel_gap"] == pytest.approx(
            abs(r["rmse_prior"] - row["rmse_prior"]) / row["rmse_prior"], rel=1e-12)
        assert r["prior_rel_gap"] <= parity.PRIOR_RTOL
        post_ok = r["post_rel_gap"] <= parity.ORACLE_RTOL
        spread_ok = r["method"] == "ies" and (abs(r["rmse_post"] - row["rmse_post"])
                                              <= max(abs(x - r["rmse_post"])
                                                     for x in r["rmse_post_perturbed"]))
        assert r["ok"] == (post_ok or spread_ok) and ("exception" in r) == (spread_ok and not post_ok)
    assert rec["ok"] == all(r["ok"] for r in rec["rows"])
