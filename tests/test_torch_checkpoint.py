"""The port's checkpoints, ES-MDA resume and profiling
(historymatching_tpu_torch/checkpoint.py, da/update.py `es_mda(callback=,
start_pass=)`, profiling.py), on the CPU.

- A state of tensors, NumPy arrays, nested containers, scalars, None, a
  generator state and a `SimResult` round-trips with its structure and
  bytes; the format is the JAX package's, so a file that package writes
  loads in the port and the reverse.
- ES-MDA killed after pass 2, checkpointed from its callback, loaded and
  resumed at start_pass=2 with the restored generator: the posterior
  equals the uninterrupted run's bit for bit (the JAX package's
  tests/test_aux.py::test_es_mda_resume_bitmatch).
- `profiling.trace` / `parse_trace` on a CPU trace find the named ops;
  `timed` returns (best, first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import historymatching_tpu_torch as ht
from historymatching_tpu import checkpoint as ckpt_j
from historymatching_tpu.models.ressim import SimResult as SimResult_j
from historymatching_tpu_torch import checkpoint, profiling
from historymatching_tpu_torch.models.ressim import SimResult

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state():
    g = torch.Generator().manual_seed(5)
    torch.randn(3, generator=g)
    res = SimResult(wsats=torch.linspace(0, 1, 12).reshape(3, 4),
                    actual_inj_rates=torch.ones(1, 3), actual_prd_rates=torch.ones(2, 3) / 2,
                    valid=torch.tensor(True), cg_ok=torch.tensor(True),
                    cg_iters=torch.arange(3, dtype=torch.int32), substeps=torch.arange(3) + 1,
                    prd_sats=torch.zeros(3, 2), recooked=torch.zeros(3, dtype=torch.bool))
    return {"result": res,
            "ensembles": [torch.arange(6.0, dtype=F64).reshape(2, 3), np.ones(4, np.float32)],
            "generator": g.get_state(),
            "meta": {"pass": 2, "alpha": 4.0, "label": "mda", "done": False, "extra": None,
                     "pair": (1, 2.5)}}


def test_checkpoint_round_trip(tmp_path):
    state = _state()
    path = checkpoint.save_checkpoint(str(tmp_path / "c.npz"), state)
    back = checkpoint.load_checkpoint(path)
    res = back["result"]
    assert isinstance(res, SimResult) and res.pressures == ()
    for f in ("wsats", "cg_iters", "recooked", "valid"):
        a = getattr(state["result"], f).numpy()
        assert np.array_equal(getattr(res, f), a) and getattr(res, f).dtype == a.dtype
    assert isinstance(back["ensembles"], list) and back["ensembles"][0].dtype == np.float64
    assert back["meta"] == state["meta"] and isinstance(back["meta"]["pair"], tuple)
    g = torch.Generator()
    g.set_state(torch.from_numpy(back["generator"]))
    ref = torch.Generator()
    ref.set_state(state["generator"])
    assert torch.equal(torch.randn(4, generator=g), torch.randn(4, generator=ref))
    with pytest.raises(TypeError, match="unregistered"):
        from collections import namedtuple

        checkpoint.save_checkpoint(str(tmp_path / "x.npz"), {"a": namedtuple("Odd", "x")(1)})


def test_checkpoint_files_cross_between_packages(tmp_path):
    """The same format: a file of the JAX package loads in the port (its
    SimResult as the port's, fields in the same order) and a file of the
    port loads in the JAX package."""
    res_j = SimResult_j(wsats=jnp.linspace(0, 1, 12).reshape(3, 4),
                        actual_inj_rates=jnp.ones((1, 3)), actual_prd_rates=jnp.ones((2, 3)) / 2,
                        valid=jnp.asarray(True), cg_ok=jnp.asarray(True),
                        cg_iters=jnp.arange(3), substeps=jnp.arange(3) + 1,
                        prd_sats=jnp.zeros((3, 2)))
    state_j = {"result": res_j, "key": jax.random.PRNGKey(3), "E": [np.arange(6.0)],
               "meta": {"pass": 2, "extra": None, "pair": (1, 2.5)}}
    ckpt_j.save_checkpoint(str(tmp_path / "j.npz"), state_j)
    back = checkpoint.load_checkpoint(str(tmp_path / "j.npz"))
    assert isinstance(back["result"], SimResult) and back["result"].recooked == ()
    assert np.array_equal(back["result"].prd_sats, np.zeros((3, 2)))
    assert np.array_equal(back["result"].cg_iters, np.arange(3))
    assert np.array_equal(back["key"], np.asarray(state_j["key"]))
    assert back["meta"] == state_j["meta"] and np.array_equal(back["E"][0], np.arange(6.0))

    state_t = {k: v for k, v in _state().items() if k != "result"}
    checkpoint.save_checkpoint(str(tmp_path / "t.npz"), state_t)
    back = ckpt_j.load_checkpoint(str(tmp_path / "t.npz"))
    assert np.array_equal(back["generator"], state_t["generator"].numpy())
    assert np.array_equal(back["ensembles"][0], state_t["ensembles"][0].numpy())
    assert back["meta"] == state_t["meta"]


def _linear_mda(seed=0, N=24, M=40, p=8):
    g = torch.Generator().manual_seed(seed)
    H = torch.randn(M, p, generator=g, dtype=F64) / np.sqrt(M)
    prior = torch.randn(N, M, generator=g, dtype=F64)
    obs = torch.randn(p, generator=g, dtype=F64)
    return prior, (lambda E: E @ H), obs, 0.3 * torch.eye(p, dtype=F64)


def test_es_mda_resume_through_a_checkpoint_is_bitwise(tmp_path):
    prior, fwd, obs, R12 = _linear_mda()
    alphas = ht.mda_alphas(4, dtype=F64, device="cpu")
    ref = ht.es_mda(prior, fwd, obs, R12, alphas, generator=torch.Generator().manual_seed(7))

    path = str(tmp_path / "mda.npz")
    seen = []

    class Killed(Exception):
        pass

    def cb(info):
        seen.append((info["pass_"], info["n_passes"], info["alpha"]))
        assert info["elapsed_s"] >= 0 and info["E"].shape == prior.shape
        if info["pass_"] == 2:
            checkpoint.save_checkpoint(path, {"E": info["E"], "pass": info["pass_"],
                                              "gen": info["generator_state"]})
            raise Killed

    with pytest.raises(Killed):
        ht.es_mda(prior, fwd, obs, R12, alphas, generator=torch.Generator().manual_seed(7),
                  callback=cb)
    assert seen == [(1, 4, 4.0), (2, 4, 4.0)]
    st = checkpoint.load_checkpoint(path)
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(st["gen"]))
    post = ht.es_mda(torch.from_numpy(st["E"]), fwd, obs, R12, alphas, generator=gen,
                     start_pass=st["pass"])
    assert torch.equal(post, ref)
    # With the draws given, the callback carries no generator state.
    noise = [torch.randn(24, 8, generator=torch.Generator().manual_seed(i), dtype=F64)
             for i in range(4)]
    states = []
    full = ht.es_mda(prior, fwd, obs, R12, alphas, noise=noise,
                     callback=lambda i: states.append((i["generator_state"], i["E"])))
    assert [s for s, _ in states] == [None] * 4
    part = ht.es_mda(states[1][1], fwd, obs, R12, alphas, noise=noise, start_pass=2)
    assert torch.equal(part, full)


def test_profiling_trace_and_timed(tmp_path):
    a = torch.randn(32, 32, dtype=F64)
    with profiling.trace(str(tmp_path)) as logdir:
        (a @ a).sum()
    totals = profiling.parse_trace(logdir)
    assert totals.host.get("aten::mm", 0.0) > 0 and totals.host.get("aten::sum", 0.0) > 0
    assert totals.device == {} and totals.device_count == {}  # no card on this host
    with pytest.raises(FileNotFoundError):
        profiling.parse_trace(str(tmp_path / "empty"))
    best, first = profiling.timed(lambda x: x @ x, a, repeats=2)
    assert 0 < best and 0 < first
