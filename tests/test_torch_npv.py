"""Port vs JAX: the NPV objective (opt/npv.py) and the control transforms
(opt/transforms.py), float64 on the CPU.

Tolerances: a batch's NPV 1e-10 relative (both sides' pressure solves
stop at the float64 tol 1e-10, with different coarse inverses); the
ledger on hand-made inputs and the transforms 1e-12 (the same float64
operations, summed in another order)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.models.ressim import SimResult as SimResult_j
from historymatching_tpu.opt import transforms as tj
from historymatching_tpu.opt.npv import NPVConfig as NPVConfig_j
from historymatching_tpu.opt.npv import accounting as accounting_j
from historymatching_tpu.opt.npv import npv_value as npv_value_j
from historymatching_tpu.opt.npv import prd_sats as prd_sats_j
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.models.ressim import SimResult
from historymatching_tpu_torch.opt import transforms as tt
from historymatching_tpu_torch.opt.npv import NPVConfig, accounting, npv_value, prd_sats
from tests.torch_helpers import default_model, perm_fields, rel_err, t64

F64 = torch.float64
NT = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(Nx=12, Ny=12):
    """A heterogeneous 12x12 version of the reference tutorial case, on
    both sides."""
    mj = default_model(Nx=Nx, Ny=Ny)
    K = 0.1 + np.exp(5 * perm_fields(11, 1, mj.Nxy, scale=0.3)[0]).reshape(Nx, Ny)
    mj = mj.replace(K=jnp.stack([K, K]))
    return mj, convert.ressim_from_reference(mj, dtype=F64, device="cpu")


def _controls():
    """Six members: injector positions (one out of the domain) and
    time-varying balanced rates, except member 5's producers, which take
    30% more than is injected."""
    xy = np.array([[1.0, 0.5], [0.3, 0.2], [1.7, 0.8], [0.05, 0.95], [9.0, 0.5], [0.6, 0.6]])
    t = np.arange(NT)
    inj = 1.0 + 0.2 * np.sin(t[None, :] + np.arange(6)[:, None])[:, None, :]  # (6, 1, NT)
    prd = np.repeat(inj / 4, 4, axis=1)
    prd[5] *= 1.3
    return xy[:, None, :], inj, prd


def test_npv_batch_matches_jax_vmap():
    mj, mt = _models()
    xy, inj, prd = _controls()
    cfg_j, cfg_t = NPVConfig_j(dt=0.025, nTime=NT), NPVConfig(dt=0.025, nTime=NT)
    vj = jax.vmap(lambda a, b, c: npv_value_j(mj, cfg_j, inj_xy=a, inj_rates=b, prd_rates=c))(
        jnp.asarray(xy), jnp.asarray(inj), jnp.asarray(prd))
    vt = npv_value(mt, cfg_t, inj_xy=t64(xy), inj_rates=t64(inj), prd_rates=t64(prd))
    assert vt.shape == (6,)
    assert rel_err(vt, vj) < 1e-10
    # the out-of-domain injector and the unbalanced member are zeroed, no other
    assert np.array_equal(vt.numpy() == 0, [False, False, False, False, True, True])
    # shared wells: a scalar, equal to member 0 of the batch
    v0 = npv_value(mt, cfg_t, inj_xy=t64(xy[0]), inj_rates=t64(inj[0]), prd_rates=t64(prd[0]))
    assert v0.shape == () and rel_err(v0, vt[0]) < 1e-12


def test_npv_gates_on_cg_ok_per_member(monkeypatch):
    """A pressure solve not accepted (cg_ok False) zeroes that member's
    value and no other's (tests/test_npv.py's gate, per member)."""
    npv_mod = sys.modules["historymatching_tpu_torch.opt.npv"]
    _, mt = _models(10, 10)
    cfg = NPVConfig(dt=0.025, nTime=4)
    xy = t64([[[1.0, 0.5]], [[0.5, 0.5]], [[1.5, 0.3]]])
    before = npv_value(mt, cfg, inj_xy=xy)
    real = npv_mod.simulate

    def failing_member_1(*a, **kw):
        r = real(*a, **kw)
        return r._replace(cg_ok=r.cg_ok & (torch.arange(r.cg_ok.shape[0]) != 1))

    monkeypatch.setattr(npv_mod, "simulate", failing_member_1)
    after = npv_value(mt, cfg, inj_xy=xy)
    assert float(after[1]) == 0.0 and float(before[1]) != 0.0
    assert torch.equal(after[[0, 2]], before[[0, 2]])
    monkeypatch.setattr(npv_mod, "simulate",
                        lambda *a, **kw: real(*a, **kw)._replace(cg_ok=torch.tensor(False)))
    assert float(npv_value(mt, cfg)) == 0.0


def test_accounting_and_prd_sats_match_jax_on_hand_made_inputs():
    """A batch of three members with their own producers, time-varying
    injection (the diffs term), zero rates (the well counts) and a total
    above rate0 (the turbo term), against JAX member by member."""
    rng = np.random.default_rng(5)
    mj, mt = _models(8, 8)
    cfg_j, cfg_t = NPVConfig_j(dt=0.1, nTime=5), NPVConfig(dt=0.1, nTime=5)
    B, n = 3, 5
    wsats = rng.uniform(size=(B, n + 1, mj.Nxy))
    prd_xy = rng.uniform([0, 0], [2, 1], size=(B, 4, 2))
    inj = rng.uniform(0.5, 1.5, size=(B, 1, n))
    inj[1, 0, 2] = 0.0
    prd = rng.uniform(0.2, 0.6, size=(B, 4, n))
    prd[0, 3] = 0.0
    prd[2] *= 2.0  # total above rate0 = 1.5
    res_t = SimResult(wsats=t64(wsats), actual_inj_rates=t64(inj), actual_prd_rates=t64(prd),
                      valid=None, cg_ok=None, cg_iters=None, substeps=None, prd_sats=None,
                      recooked=None)
    led_t = accounting(cfg_t, mt.replace(prd_xy=prd_xy), res_t)
    ps_t = prd_sats(mt.replace(prd_xy=prd_xy), t64(wsats))
    for b in range(B):
        m_b = mj.replace(prd_xy=prd_xy[b])
        res_j = SimResult_j(jnp.asarray(wsats[b]), jnp.asarray(inj[b]), jnp.asarray(prd[b]),
                            jnp.array(True), jnp.array(True), jnp.zeros(n, int), jnp.zeros(n, int))
        led_j = accounting_j(cfg_j, m_b, res_j)
        assert led_t.keys() == led_j.keys()
        for k in led_j:
            assert led_t[k].shape == (B,)
            assert abs(float(led_t[k][b]) - float(led_j[k])) <= 1e-12 * max(1.0, abs(float(led_j[k]))), k
        assert rel_err(ps_t[b], prd_sats_j(m_b, jnp.asarray(wsats[b]))) < 1e-12
    assert all(float(led_t[k][2]) != 0 for k in ("turbo", "diffs", "pwell", "iwell"))


def test_npv_config_matches_jax():
    cfg_j, cfg_t = NPVConfig_j(dt=0.05, nTime=7), NPVConfig(dt=0.05, nTime=7)
    assert cfg_t == convert.npv_config(cfg_j)
    assert (cfg_t.price_well, cfg_t.price_fixed) == (cfg_j.price_well, cfg_j.price_fixed)
    assert rel_err(cfg_t.discounts(device="cpu"), cfg_j.discounts) < 1e-15
    assert cfg_t.replace(rate0=2.0).rate0 == 2.0


def test_transforms_match_jax_with_a_batch_axis():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 4)) * 3
    assert rel_err(tt.sigmoid(t64(x), 2.0, 0.7), tj.sigmoid(jnp.asarray(x), 2.0, 0.7)) < 1e-12
    assert rel_err(tt.coordinate_transform(t64(x), 2.0, 1.0),
                   jax.vmap(lambda r: tj.coordinate_transform(r, 2.0, 1.0))(jnp.asarray(x))) < 1e-12
    pre = np.log(rng.uniform(0.02, 2.0, size=(3, 6)))
    ref = jax.vmap(lambda r: tj.rate_transform(r, 2, 3, 7))(jnp.asarray(pre))
    out = tt.rate_transform(t64(pre), 2, 3, 7)
    assert out.shape == (3, 2, 7) and rel_err(out, ref) < 1e-12
    assert bool((out == 0).any())  # some rates snapped below rate_min
    rates = rng.uniform(size=(3, 2, 5))
    assert rel_err(tt.equalize(t64(rates), 4),
                   jax.vmap(lambda r: tj.equalize(r, 4))(jnp.asarray(rates))) < 1e-12
    assert rel_err(tt.equalize(t64(rates[0, 0]), 3), tj.equalize(jnp.asarray(rates[0, 0]), 3)) < 1e-12
    inj, prd = rng.uniform(size=(3, 1, 5)), rng.uniform(size=(3, 2, 5))
    bi, bp = tt.balance_rates(t64(inj), t64(prd))
    ri, rp = jax.vmap(tj.balance_rates)(jnp.asarray(inj), jnp.asarray(prd))
    assert rel_err(bi, ri) < 1e-12 and rel_err(bp, rp) < 1e-12
    assert torch.allclose(bi.sum(-2), bp.sum(-2), rtol=1e-12)
