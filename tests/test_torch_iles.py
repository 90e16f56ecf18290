"""Port vs JAX: the localized iterative ensemble smoother (da/update.py
`_iles_inner`, `_recompose`, `_recompose_domains`, `iles`,
`iles_domains`), float64 on the CPU.

The port forms pinv(Wi) @ S by a batched LU solve and the GN step by a
batched Cholesky solve; the JAX package iterates Ben-Israel-Cohen and
Newton-Schulz. For weights near the identity both converge to rounding in
float64 (see tests/test_torch_ies.py), so:
- one `_iles_inner` step on random (M=5, N=9, p=14) weights: 1e-10
  relative; the safeguard and a rank-deficient Wi (to `numpy.linalg.pinv`)
  are checked exactly;
- a 3-iteration `iles` and `iles_domains` slice at 16x16, N=8, nTime=10,
  dt=0.1, one forward operator at tol 1e-10: 1e-7 relative on the
  posterior and on every iteration's E, as the IES slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import historymatching_tpu as hm
import historymatching_tpu_torch as ht
from historymatching_tpu.da import localization as lj
from historymatching_tpu.da import update as uj
from historymatching_tpu.da.geostat import gaussian_fields_fft
from historymatching_tpu.parallel.runner import prod_inds
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.da import update as ut
from tests.torch_helpers import default_model, rel_err, t64

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inner_inputs(seed=3, M=5, N=9, p=14):
    rng = np.random.default_rng(seed)
    Ws = np.eye(N) + 0.1 * rng.normal(size=(M, N, N))
    Eo_w, innov = rng.normal(size=(2, N, p))
    w = rng.uniform(0, 1, size=(M, p))
    w[1, :6] = 0.0  # the cutoff zeroes some of a domain's observations
    return Ws, Eo_w, innov, w


@pytest.mark.parametrize("xStep", [0.4, 1.0])
def test_iles_inner_matches_jax(xStep):
    Ws, Eo_w, innov, w = _inner_inputs()
    ref = uj._iles_inner(*map(jnp.asarray, (Ws, Eo_w, innov)), xStep, jnp.asarray(w))
    out, n_pinv = ut._iles_inner(*map(t64, (Ws, Eo_w, innov)), xStep, t64(w))
    assert n_pinv == 0 and rel_err(out, ref) < 1e-10


def test_iles_inner_safeguard_keeps_an_exploding_domain():
    """One domain's step is not finite (a NaN in its taper row): it keeps
    its weights while the others move as without it. A step that reaches
    1e3 (innovations 1e12 times too large) keeps every domain's."""
    Ws, Eo_w, innov, w = _inner_inputs()
    out_ok, _ = ut._iles_inner(*map(t64, (Ws, Eo_w, innov)), 1.0, t64(w))
    w_bad = w.copy()
    w_bad[3, 2] = np.nan
    out, _ = ut._iles_inner(*map(t64, (Ws, Eo_w, innov)), 1.0, t64(w_bad))
    assert torch.equal(out[3], t64(Ws[3]))
    keep = [0, 1, 2, 4]
    assert torch.equal(out[keep], out_ok[keep])
    assert not torch.equal(out[keep], t64(Ws[keep]))
    out, _ = ut._iles_inner(*map(t64, (Ws, Eo_w, 1e12 * innov)), 1.0, t64(w))
    assert torch.equal(out, t64(Ws))


def test_rank_deficient_weights_go_through_pinv():
    Ws, Eo_w, innov, w = _inner_inputs()
    Ws[2, 4] = Ws[2, 7]  # two equal rows: an exact zero pivot
    S = Eo_w - Eo_w.mean(0)
    X, n = ut._pinv_times(t64(Ws), t64(S))
    assert n == 1
    assert rel_err(X[2], np.linalg.pinv(Ws[2]) @ S) < 1e-12
    assert rel_err(X[0], np.linalg.solve(Ws[0], S)) < 1e-12
    out, n_pinv = ut._iles_inner(*map(t64, (Ws, Eo_w, innov)), 0.4, t64(w))
    assert n_pinv == 1 and torch.isfinite(out).all()


def _slice_inputs():
    N, nTime, dt = 8, 10, 0.1
    m = default_model(Nx=16, Ny=16)
    k_truth, k_prior, k_noise, k_pert = jax.random.split(jax.random.PRNGKey(11), 4)
    truth = gaussian_fields_fft(k_truth, m.grid, N=1, r=0.8)[0]
    prior = gaussian_fields_fft(k_prior, m.grid, N=N, r=0.8)
    _, R12 = hm.utils.temporal_R(nTime, m.nPrd)
    p = nTime * m.nPrd
    noise = R12 @ jax.random.normal(k_noise, (p,))
    perturbs = hm.gaussian_noise(k_pert, N, p, L=jnp.asarray(R12, jnp.float32))
    _, pt = hm.forward_model(m, truth[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs = jnp.clip(pt[0].reshape(-1) + noise, 0, 1)
    fwd_j = lambda E: hm.forward_model(m, E, dt=dt, nTime=nTime, keep_wsats=False,  # noqa: E731
                                       tol=1e-10)[1].reshape(N, -1)
    mt = convert.ressim_from_reference(m, dtype=F64, device="cpu")
    fwd_t = ht.obs_ens_fn(mt, dt, nTime, tol=1e-10)
    inds = np.asarray(prod_inds(m))
    taper = lj.bump(lj.dist_to_obs(m.grid, inds, nTime=nTime) / 0.8)
    domains, taper_dom = lj.domain_partition(m.grid, inds, nTime=nTime, steps=(4, 4),
                                             radius=0.8)
    dec = uj.decorrelator(R12)
    j = (prior, obs, perturbs, dec)
    t = tuple(convert.tensor(x, dtype=F64, device="cpu") for x in j)
    return j, t, fwd_j, fwd_t, (taper, domains, taper_dom)


def test_three_iteration_iles_slices_match_jax():
    (prior, obs, pert, dec), tt, fwd_j, fwd_t, (taper, domains, taper_dom) = _slice_inputs()
    prior_t = tt[0]
    kw = dict(xStep=0.4, iMax=3)
    tap_t, dom_t, tapd_t = (convert.tensor(x, dtype=F64, device="cpu")
                            for x in (taper, domains, taper_dom))
    seen = []
    runs = [
        (hm.iles(prior, fwd_j, obs, pert, dec, taper, **kw),
         ut.iles(*tt[:1], fwd_t, *tt[1:], tap_t, callback=lambda i: seen.append(i["iter"]),
                 **kw)),
        (hm.iles_domains(prior, fwd_j, obs, pert, dec, taper_dom, domains, **kw),
         ut.iles_domains(*tt[:1], fwd_t, *tt[1:], tapd_t, dom_t.long(), **kw)),
    ]
    assert seen == [1, 2, 3]
    for (post_j, stats_j), (post_t, stats_t) in runs:
        assert post_t.shape == prior_t.shape and torch.isfinite(post_t).all()
        assert stats_t["E"].shape == (3, *prior_t.shape) and stats_t["Eo"].shape == (3, 8, 40)
        assert stats_t["pinv_domains"].tolist() == [0, 0, 0]
        assert rel_err(stats_t["E"], stats_j["E"]) < 1e-7
        assert rel_err(stats_t["Eo"], stats_j["Eo"]) < 1e-7
        assert rel_err(post_t, post_j) < 1e-7
        assert rel_err(post_t, prior_t) > 1e-2  # the iterations move the ensemble


def test_iles_domains_with_singleton_domains_is_iles():
    rng = np.random.default_rng(12)
    N, M, p = 10, 24, 6
    G = t64(rng.normal(size=(M, p)) / 5)
    E0, pert = t64(rng.normal(size=(N, M))), t64(0.1 * rng.normal(size=(N, p)))
    obs, dec = t64(rng.normal(size=p)), 10 * torch.eye(p, dtype=F64)
    taper = t64(rng.uniform(0, 1, size=(M, p)))
    fwd = lambda E: torch.tanh(E @ G)  # noqa: E731
    kw = dict(xStep=0.7, iMax=3)
    per_cell, st_c = ut.iles(E0, fwd, obs, pert, dec, taper, **kw)
    batched, st_d = ut.iles_domains(E0, fwd, obs, pert, dec, taper, torch.arange(M)[:, None],
                                    **kw)
    assert rel_err(batched, per_cell) < 1e-13 and rel_err(st_d["E"], st_c["E"]) < 1e-13
    ref, _ = uj.iles_domains(*map(jnp.asarray, (E0, )), lambda E: jnp.tanh(E @ jnp.asarray(G)),
                             *map(jnp.asarray, (obs, pert, dec, taper)),
                             jnp.arange(M)[:, None], **kw)
    assert rel_err(batched, ref) < 1e-10
