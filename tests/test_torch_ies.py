"""Port vs JAX: the iterative ensemble smoother (da/update.py `_gn_covw`,
`_ies_inner`, `ies`), float64 on the CPU.

The port's pseudo-inverse is `torch.linalg.pinv` (an SVD); the JAX
package's is 24 Ben-Israel-Cohen iterations from X0 = W' / b. For a
weight matrix near the identity (IES starts at I) that iteration has
converged to rounding well before its 24th step in float64, so the two
agree to ~1e-14 and the tolerances are those of the SPD solves (Cholesky
against Newton-Schulz):
- `_gn_covw` 1e-12 and one `_ies_inner` step 1e-10 relative;
- a 3-iteration IES at 16x16, N=8, nTime=10 with a list of three forward
  operators: 1e-7 relative on the posterior and on every iteration's
  ensemble, for the reason tests/test_torch_slice.py gives (solves at
  tol 1e-10 with differently computed coarse inverses, statistics of 8
  members). Steps of dt=0.1 bring water to the producers, so the
  iterations move the ensemble.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import historymatching_tpu as hm
import historymatching_tpu_torch as ht
from historymatching_tpu.da import update as uj
from historymatching_tpu.da.geostat import gaussian_fields_fft
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.da import update as ut
from tests.torch_helpers import default_model, rel_err, t64

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_gn_covw_and_inner_step_match_jax():
    rng = np.random.default_rng(8)
    N, p = 9, 14
    Y0 = rng.normal(size=(N, p))
    assert rel_err(ut._gn_covw(t64(Y0), N), uj._gn_covw(jnp.asarray(Y0), N)) < 1e-12
    W = np.eye(N) + 0.1 * rng.normal(size=(N, N))
    Eo_w, D_w = rng.normal(size=(2, N, p))
    y_w = rng.normal(size=p)
    for xStep in (0.4, 1.0):
        ref = uj._ies_inner(*map(jnp.asarray, (W, Eo_w, y_w, D_w)), xStep)
        out = ut._ies_inner(*map(t64, (W, Eo_w, y_w, D_w)), xStep)
        assert rel_err(out, ref) < 1e-10
    # The safeguard: a step that explodes keeps the previous weights.
    for y_bad in (1e12 * y_w, np.where(np.arange(p) == 3, np.nan, y_w)):
        assert torch.equal(ut._ies_inner(t64(W), t64(Eo_w), t64(y_bad), t64(D_w), 1.0), t64(W))


def test_three_iteration_ies_slice_matches_jax():
    N, nTime, dt, iMax, xStep = 8, 10, 0.1, 3, 0.4
    m = default_model(Nx=16, Ny=16)
    k_truth, k_prior, k_noise, k_pert = jax.random.split(jax.random.PRNGKey(6), 4)
    truth = gaussian_fields_fft(k_truth, m.grid, N=1, r=0.8)[0]
    prior = gaussian_fields_fft(k_prior, m.grid, N=N, r=0.8)
    _, R12 = hm.utils.temporal_R(nTime, m.nPrd)
    p = nTime * m.nPrd
    noise = R12 @ jax.random.normal(k_noise, (p,))
    perturbs = hm.gaussian_noise(k_pert, N, p, L=jnp.asarray(R12, jnp.float32))
    # One forward operator an iteration: the last solves tighter.
    tols = (1e-9, 1e-9, 1e-10)

    _, pt = hm.forward_model(m, truth[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs_j = jnp.clip(pt[0].reshape(-1) + noise, 0, 1)

    def fwd_j(tol):
        return lambda E: hm.forward_model(m, E, dt=dt, nTime=nTime, keep_wsats=False,
                                          tol=tol)[1].reshape(N, -1)

    dec_j = uj.decorrelator(R12)
    post_j, stats_j = hm.ies(prior, [fwd_j(t) for t in tols], obs_j, perturbs, dec_j,
                             xStep=xStep, iMax=iMax)

    mt = convert.ressim_from_reference(m, dtype=F64, device="cpu")
    truth_t, prior_t, noise_t, R12_t, pert_t = (
        convert.tensor(x, dtype=F64, device="cpu") for x in (truth, prior, noise, R12, perturbs))
    _, pt_t = ht.forward_model(mt, truth_t[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs_t = torch.clamp(pt_t[0].reshape(-1) + noise_t, 0, 1)
    seen = []
    post_t, stats_t = ht.ies(prior_t, [ht.obs_ens_fn(mt, dt, nTime, tol=t) for t in tols],
                             obs_t, pert_t, ut.decorrelator(R12_t), xStep=xStep, iMax=iMax,
                             callback=lambda info: seen.append(info["iter"]))

    assert seen == [1, 2, 3]
    assert post_t.shape == (N, m.Nxy) and torch.isfinite(post_t).all()
    assert stats_t["E"].shape == (iMax, N, m.Nxy) and stats_t["Eo"].shape == (iMax, N, p)
    assert rel_err(stats_t["E"], stats_j["E"]) < 1e-7
    assert rel_err(post_t, post_j) < 1e-7
    assert rel_err(post_t, prior_t) > 1e-2  # the iterations move the ensemble
    with pytest.raises(ValueError):
        ht.ies(prior_t, [ht.obs_ens_fn(mt, dt, nTime)] * 2, obs_t, pert_t,
               ut.decorrelator(R12_t), iMax=3)
