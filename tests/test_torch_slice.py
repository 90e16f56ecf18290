"""The port's main path as a whole against the JAX package: prior, truth
simulation, observations and a 2-pass ES-MDA, at 16x16, N=8, nTime=10, in
float64 on the CPU. Both sides get the same prior, truth, observation
noise and per-pass perturbation draws (the JAX package's own, carried over
by `convert`).

Tolerance 1e-7 relative on the posterior: every pressure solve stops at
tol 1e-10 with a differently computed coarse inverse (Cholesky vs
Newton-Schulz), and the analysis divides by ensemble statistics of only
8 members, which amplifies the trajectories' ~1e-10 differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import historymatching_tpu as hm
import historymatching_tpu_torch as ht
from historymatching_tpu.da.geostat import gaussian_fields_fft
from historymatching_tpu_torch import convert
from tests.torch_helpers import default_model, rel_err

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_two_pass_es_mda_slice_matches_jax():
    N, nTime, dt = 8, 10, 0.025
    m = default_model(Nx=16, Ny=16)
    k_truth, k_prior, k_noise, k_mda = jax.random.split(jax.random.PRNGKey(2), 4)
    truth = gaussian_fields_fft(k_truth, m.grid, N=1, r=0.8)[0]
    prior = gaussian_fields_fft(k_prior, m.grid, N=N, r=0.8)
    _, R12 = hm.utils.temporal_R(nTime, m.nPrd)
    noise = R12 @ jax.random.normal(k_noise, (nTime * m.nPrd,))

    # JAX reference
    _, pt = hm.forward_model(m, truth[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs_j = jnp.clip(pt[0].reshape(-1) + noise, 0, 1)

    def fwd_j(E):
        return hm.forward_model(m, E, dt=dt, nTime=nTime, keep_wsats=False)[1].reshape(N, -1)

    post_j = hm.es_mda(prior, fwd_j, obs_j, R12, hm.mda_alphas(2), k_mda)

    # The draws es_mda made, per pass.
    draws, key = [], k_mda
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(np.array(hm.gaussian_noise(sub, N, nTime * m.nPrd,
                                                L=jnp.asarray(R12, jnp.float32))))

    # The port, on the same inputs.
    mt = convert.ressim_from_reference(m, dtype=F64, device="cpu")
    truth_t, prior_t, noise_t, R12_t = (convert.tensor(x, dtype=F64, device="cpu")
                                        for x in (truth, prior, noise, R12))
    _, pt_t = ht.forward_model(mt, truth_t[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs_t = torch.clamp(pt_t[0].reshape(-1) + noise_t, 0, 1)
    assert rel_err(obs_t, obs_j) < 1e-9
    fwd_t = ht.obs_ens_fn(mt, dt, nTime)
    alphas_t = ht.mda_alphas(2, dtype=F64, device="cpu")
    post_t = ht.es_mda(prior_t, fwd_t, obs_t, R12_t, alphas_t, noise=draws)

    assert post_t.shape == (N, m.Nxy) and torch.isfinite(post_t).all()
    assert rel_err(post_t, post_j) < 1e-7
