"""Port vs JAX: the ES analysis and ES-MDA (da/update.py), float64 on the
CPU.

- `ens_update0` in both branches (p <= N: observation space; p > N:
  ensemble space): 1e-9 relative (a Cholesky against Newton-Schulz solve
  of a well-conditioned SPD system).
- `es_mda` fed JAX's own per-pass draws, with a linear forward operator:
  1e-8 relative (two passes compound the solve difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.da import update as uj
from historymatching_tpu.utils import gaussian_noise as noise_j
from historymatching_tpu.utils import temporal_R as temporal_R_j
from historymatching_tpu_torch.da import update as ut
from historymatching_tpu_torch.utils import gaussian_noise, temporal_R
from tests.torch_helpers import rel_err, t64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("N,nTime", [(12, 2), (6, 3)])  # p = 8 <= 12; p = 12 > 6
def test_ens_update0_both_branches(N, nTime):
    rng = np.random.default_rng(N)
    M, p = 20, nTime * 4
    E = rng.normal(size=(N, M))
    Eo = rng.normal(size=(N, p))
    obs = rng.normal(size=p)
    _, R12 = temporal_R_j(nTime, 4)
    R12 = np.asarray(R12)
    pert = rng.normal(size=(N, p)) @ R12.T
    dec_j = uj.decorrelator(jnp.asarray(R12))
    dec_t = ut.decorrelator(t64(R12))
    assert rel_err(dec_t, dec_j) < 1e-12
    ref = uj.ens_update0(*map(jnp.asarray, (E, Eo, obs, pert)), dec_j)
    out = ut.ens_update0(*map(t64, (E, Eo, obs, pert)), dec_t)
    assert rel_err(out, ref) < 1e-9


def test_temporal_R_and_noise():
    R_j, R12_j = temporal_R_j(5, 4)
    R_t, R12_t = temporal_R(5, 4, device="cpu")
    assert rel_err(R_t, R_j) < 1e-15 and rel_err(R12_t, R12_j) < 1e-15
    Z = np.random.default_rng(0).normal(size=(3, 20))
    assert rel_err(gaussian_noise(3, 20, L=R12_t, Z=t64(Z)), Z @ np.asarray(R12_j).T) < 1e-15


def test_es_mda_with_jax_draws():
    rng = np.random.default_rng(11)
    N, M, nTime = 10, 6, 3
    p = 4 * nTime
    G = rng.normal(size=(M, p)) / np.sqrt(M)
    E0 = rng.normal(size=(N, M))
    obs = 0.3 * rng.normal(size=p)
    _, R12 = temporal_R_j(nTime, 4)
    alphas = uj.mda_alphas(2)
    key = jax.random.PRNGKey(5)
    ref = uj.es_mda(jnp.asarray(E0), lambda E: E @ jnp.asarray(G), jnp.asarray(obs),
                    R12, alphas, key)
    # The draws es_mda makes: split per pass, then gaussian_noise in float32.
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(noise_j(sub, N, p, L=jnp.asarray(R12, jnp.float32))))
    Gt = t64(G)
    out = ut.es_mda(t64(E0), lambda E: E @ Gt, t64(obs), t64(R12), ut.mda_alphas(2, device="cpu"),
                    noise=draws)
    assert rel_err(out, ref) < 1e-8
