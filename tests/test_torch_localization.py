"""Port vs JAX: localization (da/localization.py) and the localized ES
updates (da/update.py), float64 on the CPU.

- `pairwise_distances` (plain and periodic), `bump`, `dist_to_obs`,
  `domain_partition` and `rectangular_partitioning`: 1e-14 relative, the
  index sets equal.
- `ens_update0_loc` and `ens_update0_loc_domains` in both branches
  (p <= N: observation space; p > N: ensemble space): 1e-10 relative (a
  Cholesky against a Newton-Schulz solve of well-conditioned SPD systems).
- A 2-pass localized ES-MDA slice at 16x16, N=8, nTime=10, 4x4-cell
  domains, radius 1.2, as tests/test_torch_slice.py runs the plain one:
  1e-7 relative on the posterior, for the reason given there. Steps of
  dt=0.1 inject 1 pore volume, so water reaches the producers and the
  analysis moves the ensemble (at dt=0.025 the production is ~1e-6 and
  the update nearly nil).
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
from historymatching_tpu_torch.da import localization as lt
from historymatching_tpu_torch.da import update as ut
from tests.torch_helpers import default_model, rel_err, t64

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_distances_tapers_and_partitions_match_jax():
    rng = np.random.default_rng(1)
    A, B = rng.uniform(0, 2, size=(7, 2)), rng.uniform(0, 2, size=(5, 2))
    for dom in (None, (2.0, 1.5)):
        assert rel_err(lt.pairwise_distances(A, B, domain=dom, device="cpu"),
                       lj.pairwise_distances(A, B, domain=dom)) < 1e-14
    assert rel_err(lt.pairwise_distances(t64(A)), lj.pairwise_distances(A)) < 1e-14
    x = np.linspace(-1.5, 1.5, 61)
    for sharp in (0.5, 1, 3):
        assert rel_err(lt.bump(t64(x), sharp), lj.bump(jnp.asarray(x), sharp)) < 1e-14

    m = default_model(Nx=16, Ny=16)
    g = ht.Grid2D(Nx=16, Ny=16, Lx=m.Lx, Ly=m.Ly)
    inds = np.asarray(prod_inds(m))
    assert rel_err(lt.dist_to_obs(g, inds, nTime=3, device="cpu"),
                   lj.dist_to_obs(m.grid, inds, nTime=3)) < 1e-14
    for steps in ((4, 4), (8, 2)):
        d_t, t_t = lt.domain_partition(g, inds, nTime=3, steps=steps, radius=1.2, device="cpu")
        d_j, t_j = lj.domain_partition(m.grid, inds, nTime=3, steps=steps, radius=1.2)
        assert d_t.dtype == torch.int64 and np.array_equal(d_t.numpy(), d_j)
        assert rel_err(t_t, t_j) < 1e-14
    with pytest.raises(ValueError):
        lt.domain_partition(g, inds, steps=(5, 4), device="cpu")
    for shape, steps in (((16, 16), [4, 4]), ((10, 7), [3, 2]), ((4, 6, 5), [2, 3, 5])):
        parts_t = lt.rectangular_partitioning(shape, steps)
        parts_j = lj.rectangular_partitioning(shape, steps)
        assert len(parts_t) == len(parts_j)
        assert all(np.array_equal(a, b) for a, b in zip(parts_t, parts_j))


def _analysis_inputs(N, nTime, M, seed):
    rng = np.random.default_rng(seed)
    p = 4 * nTime
    _, R12 = hm.utils.temporal_R(nTime, 4)
    R12 = np.asarray(R12)
    return (rng.normal(size=(N, M)), rng.normal(size=(N, p)), rng.normal(size=p),
            rng.normal(size=(N, p)) @ R12.T, np.linalg.inv(R12.T))


@pytest.mark.parametrize("N,nTime", [(12, 2), (6, 3)])  # p = 8 <= 12; p = 12 > 6
def test_localized_updates_both_branches(N, nTime):
    E, Eo, obs, pert, dec = _analysis_inputs(N, nTime, 64, N)
    g = ht.Grid2D(Nx=8, Ny=8, Lx=2.0, Ly=1.0)
    gj = hm.Grid2D(Nx=8, Ny=8, Lx=2.0, Ly=1.0)
    obs_inds = np.array([9, 14, 49, 54])
    taper = np.asarray(lj.bump(lj.dist_to_obs(gj, obs_inds, nTime=nTime) / 0.9))
    args_j = tuple(map(jnp.asarray, (E, Eo, obs, pert, dec)))
    args_t = tuple(map(t64, (E, Eo, obs, pert, dec)))
    ref = uj.ens_update0_loc(*args_j, jnp.asarray(taper))
    assert rel_err(ut.ens_update0_loc(*args_t, t64(taper)), ref) < 1e-10

    doms_t, taper_t = lt.domain_partition(g, obs_inds, nTime=nTime, steps=(2, 4), radius=0.9,
                                          device="cpu")
    doms_j, taper_j = lj.domain_partition(gj, obs_inds, nTime=nTime, steps=(2, 4), radius=0.9)
    ref = uj.ens_update0_loc_domains(*args_j, taper_j, doms_j)
    out = ut.ens_update0_loc_domains(*args_t, taper_t, doms_t)
    assert rel_err(out, ref) < 1e-10


def test_two_pass_localized_es_mda_slice_matches_jax():
    N, nTime, dt = 8, 10, 0.1
    m = default_model(Nx=16, Ny=16)
    k_truth, k_prior, k_noise, k_mda = jax.random.split(jax.random.PRNGKey(4), 4)
    truth = gaussian_fields_fft(k_truth, m.grid, N=1, r=0.8)[0]
    prior = gaussian_fields_fft(k_prior, m.grid, N=N, r=0.8)
    _, R12 = hm.utils.temporal_R(nTime, m.nPrd)
    noise = R12 @ jax.random.normal(k_noise, (nTime * m.nPrd,))
    domains, taper_dom = lj.domain_partition(m.grid, np.asarray(prod_inds(m)), nTime=nTime,
                                             steps=(4, 4), radius=1.2)

    _, pt = hm.forward_model(m, truth[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs_j = jnp.clip(pt[0].reshape(-1) + noise, 0, 1)

    def fwd_j(E):
        return hm.forward_model(m, E, dt=dt, nTime=nTime, keep_wsats=False)[1].reshape(N, -1)

    post_j = hm.es_mda(prior, fwd_j, obs_j, R12, hm.mda_alphas(2), k_mda, domains=domains,
                       taper_dom=jnp.asarray(taper_dom))
    draws, key = [], k_mda
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(np.array(hm.gaussian_noise(sub, N, nTime * m.nPrd,
                                                L=jnp.asarray(R12, jnp.float32))))

    mt = convert.ressim_from_reference(m, dtype=F64, device="cpu")
    truth_t, prior_t, noise_t, R12_t = (convert.tensor(x, dtype=F64, device="cpu")
                                        for x in (truth, prior, noise, R12))
    loc = convert.localization(domains=domains, taper_dom=taper_dom, device="cpu", dtype=F64)
    _, pt_t = ht.forward_model(mt, truth_t[None], dt=dt, nTime=nTime, keep_wsats=False)
    obs_t = torch.clamp(pt_t[0].reshape(-1) + noise_t, 0, 1)
    fwd_t = ht.obs_ens_fn(mt, dt, nTime)
    post_t = ht.es_mda(prior_t, fwd_t, obs_t, R12_t, ht.mda_alphas(2, dtype=F64, device="cpu"),
                       noise=draws, **loc)

    assert post_t.shape == (N, m.Nxy) and torch.isfinite(post_t).all()
    assert rel_err(post_t, post_j) < 1e-7
    # The analysis moves the ensemble, and the localization changes how.
    plain = ht.es_mda(prior_t, fwd_t, obs_t, R12_t, ht.mda_alphas(2, dtype=F64, device="cpu"),
                      noise=draws)
    assert rel_err(post_t, prior_t) > 1e-2 and rel_err(plain, post_t) > 1e-2
