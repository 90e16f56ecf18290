"""Port vs JAX: the counter-based draws (`historymatching_tpu_torch.prng`)
and the bench case built from them, on the CPU.

- `PRNGKey` and `split` equal JAX's bits, and `random_bits` and `uniform`
  too, on several seeds and shapes (odd sizes included);
- float32 `normal` within 1 ulp of JAX's (the `erfinv` polynomial is
  evaluated with XLA's roundings; on this host it agrees bit for bit);
- the port's `parity.build_case` at 16x16, N=8 against `bench.build_case`:
  prior, truth and noise within float32 rounding of the two DFTs and
  products (2e-6 of the fields' scale), R12 and the `key_mda` bits equal;
- `es_mda(key=)` makes JAX's per-pass draws: each pass's perturbations
  `gaussian_noise(key=)` within one float32 rounding of the product by
  R12 of JAX's, and with a linear forward model the posterior within 1e-7
  of JAX's and of the port's own run on JAX's draws handed in (the draws'
  float32 rounding, ~6e-8 of their scale, carried through the update);
  a pass's callback key resumes the run bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import historymatching_tpu as hm
import historymatching_tpu_torch as ht
from historymatching_tpu_torch import parity, prng

SEEDS = (0, 1, 5, 42, 12345, 2**31 - 1)
SHAPES = ((1,), (5,), (3, 7), (2, 9, 13), (160,), (4, 128))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(kj), _u32(kt))
    for n in (2, 3, 4, 7):
        assert np.array_equal(np.asarray(jax.random.split(kj, n)), _u32(prng.split(kt, n)))
    # a chain of splits, as es_mda makes one a pass
    for _ in range(4):
        kj, sj = jax.random.split(kj)
        kt, st = prng.split(kt)
        assert np.array_equal(np.asarray(sj), _u32(st))
    for shape in SHAPES:
        assert np.array_equal(np.asarray(jax.random.bits(kj, shape, jnp.uint32)),
                              _u32(prng.random_bits(kt, shape)))
        lo = np.nextafter(np.float32(-1), np.float32(0))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(kj, shape, jnp.float32, lo, 1.0)),
            prng.uniform(kt, shape, float(lo), 1.0).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_one_ulp_of_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in SHAPES + ((8, 32, 32), (50_001,)):
        nj = np.asarray(jax.random.normal(kj, shape, jnp.float32))
        nt = prng.normal(kt, shape)
        assert nt.dtype == torch.float32 and nt.shape == shape
        ulps = np.abs(nj.view(np.int32).astype(np.int64)
                      - nt.numpy().view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, (shape, ulps.max())


@pytest.mark.parametrize("seed", (1, 3))
def test_build_case_matches_bench(seed):
    cj = bench.build_case(seed, 8, 16, 16, 10)
    ct = parity.build_case(seed, 8, 16, 16, 10, device="cpu")
    for k in ("truth", "prior", "noise"):
        a, b = np.asarray(cj[k]), ct[k].numpy()
        assert b.dtype == np.float32 and b.shape == a.shape
        assert np.abs(a - b).max() <= 2e-6 * np.abs(a).max(), k
    np.testing.assert_array_equal(np.asarray(cj["R12"]), ct["R12"].numpy())
    assert np.array_equal(np.asarray(cj["key_mda"]), _u32(ct["key_mda"]))


def test_es_mda_key_draws_equal_jax():
    rng = np.random.default_rng(4)
    N, M, p, passes = 12, 20, 6, 3
    G = rng.normal(size=(M, p)) / 4
    E0 = rng.normal(size=(N, M))
    obs = rng.normal(size=p) / 2
    _, R12 = hm.utils.temporal_R(3, 2)
    key = jax.random.PRNGKey(9)
    post_j = hm.es_mda(jnp.asarray(E0), lambda E: E @ G, jnp.asarray(obs), R12,
                       hm.mda_alphas(passes), key)
    draws, k, kt = [], key, prng.PRNGKey(9)
    for _ in range(passes):
        k, sub = jax.random.split(k)
        kt, sub_t = prng.split(kt)
        L = jnp.asarray(R12, jnp.float32)
        draws.append(np.asarray(hm.gaussian_noise(sub, N, p, L=L)))
        mine = ht.gaussian_noise(N, p, L=torch.from_numpy(np.array(L)), key=sub_t).numpy()
        assert np.abs(mine - draws[-1]).max() <= 2 ** -23 * np.abs(draws[-1]).max()

    Gt = torch.from_numpy(G)
    run = lambda E, **kw: ht.es_mda(E, lambda E: E @ Gt, torch.from_numpy(obs),  # noqa: E731
                                    torch.from_numpy(np.array(R12)),
                                    ht.mda_alphas(passes, dtype=torch.float64, device="cpu"), **kw)
    infos = []
    post_k = run(torch.from_numpy(E0), key=prng.PRNGKey(9), callback=infos.append)
    post_d = run(torch.from_numpy(E0), noise=draws)
    np.testing.assert_allclose(post_k.numpy(), post_d.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(post_k.numpy(), np.asarray(post_j), rtol=0, atol=1e-7)
    # a pass's callback key resumes the run where it stopped
    assert torch.equal(run(infos[0]["E"], key=infos[0]["key"], start_pass=1), post_k)
