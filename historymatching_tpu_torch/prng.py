"""JAX's counter-based random draws, computed with torch integer ops.

The three calls the reference bench case and the analyses draw with,
`jax.random.PRNGKey(seed)`, `split(key, n)` and `normal(key, shape,
float32)`, on JAX 0.9.0's threefry2x32 with `jax_threefry_partitionable`
on (its default). The same seed gives the same keys bit for bit and the
same standard normals to within one float32 ulp (the `erfinv`
polynomial's rounding), on any device, so the port runs on exactly the
inputs `bench.build_case` draws without holding them in a fixture.

A key is an int64 tensor of shape (2,) holding two uint32 words, on the
device its draws are made on. torch has no full uint32 arithmetic, so
every word is an int64 masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Giles' single-precision erfinv, as JAX lowers it: coefficients for
# w = -log1p(-x^2) below 5, and at or above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 log1p on the CPU: below sqrt(2) - 1 in magnitude, Cephes'
# rational approximation (coefficients from the highest degree down);
# above, log(1 + x) by Cephes' logf polynomial on the mantissa.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2): int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed, device="cpu"):
    """`jax.random.PRNGKey(seed)`: the words (seed >> 32, seed & 0xFFFFFFFF)
    of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64, device=device)


def _hash_counts(key, n):
    """The hash of the counters 0..n-1, as the 64-bit iota JAX splits
    into (hi, lo) words."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], i >> 32, i & _MASK)


def split(key, num=2):
    """`jax.random.split(key, num)`: (num, 2) new keys."""
    b1, b2 = _hash_counts(key, num)
    return torch.stack([b1, b2], dim=1)


def random_bits(key, shape):
    """`jax.random.bits(key, shape, uint32)` as int64 values."""
    b1, b2 = _hash_counts(key, math.prod(shape))
    return (b1 ^ b2).reshape(shape)


def _fma(a, b, c):
    """a * b + c rounded once to float32, as XLA's contracted multiply-adds
    (the product of two float32s is exact in float64). Divisions and square
    roots below are likewise taken in float64 and rounded once, which gives
    the correctly rounded float32 result XLA's CPU code does, whatever the
    device's own float32 routines round to."""
    return (a.double() * b.double() + c.double()).float()


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _horner(x, coefs):
    p = torch.zeros_like(x)
    for c in coefs:
        p = _fma(p, x, _f32(c, x.device))
    return p


def _logf(v):
    """XLA's float32 log of v > 0: v = m 2^e with m in [sqrt(1/2), sqrt(2)),
    log = poly(m - 1) + e log 2, log 2 in two parts."""
    dev = v.device
    bits = torch.maximum(v, _f32(np.finfo(np.float32).tiny, dev)).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    half = int(np.array(0.5, np.float32).view(np.int32))
    m = ((bits & ~0x7F800000) | half).view(torch.float32)  # in [0.5, 1)
    low = m < _f32(0.707106781186547524, dev)
    x = m - 1.0 + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c, dev) for c in _LOGF_P]
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(-2.12194440e-4, dev) * e)
    return x - 0.5 * x2 + y + _f32(0.693359375, dev) * e


def _log1p(x):
    """XLA's float32 log1p: Cephes' rational form for |x| < sqrt(2) - 1,
    else log(1 + x)."""
    x2 = x * x
    ratio = (_horner(x, _LOG1P_NUM).double() / _horner(x, _LOG1P_DEN).double()).float()
    small = x + (-0.5 * x2 + (x * x2) * ratio)
    return torch.where(x.abs() < 0.41421356237309504880, small, _logf(x + 1.0))


def _erfinv_f32(x):
    """erfinv of a float32 tensor with the polynomial JAX evaluates."""
    w = -_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = lambda i: torch.where(lt, _f32(_ERFINV_LT5[i], x.device),  # noqa: E731
                                 _f32(_ERFINV_GE5[i], x.device))
    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: 23
    random mantissa bits under the exponent of 1.0, minus one, scaled."""
    bits = random_bits(key, shape)
    one = int(np.array(1.0, np.float32).view(np.int32))
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key, shape):
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erfinv(u), u
    uniform on (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, tuple(shape), lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32, device=key.device) * _erfinv_f32(u)
