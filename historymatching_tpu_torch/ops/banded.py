"""Batched banded Cholesky solve in float64, for the exact oracle.

The JAX package's float64 oracle (`historymatching_tpu/models/oracle.py`)
solves each member's pinned TPFA system with LAPACK `dpbsv` through
`scipy.linalg.solveh_banded`, member by member on the host. This module
is its counterpart in the port, batched over members:

- `banded_solve_torch`, the plain version: an unblocked band Cholesky in
  `dpbtf2`'s order (column j: a square root, the row scaled by its
  reciprocal, a rank-1 update of the next kd rows), the forward
  substitution U^T y = q alongside it, then the back substitution U p = y
  by columns. It works on the band alone (no n x n matrix), so it runs at
  the bench grid on the CPU;
- `banded_solve_cuda`, the wrapper of the hand-written kernel
  (`csrc/banded_cholesky.cu`), which does the same float64 operations in
  the same order, every product and difference rounded on its own;
- `banded_solve`, which dispatches by device, with no fallback.

This kernel replaces no TPU kernel: the TPU has no float64, and the JAX
package runs its oracle on the CPU. A member whose pivot is not positive
raises `torch.linalg.LinAlgError`, as `solveh_banded` raises LinAlgError.

Storage: LAPACK's upper band form, ab (N, kd+1, n) with ab[kd + i - j, j]
= A[i, j] for max(0, j-kd) <= i <= j; the entries above row kd - j of
column j are never read.
"""

from __future__ import annotations

import torch

from historymatching_tpu_torch.ops import _build

NAME = "banded_cholesky"  # the launch counter
STAGES, CHUNK = 4, 8  # csrc/banded_cholesky.cu: kStages stages of kChunk columns of ab and q


def _cdiv(a, b):
    return -(-a // b)


def smem_bytes(kd):
    """Shared bytes of the kernel's block at band width kd: the window's
    upper triangle and a spare, the scaled row (and a 0), the right-hand
    side's ring, and the staged columns of ab and q."""
    K = kd + 1
    return 8 * (K * (K + 1) // 2 + 1 + (K + 1) + K + STAGES * (K + 1) * CHUNK)


def max_kd():
    """The widest band whose block fits `_build.SMEM_LIMIT`."""
    kd = 1
    while smem_bytes(kd + 1) <= _build.SMEM_LIMIT:
        kd += 1
    return kd


def launch_plan(kd):
    """(pairs a thread, threads a block) at band width kd: the window's
    K(K+1)/2 pairs over at most 1,024 threads, 16 pairs a thread where
    that fits, else 32."""
    pairs = (kd + 1) * (kd + 2) // 2
    per = 16 if _cdiv(pairs, 16) <= 1024 else 32
    return per, 32 * _cdiv(_cdiv(pairs, per), 32)


def _check(name, t, shape):
    if t.dtype != torch.float64 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need float64 {shape}, got {t.dtype} {tuple(t.shape)}")


def _raise_on(info):
    bad = torch.nonzero(info > 0).flatten().tolist()
    if bad:
        cols = [int(info[i]) - 1 for i in bad[:8]]
        raise torch.linalg.LinAlgError(
            f"banded Cholesky: the pivot of members {bad[:8]} is not positive "
            f"(at columns {cols}); the matrix is not positive definite")


def banded_solve_torch(ab, q):
    """Plain version: p (N, n) with A p = q for each member's band ab
    (N, kd+1, n), float64. Raises `torch.linalg.LinAlgError` where a
    pivot is not positive."""
    _check("ab", ab, ab.shape)
    _check("q", q, (ab.shape[0], ab.shape[2]))
    p, info = plain_solve(ab, q)
    _raise_on(info)
    return p


def plain_solve(ab, q):
    """The plain version's operations, returning (p, info) without
    reading info back: info[m] is the column + 1 of member m's first pivot
    that is not positive (0: none), where p is not finite. It syncs with
    nothing, so a CUDA graph can capture it."""
    N, K, n = ab.shape
    kd = K - 1
    # Row storage R[:, kd + j, m] = A[j, j + m], behind kd zero rows (the
    # back substitution's column view reaches them) and ahead of kd
    # identity rows (the rank-1 update's and the forward substitution's
    # reach past n).
    R = ab.new_zeros(N, n + 2 * kd, K)
    for m in range(K):
        R[:, kd:kd + n - m, m] = ab[:, kd - m, m:]
    R[:, kd + n:, 0] = 1.0
    y = ab.new_zeros(N, n + 2 * kd)
    y[:, kd:kd + n] = q
    mask = torch.ones(kd, kd, dtype=torch.float64, device=ab.device).triu()
    stride = R.stride(0)
    for j in range(n):
        r = kd + j
        rd = R[:, r, 0].sqrt_().reciprocal()
        u = R[:, r, 1:]
        u.mul_(rd[:, None])
        # rows j+1..j+kd, columns j+1..j+kd: R[r + i, k - i] at r*K + i*kd + k
        V = R.as_strided((N, kd, kd), (stride, kd, 1), R.storage_offset() + (r + 1) * K)
        V.sub_((u[:, :, None] * mask) * u[:, None, :])
        y[:, r].mul_(rd)
        y[:, r + 1:r + K].sub_(u * y[:, r:r + 1])
    bad = ~(R[:, kd:kd + n, 0] > 0)
    info = torch.where(bad.any(dim=1), bad.int().argmax(dim=1) + 1, 0)
    rdiag = R[:, :, 0].reciprocal()
    for j in range(n - 1, -1, -1):
        r = kd + j
        y[:, r].mul_(rdiag[:, r])
        # U[j - kd + t, j] = R[r - kd + t, kd - t], t = 0..kd-1
        col = R.as_strided((N, kd), (stride, kd), R.storage_offset() + r * K - kd * kd)
        y[:, r - kd:r].sub_(col * y[:, r:r + 1])
    return y[:, kd:kd + n].clone(), info


def banded_solve_cuda(ab, q):
    """The hand kernel: the same arguments as the plain version, float64
    on one CUDA device, kd up to `max_kd()`. One block a member; the
    factor's rows go to a workspace the back substitution reads."""
    N, K, n = ab.shape
    kd = K - 1
    for name, t, shape in (("ab", ab, (N, K, n)), ("q", q, (N, n))):
        if not t.is_cuda:
            raise ValueError(f"{name}: need a CUDA tensor, got {t.device}")
        _check(name, t, shape)
    if kd < 1 or kd > max_kd():
        raise ValueError(f"banded kernel: band width kd={kd} outside 1..{max_kd()}: the "
                         f"window needs {smem_bytes(kd)} shared bytes, one block has "
                         f"{_build.SMEM_LIMIT}")
    ab, q = ab.contiguous(), q.contiguous()
    p = torch.empty_like(q)
    info = torch.zeros(N, dtype=torch.int32, device=q.device)
    if N == 0:
        return p
    ucol = torch.empty(N, n, K, dtype=torch.float64, device=q.device)
    per, threads = launch_plan(kd)
    code = _build.lib().hm_banded_solve(ab.data_ptr(), q.data_ptr(), p.data_ptr(),
                                        ucol.data_ptr(), info.data_ptr(), N, n, kd, per,
                                        threads, _build.stream_ptr(q.device))
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    _raise_on(info.cpu())
    return p


def banded_solve(ab, q):
    """p with A p = q for each member: the kernel on CUDA, the plain
    version on the CPU."""
    return (banded_solve_cuda if ab.is_cuda else banded_solve_torch)(ab, q)
