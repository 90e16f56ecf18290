"""Kernel P: the whole restarted MG-PCG pressure solve, for every member.

Replaces the TPU kernels of `historymatching_tpu/ops/pressure_pallas.py`
(`pressure_solve_pallas`, `_batched`, `_packed`): on the card one thread
block per member runs `ops.cg.pcg`'s algorithm with the V-cycle of
`ops.multigrid.vcycle_apply` inside (`csrc/pressure_pcg.cu`). The
semantics are those of the per-member `pcg` (each member stops on its own),
not of the TPU's lockstep `pcg_batched`. Beside it, `pressure_solve_torch`
is the plain PyTorch version, built from the same two modules.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel, which raises on what it does not take.
"""

from __future__ import annotations

import torch

from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.cg import pcg
from historymatching_tpu_torch.ops.multigrid import vcycle_apply
from historymatching_tpu_torch.ops.stencil import stencil_matvec

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def pressure_solve_torch(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                         restart_every=8):
    """Plain version. `hier` is the per-level list of (TX, TY, diag), each
    (B, ...); `Ainv` (B, n, n) the coarse inverse; q, p0, w (B, Nx, Ny).
    Returns (p, iters int32 (B,), rel (B,))."""
    TX, TY, diag = hier[0]
    return pcg(lambda x: stencil_matvec(TX, TY, diag, x), q, x0=p0,
               Minv=lambda r: vcycle_apply(hier, Ainv, r), tol=tol, maxiter=maxiter,
               restart_every=restart_every, patience_iters=patience_iters,
               metric_weight=w)


def smem_bytes(Nx, Ny, levels):
    """Shared memory the kernel needs for one member (see the source note
    in csrc/pressure_pcg.cu): the hierarchy and coarse inverse, seven
    fine-grid vectors, three vectors per coarse level, reduction scratch."""
    n, m = Nx, Ny
    hier = coarse = 0
    for lvl in range(levels):
        hier += (n - 1) * m + n * (m - 1) + n * m
        if lvl > 0:
            coarse += 3 * n * m
        if lvl < levels - 1:
            n, m = n // 2, m // 2
    hier += (n * m) ** 2
    return 4 * (hier + 7 * Nx * Ny + coarse + 64)


def pack_hierarchy(hier, Ainv):
    """(B, total) contiguous float32 buffer: per level TX, TY, diag
    (row-major), then the row-major coarse inverse."""
    B = Ainv.shape[0]
    parts = [t.reshape(B, -1) for lvl in hier for t in lvl] + [Ainv.reshape(B, -1)]
    return torch.cat(parts, dim=1).contiguous()


def pressure_solve_cuda(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                        restart_every=8):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device."""
    B, Nx, Ny = q.shape
    levels = len(hier)
    if levels < 2:
        raise ValueError(f"pressure kernel needs >= 2 multigrid levels, grid {Nx}x{Ny}")
    nbytes = smem_bytes(Nx, Ny, levels)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"pressure kernel: grid {Nx}x{Ny} needs {nbytes} B of shared memory")
    flat = pack_hierarchy(hier, Ainv)
    tensors = {"hier": (flat, (B, flat.shape[1])), "q": (q, (B, Nx, Ny)),
               "p0": (p0, (B, Nx, Ny)), "w": (w, (B, Nx, Ny))}
    for name, (t, shape) in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need float32 CUDA {shape}, got "
                             f"{t.dtype} {t.device} {tuple(t.shape)}")
    q, p0, w = q.contiguous(), p0.contiguous(), w.contiguous()
    p = torch.empty_like(q)
    it = torch.empty(B, dtype=torch.int32, device=q.device)
    rel = torch.empty(B, dtype=torch.float32, device=q.device)
    if B == 0:
        return p, it, rel
    patience = max(4, -(-patience_iters // restart_every))
    code = _build.lib().hm_pressure_solve(
        flat.data_ptr(), q.data_ptr(), p0.data_ptr(), w.data_ptr(), p.data_ptr(),
        it.data_ptr(), rel.data_ptr(), B, Nx, Ny, levels, flat.shape[1], float(tol),
        int(maxiter), int(restart_every), patience, _build.stream_ptr(q.device))
    _build.check(code, "pressure_pcg")
    _build.LAUNCHES["pressure_pcg"] += 1
    return p, it, rel


def pressure_solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96):
    """Solve every member's scaled TPFA system: the kernel on CUDA, the plain
    version on the CPU."""
    fn = pressure_solve_cuda if q.is_cuda else pressure_solve_torch
    return fn(hier, Ainv, q, p0, w, tol, maxiter, patience_iters)
