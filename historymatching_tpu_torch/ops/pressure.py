"""Kernel P: the whole restarted MG-PCG pressure solve, for every member.

Replaces the TPU kernels of `historymatching_tpu/ops/pressure_pallas.py`
(`pressure_solve_pallas`, `_batched`, `_packed`): on the card one thread
block per member runs `ops.cg.pcg`'s algorithm with the V-cycle of
`ops.multigrid.vcycle_apply` inside (`csrc/pressure_pcg.cu`, a template on
the grid). The kernel solves the Jacobi-scaled system, whose fine diagonal
is 1 (`models.ressim.scaled_system` states the contract); it takes that as
given and does not read it. The semantics are those of
the per-member `pcg` (each member stops on its own), not of the TPU's
lockstep `pcg_batched`. Beside it, `pressure_solve_torch` is the plain
PyTorch version, built from the same two modules.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel, which raises on what it does not take.
"""

from __future__ import annotations

import ctypes

import torch

from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.cg import pcg
from historymatching_tpu_torch.ops.multigrid import n_levels, vcycle_apply
from historymatching_tpu_torch.ops.stencil import stencil_matvec


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


def _r4(v):
    return (v + 3) // 4 * 4


def _kernel_threads(Nx, Ny):
    """Threads of the kernel's block: one per four fine 2x2 tiles at 64x64,
    one per tile (in whole warps) on grids of up to 256 tiles."""
    tiles = Nx * Ny // 4
    return 256 if tiles > 256 else -(-tiles // 32) * 32


def smem_bytes(Nx, Ny, levels):
    """Shared memory the kernel takes for one member (the layout of `Geo` in
    csrc/pressure_pcg.cu): the fine faces, TY padded to Ny wide, and the
    vectors p, r and the smoothing temporary; per intermediate level its
    faces, diagonal, reciprocal diagonal, right-hand side and iterate; the
    coarsest right-hand side, iterate and inverse; two reduction slots a
    warp. Every array is rounded up to 4 floats."""
    cells = [(Nx >> lvl) * (Ny >> lvl) for lvl in range(levels)]
    faces = [_r4(((Nx >> lvl) - 1) * (Ny >> lvl)) for lvl in range(levels)]
    vec = [_r4(c) for c in cells]
    lc = levels - 1
    floats = (faces[0] + 4 * vec[0] + sum(faces[lvl] + 5 * vec[lvl] for lvl in range(1, lc))
              + 2 * vec[lc] + _r4(cells[lc] ** 2) + 4 * (_kernel_threads(Nx, Ny) // 32))
    return 4 * floats


def pressure_solve_cuda(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                        restart_every=8):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device. The kernel takes the fine diagonal as 1, the contract of
    `models.ressim.scaled_system`, and does not read `hier[0][2]`."""
    B, Nx, Ny = q.shape
    _build.check_grid("pressure", Nx, Ny)
    levels = len(hier)
    if levels != n_levels(Nx, Ny):
        raise ValueError(f"pressure kernel: grid {Nx}x{Ny} takes {n_levels(Nx, Ny)} multigrid "
                         f"levels, got {levels}")
    nc = (Nx >> (levels - 1)) * (Ny >> (levels - 1))
    tensors = {"Ainv": (Ainv, (B, nc, nc)), "q": (q, (B, Nx, Ny)), "p0": (p0, (B, Nx, Ny)),
               "w": (w, (B, Nx, Ny))}
    for lvl, (TX, TY, diag) in enumerate(hier):
        n, m = Nx >> lvl, Ny >> lvl
        tensors.update({f"TX{lvl}": (TX, (B, n - 1, m)), f"TY{lvl}": (TY, (B, n, m - 1)),
                        f"diag{lvl}": (diag, (B, n, m))})
    for name, (t, shape) in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need float32 CUDA {shape}, got "
                             f"{t.dtype} {t.device} {tuple(t.shape)}")
    # Per level TX, TY, diag; the fine diagonal is not read and goes as null.
    levels_c = [hier[0][0].contiguous(), hier[0][1].contiguous(), None]
    levels_c += [t.contiguous() for lvl in hier[1:] for t in lvl]
    Ainv, q, p0, w = (t.contiguous() for t in (Ainv, q, p0, w))
    ptrs = (ctypes.c_void_p * len(levels_c))(*[None if t is None else t.data_ptr()
                                               for t in levels_c])
    p = torch.empty_like(q)
    it = torch.empty(B, dtype=torch.int32, device=q.device)
    rel = torch.empty(B, dtype=torch.float32, device=q.device)
    if B == 0:
        return p, it, rel
    patience = max(4, -(-patience_iters // restart_every))
    code = _build.lib().hm_pressure_solve(
        ctypes.cast(ptrs, ctypes.c_void_p), Ainv.data_ptr(), q.data_ptr(), p0.data_ptr(),
        w.data_ptr(), p.data_ptr(), it.data_ptr(), rel.data_ptr(), B, Nx, Ny, levels,
        float(tol), int(maxiter), int(restart_every), patience, _build.stream_ptr(q.device))
    _build.check(code, "pressure_pcg")
    _build.LAUNCHES["pressure_pcg"] += 1
    return p, it, rel


def pressure_solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96):
    """Solve every member's scaled TPFA system: the kernel on CUDA, the plain
    version on the CPU."""
    fn = pressure_solve_cuda if q.is_cuda else pressure_solve_torch
    return fn(hier, Ainv, q, p0, w, tol, maxiter, patience_iters)
