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

The V-cycle's smoother is a compile-time choice of the kernel: damped
Jacobi (launches counted as "pressure_pcg") or degree-2 Chebyshev
("pressure_pcg_cheb"), both instantiated for every grid.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel, which raises on what it does not take.
"""

from __future__ import annotations

import ctypes

import torch

from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.cg import pcg
from historymatching_tpu_torch.ops.multigrid import SMOOTHERS, n_levels, vcycle_apply
from historymatching_tpu_torch.ops.stencil import stencil_matvec, stencil_residual_ds


def pressure_solve_torch(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                         restart_every=8, smoother="jacobi"):
    """Plain version. `hier` is the per-level list of (TX, TY, diag), each
    (B, ...); `Ainv` (B, n, n) the coarse inverse; q, p0, w (B, Nx, Ny);
    `smoother` the V-cycle's ("jacobi" or "cheb").
    Returns (p, iters int32 (B,), rel (B,))."""
    TX, TY, diag = hier[0]
    return pcg(lambda x: stencil_matvec(TX, TY, diag, x), q, x0=p0,
               Minv=lambda r: vcycle_apply(hier, Ainv, r, smoother=smoother), tol=tol,
               maxiter=maxiter, restart_every=restart_every, patience_iters=patience_iters,
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


KERNELS = {"jacobi": "pressure_pcg", "cheb": "pressure_pcg_cheb"}  # by smoother


def pressure_solve_cuda(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                        restart_every=8, smoother="jacobi"):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device. The kernel takes the fine diagonal as 1, the contract of
    `models.ressim.scaled_system`, and does not read `hier[0][2]`."""
    B, Nx, Ny = q.shape
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother must be one of {SMOOTHERS}, got {smoother!r}")
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
        float(tol), int(maxiter), int(restart_every), patience, int(smoother == "cheb"),
        _build.stream_ptr(q.device))
    _build.check(code, KERNELS[smoother])
    _build.LAUNCHES[KERNELS[smoother]] += 1
    return p, it, rel


def pressure_solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96, smoother="jacobi"):
    """Solve every member's scaled TPFA system: the kernel on CUDA, the plain
    version on the CPU."""
    fn = pressure_solve_cuda if q.is_cuda else pressure_solve_torch
    return fn(hier, Ainv, q, p0, w, tol, maxiter, patience_iters, smoother=smoother)


REFINE_ITERS = 96  # the refinement pass's iteration cap (pressure_pallas.py:378)


def recook_plan(N, Ny, maxiter, two_pass=True, twopass_j1=64, twopass_div=4):
    """The reference's rule for the straggler recook, from shapes only:
    (Nb, K), the padded batch and the members recooked from it, or None
    where the reference solves in one pass.

    The reference recooks only where it lane-packs P = 128 // Ny members a
    row (Ny <= 64, 128 % Ny == 0; pressure_pallas.py:303-304), pads the
    batch to a multiple of group = 16 P (:309-311), and engages with
    `two_pass`, maxiter > twopass_j1 and at least two groups (:351); it
    recooks K = max(group, (Nb // twopass_div // group) group) members
    (:359). Kept literally, so the port recooks the members the reference
    did at every shape (a 20x20 grid never recooks)."""
    if not (Ny <= 64 and 128 % Ny == 0):
        return None
    group = 16 * (128 // Ny)
    Nb = N + (-N) % group
    if not (two_pass and maxiter > twopass_j1 and Nb >= 2 * group):
        return None
    return Nb, max(group, (Nb // twopass_div // group) * group)


def pressure_solve_recook(hier, Ainv, q, p0, w, tol, maxiter, patience_iters=96,
                          two_pass=True, twopass_j1=64, twopass_div=4, refine=True,
                          solve=pressure_solve, smoother="jacobi"):
    """The reference's three-pass solve (pressure_pallas.py:336-397) around
    `solve` (by default the dispatch above; on either device), every pass
    with the V-cycle smoother `smoother`:

    1. every member with the iteration cap `twopass_j1`;
    2. the K members with the largest pass-1 residual (`recook_plan`; the
       batch padded by modular gather, a stable descending sort, so ties
       go to the lower index as in `lax.top_k`, padded copies dropped)
       again, warm-started from pass 1, with the full `maxiter`;
    3. with `refine`, a compensated residual of those members
       (`stencil_residual_ds`), its correction solved from zero with 96
       iterations on the same hierarchy, and `rel` rescaled to the
       refined iterate's.

    Returns (p, iters, rel, recooked): iterations add up over the passes;
    `recooked` (B,) marks the members of passes 2 and 3. Nothing waits for
    the device: the plan comes from shapes, the indices stay on it."""
    B, _, Ny = q.shape
    plan = recook_plan(B, Ny, maxiter, two_pass, twopass_j1, twopass_div)
    if plan is None:
        p, it, rel = solve(hier, Ainv, q, p0, w, tol, maxiter, patience_iters, smoother=smoother)
        return p, it, rel, torch.zeros(B, dtype=torch.bool, device=q.device)
    Nb, K = plan
    p1, it1, rel1 = solve(hier, Ainv, q, p0, w, tol, twopass_j1, patience_iters,
                          smoother=smoother)
    pad = torch.arange(Nb, device=q.device) % B
    top = torch.sort(rel1[pad], descending=True, stable=True).indices[:K]
    idx = pad[top]
    take = lambda t: t[idx]  # noqa: E731
    hier_k = [tuple(take(t) for t in lvl) for lvl in hier]
    Ainv_k, q_k, w_k = take(Ainv), take(q), take(w)
    p2, it2, rel2 = solve(hier_k, Ainv_k, q_k, take(p1), w_k, tol, maxiter, patience_iters,
                          smoother=smoother)
    if refine:
        r_ds = stencil_residual_ds(*hier_k[0], p2, q_k)
        d3, it3, rel3 = solve(hier_k, Ainv_k, r_ds, torch.zeros_like(r_ds), w_k, tol,
                              REFINE_ITERS, patience_iters, smoother=smoother)
        p2 = p2 + d3
        it2 = it2 + it3
        num = (w_k * r_ds).reshape(K, -1).norm(dim=1)
        den = (w_k * q_k).reshape(K, -1).norm(dim=1).clamp_min(torch.finfo(q.dtype).tiny)
        rel2 = rel3 * num / den
    # Picks of padded copies (top >= B) write to a spare last slot; their
    # member is picked at its own index too (equal rel, lower index first).
    dst = torch.where(top < B, idx, B)
    extend = lambda t: torch.cat([t, t[:1]])  # noqa: E731
    p = extend(p1).index_copy_(0, dst, p2)[:B]
    it = extend(it1).index_add_(0, dst, it2)[:B]
    rel = extend(rel1).index_copy_(0, dst, rel2)[:B]
    recooked = torch.zeros(B + 1, dtype=torch.bool, device=q.device).index_fill_(0, dst, True)
    return p, it, rel, recooked[:B]
