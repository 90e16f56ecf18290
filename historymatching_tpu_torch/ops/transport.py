"""Kernel K: all CFL substeps of one outer transport step, for every member.

Replaces the TPU kernels of `historymatching_tpu/ops/transport_pallas.py`
(`transport_substeps_pallas`, `_batched`, `_packed`): on the card one
thread block per member loops over that member's own substep count
(`csrc/transport_upwind.cu`: a template on the grid for the grids of
`_build.GRIDS`, and a variant with the grid as a runtime argument for any
other grid whose two fw tiles fit one block's shared memory). Beside it,
`transport_substeps_torch` is the plain PyTorch version; it runs the batch
to its largest count and freezes each member after its own, which gives
the same per-member result.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel, which raises on what it does not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from historymatching_tpu_torch.ops import _build


def check_grid(Nx, Ny):
    """Raise unless kernel K takes an Nx x Ny grid: a block holds two fw
    tiles of the grid in shared memory."""
    nbytes = 2 * 4 * Nx * Ny
    if nbytes > _build.SMEM_LIMIT:
        raise ValueError(f"transport kernel: a {Nx}x{Ny} grid needs {nbytes} bytes of shared "
                         f"memory a member, over the {_build.SMEM_LIMIT} one thread block may take")


def transport_substeps_torch(s, Fx, Fy, q, dts_pv, n_sub, fluid):
    """Plain version. s (B, Nx, Ny); Fx (B, Nx+1, Ny); Fy (B, Nx, Ny+1);
    q (B or 1, Nx, Ny); dts_pv (B,) substep length over pore volume;
    n_sub (B,) int; fluid (vw, vo, swc, sor)."""
    vw, vo, swc, sor = fluid
    XP, XN = Fx.clamp_min(0.0), Fx.clamp_max(0.0)
    YP, YN = Fy.clamp_min(0.0), Fy.clamp_max(0.0)
    fi, fp = q.clamp_min(0.0), q.clamp_max(0.0)
    dts_pv = dts_pv[:, None, None]

    def substep(s):
        S = (s - swc) / (1.0 - swc - sor)
        Mw = S * S / vw
        Mo = (1.0 - S) * (1.0 - S) / vo
        fw = Mw / (Mw + Mo)
        Fw_x = XP * F.pad(fw, (0, 0, 1, 0)) + XN * F.pad(fw, (0, 0, 0, 1))
        Fw_y = YP * F.pad(fw, (1, 0)) + YN * F.pad(fw, (0, 1))
        div = (Fw_x[..., 1:, :] - Fw_x[..., :-1, :]) + (Fw_y[..., :, 1:] - Fw_y[..., :, :-1])
        s_new = s + dts_pv * (fi + fp * fw - div)
        return torch.clamp(s_new, swc, 1.0 - sor)

    n_max = int(n_sub.max()) if n_sub.numel() else 0
    for k in range(n_max):
        s = torch.where((k < n_sub)[:, None, None], substep(s), s)
    return s


def transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, runtime_grid=None):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device; a `q` with one member is read by every member in place.
    The templated kernel runs the grids of `_build.GRIDS` and the
    runtime-grid variant any other; `runtime_grid=True` takes the variant
    at any grid (launches counted as "transport_upwind_rt")."""
    B, Nx, Ny = s.shape
    check_grid(Nx, Ny)
    shapes = {"s": (s, (B, Nx, Ny)), "Fx": (Fx, (B, Nx + 1, Ny)),
              "Fy": (Fy, (B, Nx, Ny + 1)), "q": (q, (1 if q.shape[0] == 1 else B, Nx, Ny)),
              "dts_pv": (dts_pv, (B,))}
    for name, (t, shape) in shapes.items():
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need float32 CUDA {shape}, got "
                             f"{t.dtype} {t.device} {tuple(t.shape)}")
    if not n_sub.is_cuda or n_sub.dtype != torch.int32 or tuple(n_sub.shape) != (B,):
        raise ValueError("n_sub: need int32 CUDA (B,)")
    s, Fx, Fy, q, dts_pv, n_sub = (t.contiguous() for t in (s, Fx, Fy, q, dts_pv, n_sub))
    out = torch.empty_like(s)
    if B == 0:
        return out
    vw, vo, swc, sor = (float(v) for v in fluid)
    q_stride = 0 if q.shape[0] == 1 else Nx * Ny
    rt = (Nx, Ny) not in _build.GRIDS if runtime_grid is None else runtime_grid
    name = "transport_upwind_rt" if rt else "transport_upwind"
    fn = _build.lib().hm_transport_substeps_rt if rt else _build.lib().hm_transport_substeps
    code = fn(s.data_ptr(), Fx.data_ptr(), Fy.data_ptr(), q.data_ptr(), q_stride,
              dts_pv.data_ptr(), n_sub.data_ptr(), out.data_ptr(), B, Nx, Ny, vw, vo, swc, sor,
              _build.stream_ptr(s.device))
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out


def transport_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid):
    """Run every member's `n_sub` substeps: the kernel on CUDA, the plain
    version on the CPU. Leading dims of `s` are flattened to one member axis."""
    lead = s.shape[:-2]
    Nx, Ny = s.shape[-2:]
    args = (s.reshape(-1, Nx, Ny), Fx.reshape(-1, Nx + 1, Ny), Fy.reshape(-1, Nx, Ny + 1),
            q.reshape(-1, Nx, Ny), dts_pv.reshape(-1), n_sub.reshape(-1))
    fn = transport_substeps_cuda if s.is_cuda else transport_substeps_torch
    return fn(*args, fluid).reshape(*lead, Nx, Ny)
