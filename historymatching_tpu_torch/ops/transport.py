"""Kernel K: all CFL substeps of one outer transport step, for every member.

Replaces the TPU kernels of `historymatching_tpu/ops/transport_pallas.py`
(`transport_substeps_pallas`, `_batched`, `_packed`): on the card one
thread block per member loops over that member's own substep count
(`csrc/transport_upwind.cu`: a template on the grid for the grids of
`_build.GRIDS`; a variant with the grid as a runtime argument for any
other grid of up to BAND_CELLS cells (or whose two fw tiles fit one
block's shared memory and no cluster takes it); K-cl, a thread-block
cluster a member, each block a band of rows (`cl_shape`), for larger
grids; K-gm, a member over co-resident blocks, each a band of rows
(`gm_bands`), the bands' edge rows exchanged through L2, for the grids
left; and past K-gm's capacity K-gm1, the runtime-grid variant with its fw
tiles in device memory, one block a member; `route` says which a grid
takes). Beside it,
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


ROUTES = ("templated", "rt", "cl", "gm", "gm1")
NAMES = {"templated": "transport_upwind", "rt": "transport_upwind_rt",
         "cl": "transport_upwind_cl", "gm": "transport_upwind_gm",
         "gm1": "transport_upwind_gm1"}  # launch counters by route
BAND_CELLS = 4096  # a K-cl rank's band at most: the templated 64x64 block's load
MAX_THREADS, MIN_STRIP, MAX_STRIP = 1024, 4, 16
# K-gm: rows a thread's strip (csrc `kStrip`), threads a block at most
# (`kGmThreads`), and bands a member at most: the H100's SMs, so that one
# member's blocks, one an SM, are resident at once.
GM_STRIP, GM_THREADS, GM_MAX_BANDS = 4, 1024, 132


def smem_bytes(Nx, Ny):
    """Shared memory K and its runtime-grid variant take for one member:
    two fw tiles of the grid. K-gm puts the same tiles in device memory."""
    return 2 * 4 * Nx * Ny


def check_grid(Nx, Ny):
    """Raise unless kernel K takes an Nx x Ny grid: any grid with a cell,
    through one of its routes."""
    if Nx < 1 or Ny < 1:
        raise ValueError(f"transport kernel: a {Nx}x{Ny} grid has no cells")


def cl_shape(Nx, Ny):
    """K-cl's cluster for a grid: (c, strip), the smallest power of two c
    up to 16 that divides Nx into bands of at most BAND_CELLS cells, and
    the strip (cells a thread along i), the smallest divisor of the band's
    rows from MIN_STRIP up (or the band's rows, where fewer) that keeps a
    block at MAX_THREADS; None where no cluster takes the grid."""
    for c in (2, 4, 8, 16):
        h = Nx // c
        if Nx % c or h * Ny > BAND_CELLS:
            continue
        for strip in range(min(MIN_STRIP, h), min(MAX_STRIP, h) + 1):
            if h % strip == 0 and h // strip * Ny <= MAX_THREADS:
                return c, strip
    return None


def gm_bands(Nx, Ny):
    """K-gm's bands of a member: [(first row, rows)] of the G bands, G the
    fewest whose largest band (ceil(Nx / G) rows) a block of GM_THREADS
    threads holds in strips of GM_STRIP rows, one column a thread (at most
    GM_STRIP * (GM_THREADS // Ny) rows); the first Nx mod G bands take one
    row more. None past K-gm's capacity: a row wider than a block
    (Ny > GM_THREADS), or more than GM_MAX_BANDS bands."""
    check_grid(Nx, Ny)
    rows = GM_STRIP * (GM_THREADS // Ny)
    if rows == 0 or -(-Nx // rows) > GM_MAX_BANDS:
        return None
    G = -(-Nx // rows)
    h, rem = divmod(Nx, G)
    sizes = [h + 1] * rem + [h] * (G - rem)
    return [(sum(sizes[:r]), sizes[r]) for r in range(G)]


def route(Nx, Ny):
    """Which kernel K takes a grid: "templated" at `_build.GRIDS`, "rt" up
    to BAND_CELLS cells, "cl" where a cluster takes it (`cl_shape`), "rt"
    where the two fw tiles fit one block's shared memory
    (`_build.SMEM_LIMIT`), else "gm" where `gm_bands` gives a plan and
    "gm1" past it."""
    check_grid(Nx, Ny)
    if (Nx, Ny) in _build.GRIDS:
        return "templated"
    if Nx * Ny <= BAND_CELLS:
        return "rt"
    if cl_shape(Nx, Ny):
        return "cl"
    if smem_bytes(Nx, Ny) <= _build.SMEM_LIMIT:
        return "rt"
    return "gm" if gm_bands(Nx, Ny) else "gm1"


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


def transport_substeps_cuda(s, Fx, Fy, q, dts_pv, n_sub, fluid, force=None):
    """The hand kernel. Same arguments as the plain version, float32 on one
    CUDA device; a `q` with one member is read by every member in place.
    The grid's `route` picks the templated kernel, the runtime-grid
    variant, K-cl, K-gm or K-gm1; `force` (one of `ROUTES`) picks one at
    any grid (the templated kernel only at `_build.GRIDS`, K-cl where
    `cl_shape` gives a cluster, K-gm where `gm_bands` gives bands)."""
    B, Nx, Ny = s.shape
    if force not in (None, *ROUTES):
        raise ValueError(f"force must be one of {ROUTES} or None, got {force!r}")
    rt = route(Nx, Ny) if force is None else force
    band = cl_shape(Nx, Ny) if rt == "cl" else None
    if rt == "cl" and band is None:
        raise ValueError(f"transport kernel: no cluster takes a {Nx}x{Ny} grid")
    bands = gm_bands(Nx, Ny) if rt == "gm" else None
    if rt == "gm" and bands is None:
        raise ValueError(f"transport kernel: no band plan of K-gm takes a {Nx}x{Ny} grid")
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
    args = (s.data_ptr(), Fx.data_ptr(), Fy.data_ptr(), q.data_ptr(), q_stride,
            dts_pv.data_ptr(), n_sub.data_ptr(), out.data_ptr())
    tail = (B, Nx, Ny, vw, vo, swc, sor, _build.stream_ptr(s.device))
    if rt == "gm":  # each band's edge rows in two slots, and the substeps it published
        G = len(bands)
        halo = torch.empty(B * G * 4 * Ny, dtype=torch.float32, device=s.device)
        flags = torch.zeros(B * G, dtype=torch.int32, device=s.device)
        code = _build.lib().hm_transport_substeps_gm(
            *args, halo.data_ptr(), flags.data_ptr(), B, Nx, Ny, G, *tail[3:])
    elif rt == "gm1":
        ws = torch.empty(B * smem_bytes(Nx, Ny) // 4, dtype=torch.float32, device=s.device)
        code = _build.lib().hm_transport_substeps_gm1(*args, ws.data_ptr(), *tail)
    elif rt == "cl":
        code = _build.transport_cl_lib(Nx, Ny, *band).hm_transport_substeps_cl(*args, *tail)
    else:
        lib = _build.lib()
        fn = lib.hm_transport_substeps_rt if rt == "rt" else lib.hm_transport_substeps
        code = fn(*args, *tail)
    _build.check(code, NAMES[rt])
    _build.LAUNCHES[NAMES[rt]] += 1
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
