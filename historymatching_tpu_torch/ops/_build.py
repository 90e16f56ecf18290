"""Builds and loads the hand-written CUDA kernels of `csrc/`.

`nvcc` compiles each `csrc/*.cu` into its own shared library with a plain
C interface, for `sm_90a` (Hopper), on first use, into `_build/` beside
the package; the compilers run in parallel. Kernel P is a template on the
grid: the main library holds the grids of `GRIDS`, and any other grid is
compiled on first use into a library of its own (`pressure_lib`);
`prebuild` starts every compiler a run will need at once. A library's
name carries a hash of its source, the shared headers and the flags, so an
edited source rebuilds. The libraries are loaded with `ctypes`; each C
entry point returns `cudaGetLastError()` after its launch, and `check`
raises on a non-zero code.

`LAUNCHES` counts kernel launches by kernel name. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
import types

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The grids the main libraries instantiate (csrc/grids.cuh).
GRIDS = ((16, 16), (20, 20), (32, 32), (64, 64))
# Shared memory one thread block may opt into on the H100 (sm_90).
SMEM_LIMIT = 232_448

# Launches by kernel: K's templated and runtime-grid variants, and P by
# smoother and by fine diagonal (unit, or read: the unscaled system).
LAUNCHES = {"transport_upwind": 0, "transport_upwind_rt": 0, "pressure_pcg": 0,
            "pressure_pcg_cheb": 0, "pressure_pcg_diag": 0, "pressure_pcg_cheb_diag": 0}

_libs = {}
build_info = {"paths": {}, "built": [], "ptxas": {}, "seconds": 0.0}

P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# Per source file, its C entry points and their argument types.
_TRANSPORT = [P, P, P, P, I, P, P, P, I, I, I, D, D, D, D, P]
_SIGNATURES = {
    "transport_upwind": {
        # s, Fx, Fy, q, q_stride, dts_pv, n_sub, out, B, Nx, Ny, vw, vo, swc, sor, stream
        "hm_transport_substeps": _TRANSPORT,
        "hm_transport_substeps_rt": _TRANSPORT,
        "hm_transport_info": [I, I, P],
        "hm_transport_rt_info": [I, I, P],
    },
    "pressure_pcg": {
        # level pointers, Ainv, q, p0, w, p_out, it_out, rel_out, B, Nx, Ny,
        # n_levels, tol, maxiter, restart_every, patience, cheb, unit, stream
        "hm_pressure_solve": [P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I, I, P],
        "hm_pressure_info": [I, I, I, I, P],
    },
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _spec(stem, grid=None):
    """(key, stem, extra flags, library path) of a source, built for one
    grid where `grid` is given."""
    flags = [] if grid is None else [f"-DHM_GRID_NX={grid[0]}", f"-DHM_GRID_NY={grid[1]}"]
    headers = b"".join(os.path.basename(h).encode() + _read(h)
                       for h in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
    src = os.path.join(CSRC, f"{stem}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode() + headers + _read(src)).hexdigest()
    key = stem if grid is None else f"{stem}_{grid[0]}x{grid[1]}"
    return key, stem, flags, os.path.join(BUILD_DIR, f"lib{key}_{h[:16]}.so")


def _load(specs):
    """Build (all compilers at once) and load the libraries of `specs` not
    loaded yet; each becomes a namespace of its C entry points in `_libs`."""
    specs = [sp for sp in specs if sp[0] not in _libs]
    if not specs:
        return
    t0 = time.perf_counter()
    jobs = {}
    for key, stem, flags, so in specs:
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            src = os.path.join(CSRC, f"{stem}.cu")
            jobs[key] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    for key, (so, tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key} ({proc.returncode}):\n{err[-8000:]}")
        os.replace(tmp, so)
        build_info["ptxas"][key] = err
    for key, stem, _, so in specs:
        handle = ctypes.CDLL(so)
        fns = {}
        for name, argtypes in _SIGNATURES[stem].items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _libs[key] = types.SimpleNamespace(**fns)
        build_info["paths"][key] = so
    build_info["built"] += sorted(jobs)
    build_info["seconds"] += time.perf_counter() - t0


def lib():
    """The main libraries' C entry points (K in both variants, P at
    `GRIDS`), built first where their sources changed."""
    if "main" not in _libs:
        _load([_spec(stem) for stem in _SIGNATURES])
        _libs["main"] = types.SimpleNamespace(**vars(_libs["transport_upwind"]),
                                              **vars(_libs["pressure_pcg"]))
    return _libs["main"]


def pressure_lib(Nx, Ny):
    """Kernel P's C entry points for one grid: the main library's for a grid
    of `GRIDS`, else the grid's own library, built on first use."""
    if (Nx, Ny) in GRIDS:
        return lib()
    key = f"pressure_pcg_{Nx}x{Ny}"
    if key not in _libs:
        _load([_spec("pressure_pcg", (Nx, Ny))])
    return _libs[key]


def prebuild(pressure_grids=()):
    """Build the main libraries and kernel P's libraries for
    `pressure_grids` outside `GRIDS`, every compiler at once."""
    extra = [g for g in dict.fromkeys(tuple(g) for g in pressure_grids) if g not in GRIDS]
    _load([_spec(stem) for stem in _SIGNATURES] + [_spec("pressure_pcg", g) for g in extra])


def check(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def kernel_info(kernel, Nx, Ny):
    """A kernel's resources at one grid, as the CUDA runtime reports them:
    registers and local (stack and spill) bytes a thread, dynamic shared
    bytes and threads a block, resident blocks an SM. `kernel` is a key of
    `LAUNCHES`."""
    out = (ctypes.c_int * 5)()
    if kernel.startswith("transport"):
        fn = lib().hm_transport_rt_info if kernel.endswith("_rt") else lib().hm_transport_info
        code = fn(Nx, Ny, out)
    else:
        code = pressure_lib(Nx, Ny).hm_pressure_info(Nx, Ny, int("cheb" in kernel),
                                                     int(not kernel.endswith("_diag")), out)
    check(code, kernel)
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")
    return dict(zip(keys, out))


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
