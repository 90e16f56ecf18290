"""Builds and loads the hand-written CUDA kernels of `csrc/`.

`nvcc` compiles each `csrc/*.cu` into its own shared library with a plain
C interface, for `sm_90a` (Hopper), on first use, into `_build/` beside
the package; the compilers run in parallel. A library's name carries a
hash of its source, the shared headers and the flags, so an edited source
rebuilds. The libraries are loaded with `ctypes`; each C entry point
returns `cudaGetLastError()` after its launch, and `check` raises on a
non-zero code.

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

# The grids every kernel is instantiated for (csrc/grids.cuh).
GRIDS = ((16, 16), (20, 20), (32, 32), (64, 64))

# Launches by kernel; P's Chebyshev instantiation counts on its own.
LAUNCHES = {"transport_upwind": 0, "pressure_pcg": 0, "pressure_pcg_cheb": 0}

_lib = None
build_info = {}

P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# Per source file, its C entry points and their argument types.
_SIGNATURES = {
    "transport_upwind": {
        # s, Fx, Fy, q, q_stride, dts_pv, n_sub, out, B, Nx, Ny, vw, vo, swc, sor, stream
        "hm_transport_substeps": [P, P, P, P, I, P, P, P, I, I, I, D, D, D, D, P],
        "hm_transport_info": [I, I, P],
    },
    "pressure_pcg": {
        # level pointers, Ainv, q, p0, w, p_out, it_out, rel_out, B, Nx, Ny,
        # n_levels, tol, maxiter, restart_every, patience, cheb, stream
        "hm_pressure_solve": [P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I, P],
        "hm_pressure_info": [I, I, I, P],
    },
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_grid(kernel, Nx, Ny):
    """Raise unless the kernels are instantiated for an (Nx, Ny) grid."""
    if (Nx, Ny) not in GRIDS:
        names = ", ".join(f"{a}x{b}" for a, b in GRIDS)
        raise ValueError(f"{kernel} kernel is instantiated for the grids {names}; got {Nx}x{Ny}")


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def lib():
    """The kernels' C entry points, built first where their sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    headers = b"".join(os.path.basename(h).encode() + _read(h)
                       for h in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
    paths, jobs = {}, {}
    for stem in _SIGNATURES:
        src = os.path.join(CSRC, f"{stem}.cu")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + headers + _read(src)).hexdigest()
        paths[stem] = so = os.path.join(BUILD_DIR, f"lib{stem}_{h[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            jobs[stem] = (tmp, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True))
    ptxas = {}
    for stem, (tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu ({proc.returncode}):\n{err[-8000:]}")
        os.replace(tmp, paths[stem])
        ptxas[stem] = err
    fns = {}
    for stem, sigs in _SIGNATURES.items():
        handle = ctypes.CDLL(paths[stem])
        for name, argtypes in sigs.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    build_info.update(paths=paths, built=sorted(jobs), ptxas=ptxas,
                      seconds=time.perf_counter() - t0)
    _lib = types.SimpleNamespace(**fns)
    return _lib


def check(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def kernel_info(kernel, Nx, Ny):
    """A kernel's resources at one grid, as the CUDA runtime reports them:
    registers and local (stack and spill) bytes a thread, dynamic shared
    bytes and threads a block, resident blocks an SM."""
    check_grid(kernel, Nx, Ny)
    out = (ctypes.c_int * 5)()
    fn, extra = {"pressure_pcg": ("hm_pressure_info", (0,)),
                 "pressure_pcg_cheb": ("hm_pressure_info", (1,)),
                 "transport_upwind": ("hm_transport_info", ())}[kernel]
    check(getattr(lib(), fn)(Nx, Ny, *extra, out), kernel)
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")
    return dict(zip(keys, out))


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
