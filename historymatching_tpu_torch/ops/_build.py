"""Builds and loads the hand-written CUDA kernels of `csrc/`.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface, for `sm_90a` (Hopper), on first use, into `_build/` beside the
package. The library's name carries a hash of the sources and flags, so an
edited source rebuilds. It is loaded with `ctypes`; each C entry point
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

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"transport_upwind": 0, "pressure_pcg": 0}

_lib = None
build_info = {}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # s, Fx, Fy, q, dts_pv, n_sub, out, B, Nx, Ny, vw, vo, swc, sor, stream
    "hm_transport_substeps": [P, P, P, P, P, P, P, I, I, I, F, F, F, F, P],
    # hier, q, p0, w, p_out, it_out, rel_out, B, Nx, Ny, n_levels, hier_stride,
    # tol, maxiter, restart_every, patience, stream
    "hm_pressure_solve": [P, P, P, P, P, P, P, I, I, I, I, I, F, I, I, I, P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def lib():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    so = os.path.join(BUILD_DIR, f"libhm_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    built = False
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-8000:]}")
        os.replace(tmp, so)
        build_info["ptxas"] = r.stderr
        built = True
    handle = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=so, built=built, seconds=time.perf_counter() - t0)
    _lib = handle
    return _lib


def check(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
