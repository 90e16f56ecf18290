"""Builds and loads the hand-written CUDA kernels of `csrc/`.

`nvcc` compiles each `csrc/*.cu` into its own shared library with a plain
C interface, for `sm_90a` (Hopper), on first use, into `_build/` beside
the package; the compilers run in parallel. Kernel P is a template on the
grid: the main library holds the grids of `GRIDS`, and any other grid is
compiled on first use into a library of its own (`pressure_lib`);
`prebuild` starts every compiler a run will need at once (or, with
`wait=False`, builds the main libraries and compiles the others in the
background, a few at a time, while the run works). Kernel K's
strip body is compiled likewise for any other grid whose strips fit one
block (K-rt, `transport_rt_lib`). The device-memory variants P-gm1
(`pressure_pcg_gm1.cu`), K-gm and K-gm1's device-memory body (beside K)
take the grid at run time, so one library serves every grid; K-gm's plans
other than its first (strips of 4 rows, one column a thread) get one
library each (`transport_gm_lib`), and so does each strip shape, face
placement and thread bound of the tile body that K-rt1 and K-gm1's tiles
run (`transport_tile_lib`); P-gm (`pressure_pcg_gm.cu`) is a template on the
grid and its plan, one library each, built on first use
(`pressure_gm_lib`).
The cluster variants (P-cl in `pressure_pcg_cl.cu`, K-cl in `transport_upwind.cu`
under `-DHM_KCL_*`) are templates on the grid and the cluster size (P-cl
also on the coarsest inverse's place, K-cl on its plan), one library each,
built on first use (`pressure_cl_lib`, `transport_cl_lib`; P-cl's probe build beside it,
`pressure_cl_lib(..., probe=True)`).
A library's
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
import threading
import time
import types

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The grids the main libraries instantiate (csrc/grids.cuh).
GRIDS = ((16, 16), (20, 20), (32, 32), (64, 64))
# Shared memory one thread block may opt into on the H100 (sm_90), and the
# most a block may take for two to be resident on an SM (228 KB an SM, 1 KB
# of each block reserved).
SMEM_LIMIT = 232_448
SMEM_TWO_A_SM = 115_712
SMEM_PER_SM = 228 * 1024  # an SM's shared memory, 1 KB of it reserved for each block

# Launches by kernel: K's templated body, K-rt (the same body built for
# another grid), K-rt1 (the tile body, a member in one block), the
# co-resident, device-memory and cluster variants, and P by smoother, by
# fine diagonal (unit, or read: the unscaled system) and by route (shared
# memory, "_gm": co-resident blocks a member, "_gm1": device memory, one
# block a member, "_cl": a thread-block cluster a member); and the exact
# oracle's float64 banded Cholesky (`banded_cholesky.cu`).
_P_NAMES = ("pressure_pcg", "pressure_pcg_cheb", "pressure_pcg_diag", "pressure_pcg_cheb_diag")
LAUNCHES = dict.fromkeys(("transport_upwind", "transport_upwind_rt", "transport_upwind_rt1",
                          *_P_NAMES,
                          "transport_upwind_gm", "transport_upwind_gm1",
                          *(n + "_gm" for n in _P_NAMES), *(n + "_gm1" for n in _P_NAMES),
                          "transport_upwind_cl", *(n + "_cl" for n in _P_NAMES),
                          "banded_cholesky"), 0)

_libs = {}
_pending = {}  # library key -> an event set when `start`'s compiler of it has finished
_done = {}  # library key -> (path, temporary path, return code, report) from `start`
_keys = {}  # (spec maker, its arguments) -> library key
build_info = {"paths": {}, "built": [], "ptxas": {}, "seconds": 0.0}

P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# Per source file, its C entry points and their argument types.
_TRANSPORT = [P, P, P, P, I, P, P, P, I, I, I, D, D, D, D, P]
# level pointers, Ainv, q, p0, w, p_out, it_out, rel_out, B, Nx, Ny,
# n_levels, tol, maxiter, restart_every, patience, cheb, unit, stream
_PRESSURE = [P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I, I, P]
_SIGNATURES = {
    "transport_upwind": {
        # s, Fx, Fy, q, q_stride, dts_pv, n_sub, out, B, Nx, Ny, vw, vo, swc, sor, stream
        "hm_transport_substeps": _TRANSPORT,
        # the same with the halo and the flags after `out`, the bands after Ny
        "hm_transport_substeps_gm": _TRANSPORT[:8] + [P, P] + _TRANSPORT[8:11] + [I]
        + _TRANSPORT[11:],
        # the same with the fw workspace and the groups' barrier counts after
        # `out`, the blocks a member and the groups after Ny
        "hm_transport_substeps_gm1": _TRANSPORT[:8] + [P, P] + _TRANSPORT[8:11] + [I, I]
        + _TRANSPORT[11:],
        "hm_transport_info": [I, I, P],
        "hm_transport_gm_info": [I, I, I, P],
        "hm_transport_gm1_info": [P],
    },
    "pressure_pcg": {
        "hm_pressure_solve": _PRESSURE,
        "hm_pressure_info": [I, I, I, I, P],
    },
    "banded_cholesky": {
        # ab, q, p, ucol, info, B, n, kd, pairs a thread, threads, stream
        "hm_banded_solve": [P, P, P, P, P, I, I, I, I, I, P],
        # kd, pairs a thread, threads, out
        "hm_banded_info": [I, I, I, P],
    },
    "pressure_pcg_gm1": {
        # level pointers, Ainv, q, p0, w, p_out, it_out, rel_out, workspace,
        # plan table, B, tol, maxiter, restart_every, patience, cheb, unit,
        # stream
        "hm_pressure_gm1_solve": [P, P, P, P, P, P, P, P, P, P, I, F, I, I, I, I, I, P],
        # threads, shared bytes, cheb, unit, out
        "hm_pressure_gm1_info": [I, I, I, I, P],
    },
}
_MAIN = tuple(_SIGNATURES)  # the main libraries' sources
# The per-grid libraries: P-gm (the arguments of P with the groups'
# exchange, their flags and the groups they hold after rel_out), P-cl's
# source, and K's under -DHM_KCL_* (K-cl), -DHM_KRT_* (K-rt) and, per plan,
# -DHM_KGM_* (K-gm).
_SIGNATURES["pressure_pcg_gm"] = {"hm_pressure_gm_solve": _PRESSURE[:8] + [P, P, I] + _PRESSURE[8:],
                                  "hm_pressure_gm_info": [I, I, I, I, P]}
_SIGNATURES["pressure_pcg_cl"] = {"hm_pressure_cl_solve": _PRESSURE,
                                  "hm_pressure_cl_info": [I, I, I, I, P]}
# P-cl's probe build (-DHM_CL_PROBE) adds its barrier count and its layout
_SIGNATURES["pressure_pcg_cl_probe"] = dict(_SIGNATURES["pressure_pcg_cl"],
                                        hm_pressure_cl_barriers=[P],
                                        hm_pressure_cl_layout=[I, P])
_SIGNATURES["transport_upwind_cl"] = {"hm_transport_substeps_cl": _TRANSPORT,
                                      "hm_transport_cl_info": [I, I, P]}
_SIGNATURES["transport_upwind_rt"] = {"hm_transport_substeps_rt": _TRANSPORT,
                                      "hm_transport_rt_info": [I, I, P]}
# the tile body: K-gm's arguments with the tiles a member along i and j
# and the threads a block after Ny
_SIGNATURES["transport_upwind_tile"] = {
    "hm_transport_substeps_tile": _TRANSPORT[:8] + [P, P] + _TRANSPORT[8:11] + [I, I, I]
    + _TRANSPORT[11:],
    "hm_transport_tile_info": [I, I, I, I, I, P]}
_SIGNATURES["transport_upwind_gm"] = {
    k: _SIGNATURES["transport_upwind"][k] for k in ("hm_transport_substeps_gm",
                                                    "hm_transport_gm_info")}


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


def _spec(stem, grid=None, key=None, flags=None, sigs=None):
    """(key, stem, extra flags, library path, signature set) of a source,
    built for one grid where `grid` is given (with `-DHM_GRID_NX/NY`, or
    the `flags` given)."""
    if flags is None:
        flags = [] if grid is None else [f"-DHM_GRID_NX={grid[0]}", f"-DHM_GRID_NY={grid[1]}"]
    headers = b"".join(os.path.basename(h).encode() + _read(h)
                       for h in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
    src = os.path.join(CSRC, f"{stem}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode() + headers + _read(src)).hexdigest()
    key = key or (stem if grid is None else f"{stem}_{grid[0]}x{grid[1]}")
    return key, stem, flags, os.path.join(BUILD_DIR, f"lib{key}_{h[:16]}.so"), sigs or stem


def _cl_specs(Nx, Ny, pressure_plans=(), transport_plan=None, probe=False):
    """The cluster libraries of one grid: P-cl for each (c, place of the
    inverse) plan, on `cl_threads`' threads a rank (its probe build with
    `probe`), K-cl for a plan (`ops.transport.ClPlan`), asking for the
    ranks an SM that `ops.transport.cl_ranks` counts."""
    from historymatching_tpu_torch.ops.pressure import INV_PLACES, cl_threads

    tag = {"shared": "s", "device": "g", "distributed": "d"}
    end, extra = ("_probe", ["-DHM_CL_PROBE"]) if probe else ("", [])
    specs = [_spec("pressure_pcg_cl", key=f"pressure_pcg_cl_{Nx}x{Ny}_c{c}{tag[place]}{end}",
                   flags=[f"-DHM_GRID_NX={Nx}", f"-DHM_GRID_NY={Ny}", f"-DHM_CL={c}",
                          f"-DHM_CL_INV={INV_PLACES[place]}",
                          f"-DHM_CL_THREADS={cl_threads(Nx, Ny, c, place)}", *extra],
                   sigs="pressure_pcg_cl" + end)
             for c, place in dict.fromkeys(pressure_plans)]
    if transport_plan is not None:
        from historymatching_tpu_torch.ops.transport import cl_ranks

        c, strip = transport_plan
        ranks = cl_ranks(Nx, Ny, transport_plan)
        specs.append(_spec("transport_upwind",
                           key=f"transport_upwind_cl_{Nx}x{Ny}_c{c}s{strip}r{ranks}",
                           flags=[f"-DHM_KCL_NX={Nx}", f"-DHM_KCL_NY={Ny}", f"-DHM_KCL_C={c}",
                                  f"-DHM_KCL_S={strip}", f"-DHM_KCL_R={ranks}"],
                           sigs="transport_upwind_cl"))
    return specs


def _compile(stem, flags, so):
    """Start nvcc on `stem` into `so` (through a temporary file); returns a
    function that waits for it and gives (so, temporary path, return code,
    ptxas's report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    src = os.path.join(CSRC, f"{stem}.cu")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, src],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def finish():
        _, err = proc.communicate()
        return so, tmp, proc.returncode, err

    return finish


def start(specs, jobs=3):
    """Compile the libraries of `specs` not built, loaded or started yet in
    the background, `jobs` compilers at a time, and return at once; the
    first `_load` of each waits for its compiler. A run starts what it
    needs later while it works on the libraries it has, without taking
    every core from it."""
    slots = threading.Semaphore(jobs)

    def one(key, stem, flags, so, done):
        try:
            with slots:
                _done[key] = _compile(stem, flags, so)()
        except Exception as e:  # noqa: BLE001  (reported by the `_load` that waits)
            _done[key] = so, None, -1, repr(e)
        finally:
            done.set()

    for key, stem, flags, so, _ in specs:
        if key not in _libs and key not in _pending and not os.path.exists(so):
            _pending[key] = done = threading.Event()
            threading.Thread(target=one, args=(key, stem, flags, so, done), daemon=True).start()


def _load(specs):
    """Build (all compilers at once; those `start` started, as they come)
    and load the libraries of `specs` not loaded yet; each becomes a
    namespace of its C entry points in `_libs`."""
    specs = list({sp[0]: sp for sp in specs if sp[0] not in _libs}.values())
    if not specs:
        return
    t0 = time.perf_counter()
    jobs = {}
    for key, stem, flags, so, _ in specs:
        if key in _pending:
            jobs[key] = _pending.pop(key).wait
        elif not os.path.exists(so):
            jobs[key] = _compile(stem, flags, so)
    failed = []
    for key, finish in jobs.items():
        result = finish()
        so, tmp, code, err = _done.pop(key) if result is True else result
        if code != 0:
            failed.append(f"nvcc failed on {key} ({code}):\n{err[-4000:]}")
            continue
        os.replace(tmp, so)
        build_info["ptxas"][key] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    for key, _, _, so, sigs in specs:
        handle = ctypes.CDLL(so)
        fns = {}
        for name, argtypes in _SIGNATURES[sigs].items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _libs[key] = types.SimpleNamespace(**fns)
        build_info["paths"][key] = so
    build_info["built"] += sorted(jobs)
    build_info["seconds"] += time.perf_counter() - t0


def lib():
    """The main libraries' C entry points (K at `GRIDS`, K-gm's first plan,
    K-gm1's device-memory body, P at `GRIDS`, P-gm1, the banded Cholesky),
    built first where their sources changed."""
    if "main" not in _libs:
        _load([_spec(stem) for stem in _MAIN])
        _libs["main"] = types.SimpleNamespace(**{k: v for stem in _MAIN
                                                 for k, v in vars(_libs[stem]).items()})
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


def _get(make_spec, *args):
    """The library of the spec `make_spec(*args)`, built on first use. A
    spec hashes the sources (~0.5 ms), so it is made once for each
    argument tuple and a launch after it only looks its key up."""
    key = _keys.get((make_spec, args))
    if key is None:
        key, *_ = spec = make_spec(*args)
        if key not in _libs:
            _load([spec])
        _keys[make_spec, args] = key
    return _libs[key]


def _gm1_loads_spec():
    return _spec("pressure_pcg_gm1", key="pressure_pcg_gm1_loads", flags=["-DHM_GM1_LOADS"])


def pressure_gm1_loads_lib():
    """P-gm1's ring's control (`-DHM_GM1_LOADS`: the coarsest inverse read
    by plain loads from device memory, the product's order of summation
    kept), built on first use, for timing the ring against it."""
    return _get(_gm1_loads_spec)


def _pcl_spec(Nx, Ny, c, place, probe):
    return _cl_specs(Nx, Ny, [(c, place)], probe=probe)[0]


def pressure_cl_lib(Nx, Ny, c, place, probe=False):
    """P-cl's C entry points for one grid on clusters of `c` ranks, the
    coarsest inverse at `place` (`ops.pressure.INV_PLACES`), built on first
    use. With `probe`, its probe build (`-DHM_CL_PROBE`): the same kernel,
    counting the cluster barriers member 0's rank 0 passes
    (`hm_pressure_cl_barriers`), and the layout its `Geo` places
    (`hm_pressure_cl_layout`)."""
    return _get(_pcl_spec, Nx, Ny, c, place, probe)


def _gm_spec(Nx, Ny, G, kb):
    return _spec("pressure_pcg_gm", key=f"pressure_pcg_gm_{Nx}x{Ny}_g{G}k{kb}",
                 flags=[f"-DHM_GRID_NX={Nx}", f"-DHM_GRID_NY={Ny}", f"-DHM_GM_G={G}",
                        f"-DHM_GM_KB={kb}"])


def pressure_gm_lib(Nx, Ny, G, kb):
    """P-gm's C entry points for one grid on G blocks a member with `kb`
    inverse rows a banded block (`ops.pressure.gm_plan`), built on first
    use."""
    return _get(_gm_spec, Nx, Ny, G, kb)


def _kcl_spec(Nx, Ny, plan):
    return _cl_specs(Nx, Ny, transport_plan=plan)[0]


def transport_cl_lib(Nx, Ny, plan):
    """K-cl's C entry points for one grid on a plan (`ops.transport.ClPlan`:
    ranks, strip rows), built on first use."""
    return _get(_kcl_spec, Nx, Ny, plan)


def _rt_spec(Nx, Ny, strip, place):
    return _spec("transport_upwind", key=f"transport_upwind_rt_{Nx}x{Ny}_s{strip}{place[0]}",
                 flags=[f"-DHM_KRT_NX={Nx}", f"-DHM_KRT_NY={Ny}", f"-DHM_KRT_S={strip}",
                        f"-DHM_KRT_SHARED={int(place == 'shared')}"], sigs="transport_upwind_rt")


def transport_rt_lib(Nx, Ny, strip, place):
    """K-rt's C entry points: the strip body for one grid on strips of
    `strip` rows, the faces in "registers" or "shared" memory
    (`ops.transport.rt_plan`), built on first use."""
    return _get(_rt_spec, Nx, Ny, strip, place)


def _gm_threads(threads):
    """A K-gm library's thread bound: a block's threads in whole warps."""
    return -(-threads // 32) * 32


def _kgm_spec(strip, cols, threads):
    t = _gm_threads(threads)
    return _spec("transport_upwind", key=f"transport_upwind_gm_s{strip}w{cols}t{t}",
                 flags=[f"-DHM_KGM_S={strip}", f"-DHM_KGM_W={cols}", f"-DHM_KGM_T={t}"],
                 sigs="transport_upwind_gm")


def transport_gm_lib(strip, cols, threads):
    """K-gm's C entry points for strips of `strip` rows and `cols` columns a
    thread in blocks of `threads` threads (`ops.transport.gm_plan`): the
    main library's on the first plan (strips of 4 rows, one column), else a
    library of its own, built on first use."""
    from historymatching_tpu_torch.ops.transport import GM_STRIP

    if (strip, cols) == (GM_STRIP, 1):
        return lib()
    return _get(_kgm_spec, strip, cols, _gm_threads(threads))


# The tile body's library for a strip shape, a face placement
# (`ops/transport.TILE_FACES`), several tiles a member or one (K-gm1's
# plans, K-rt1's), and its thread bound: a block's threads rounded up to
# whole groups of four warps, which leaves ptxas's register cap as it is
# (registers go to a block four warps at a time; `ops.transport.reg_budget`).
_FACES = {"registers": 0, "shared": 1}


def _tile_threads(threads):
    return -(-threads // 128) * 128


def _tile_spec(strip, cols, faces, tiled, threads):
    t = _tile_threads(threads)
    return _spec("transport_upwind",
                 key=f"transport_upwind_tile_s{strip}w{cols}{faces[0]}{'g' * tiled}t{t}",
                 flags=[f"-DHM_KT_S={strip}", f"-DHM_KT_W={cols}", f"-DHM_KT_F={_FACES[faces]}",
                        f"-DHM_KT_G={int(tiled)}", f"-DHM_KT_T={t}"],
                 sigs="transport_upwind_tile")


def _tile_plan_spec(plan, tiled):
    """The tile body's library of a plan (`ops.transport.TilePlan`)."""
    return _tile_spec(plan.strip, plan.cols, plan.faces, tiled, plan.threads)


def transport_tile_lib(plan, tiled):
    """The tile body's C entry points for a plan (`ops.transport.TilePlan`):
    K-rt1's, and with `tiled` K-gm1's tiles; strips of `plan.strip` rows
    and `plan.cols` columns a thread, the faces in `plan.faces`, in blocks
    of the plan's threads, built on first use."""
    return _get(_tile_spec, plan.strip, plan.cols, plan.faces, bool(tiled),
                _tile_threads(plan.threads))


_gm1_resident = {}


def gm1_resident(device):
    """The blocks of K-gm1's device-memory body that the card of `device`
    holds at once (`hm_transport_gm1_info`), read once a card."""
    import torch

    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _gm1_resident:
        out = (ctypes.c_int * 7)()
        with torch.cuda.device(index):
            check(lib().hm_transport_gm1_info(out), "transport_upwind_gm1")
        _gm1_resident[index] = out[5]
    return _gm1_resident[index]


def _kt_specs(Nx, Ny):
    """The tile body's libraries for a grid's plans of K-rt1 and K-gm1
    (`rt1_plan`, `gm1_plan`)."""
    from historymatching_tpu_torch.ops import transport

    plans = (transport.rt1_plan(Nx, Ny), False), (transport.gm1_plan(Nx, Ny), True)
    return [_tile_plan_spec(p, tiled) for p, tiled in plans if p]


def _k_specs(Nx, Ny):
    """K's libraries of its own for a grid: K-rt where `rt_plan` gives a
    plan (its route, or `force`), K-gm where `gm_plan` gives one other than
    the first."""
    from historymatching_tpu_torch.ops import transport

    specs = []
    plan = transport.rt_plan(Nx, Ny)
    if plan:
        specs.append(_rt_spec(Nx, Ny, *plan))
    plan = transport.gm_plan(Nx, Ny)
    if plan and plan[1:] != (transport.GM_STRIP, 1):
        bands, strip, cols = plan
        specs.append(_kgm_spec(strip, cols, transport.gm_threads(
            Ny, max(h for _, h in bands), strip, cols)))
    return specs


def _cl_grid_specs(Nx, Ny):
    """The cluster libraries of a grid past one block: P-cl for both fine
    diagonals wherever a cluster holds the layout (its route, or `force`),
    K-cl where K's route is the cluster."""
    from historymatching_tpu_torch.ops import pressure, transport
    from historymatching_tpu_torch.ops.multigrid import n_levels

    plans = [pressure.cl_plan(Nx, Ny, unit) for unit in (True, False)
             if n_levels(Nx, Ny) >= 2 and pressure.route(Nx, Ny, unit) != "smem"]
    plans = [plan for plan in plans if plan]
    kcl = transport.cl_plan(Nx, Ny) if transport.route(Nx, Ny) == "cl" else None
    return _cl_specs(Nx, Ny, plans, kcl)


def prebuild(pressure_grids=(), cl_grids=(), cl_plans=(), gm_grids=(), k_grids=(),
             cl_probes=(), kcl_plans=(), kt_grids=(), wait=True):
    """Build the main libraries, kernel P's libraries for `pressure_grids`
    outside `GRIDS`, the cluster libraries of `cl_grids`, P-cl's for each
    (Nx, Ny, c, place) of `cl_plans` and its probe build for each of
    `cl_probes`, P-gm's for both fine diagonals' plans of each grid of
    `gm_grids`, K's own libraries of each grid of `k_grids` (`_k_specs`,
    and the tile body's for K-rt1's and K-gm1's plans, `_kt_specs`), the
    tile body's alone for each grid of `kt_grids`, and K-cl's for each
    (Nx, Ny, plan) of `kcl_plans`, every compiler at once. Without `wait`
    it builds the main libraries and only starts the others (`start`: a
    few compilers at a time, in the background)."""
    from historymatching_tpu_torch.ops.pressure import gm_plan

    extra = [g for g in dict.fromkeys(tuple(g) for g in pressure_grids) if g not in GRIDS]
    gm = [(*g, *plan) for g in gm_grids for plan in (gm_plan(*g, True), gm_plan(*g, False))
          if plan]
    main = [_spec(stem) for stem in _MAIN]
    specs = ([_spec("pressure_pcg", g) for g in extra]
             + [sp for g in cl_grids for sp in _cl_grid_specs(*g)]
             + [_cl_specs(Nx, Ny, [(c, place)])[0] for Nx, Ny, c, place in cl_plans]
             + [_cl_specs(Nx, Ny, [(c, place)], probe=True)[0] for Nx, Ny, c, place in cl_probes]
             + [_gm_spec(*args) for args in dict.fromkeys(gm)]
             + [sp for g in k_grids for sp in _k_specs(*g) + _kt_specs(*g)]
             + [sp for g in kt_grids for sp in _kt_specs(*g)]
             + [_kcl_spec(*args) for args in kcl_plans])
    if wait:
        _load(main + specs)
    else:
        _load(main)
        start(specs)


def check(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def kernel_info(kernel, Nx, Ny, plan=None):
    """A kernel's resources at one grid, as the CUDA runtime reports them:
    registers and local (stack and spill) bytes a thread, dynamic shared
    bytes and threads a block, resident blocks an SM. `kernel` is a key of
    `LAUNCHES`; K-rt reports its grid's library (`ops.transport.rt_plan`),
    and adds its strip's rows and the place of its faces; K-rt1 and K-gm1
    on their grid's plan (`ops.transport.rt1_plan`, `gm1_plan`), or on
    `plan`: the tile body's shared bytes a block, and
    adds its tiles a member, the members in flight and its plan, or K-gm1's
    device-memory body's static shared bytes, and adds the blocks the card
    holds at once and its plan (a GM1Device); P-gm1 ("_gm1", on its
    grid's `gm1_plan`) its plan's shared bytes; K-gm its shared bytes (two
    fw tiles, each thread's faces and sources), and adds its bands a
    member, the groups of bands (members in flight) the card holds at
    once, and its strip's rows and columns a thread
    (`ops.transport.gm_plan`); P-gm ("_gm", on its grid's `gm_plan`) its
    bytes a block, and adds its blocks
    a member and the groups (members in flight) the card holds at once; a
    cluster variant ("_cl", on its route's
    cluster, P-cl's `plan` or K-cl's, `ops.transport.ClPlan`) its bytes a
    rank, and adds the ranks a cluster and the clusters the card holds at
    once; K-cl also its plan."""
    from historymatching_tpu_torch.ops import pressure, transport

    out = (ctypes.c_int * 7)()
    extra = {}
    cheb, unit = int("cheb" in kernel), int("_diag" not in kernel)
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")
    if kernel == "banded_cholesky":  # the band of an Nx x Ny grid: kd = Ny
        from historymatching_tpu_torch.ops.banded import launch_plan

        per, threads = launch_plan(Ny)
        code = lib().hm_banded_info(Ny, per, threads, out)
        extra = dict(pairs_a_thread=per)
    elif kernel == "transport_upwind_cl":
        plan = transport.ClPlan(*(plan or transport.cl_plan(Nx, Ny)))
        code = transport_cl_lib(Nx, Ny, plan).hm_transport_cl_info(Nx, Ny, out)
        extra = plan._asdict()
    elif kernel == "transport_upwind_gm":
        plan = transport.gm_plan(Nx, Ny)
        if plan is None:
            raise ValueError(f"{kernel}: no band plan takes a {Nx}x{Ny} grid")
        bands, strip, cols = plan
        threads = transport.gm_threads(Ny, max(h for _, h in bands), strip, cols)
        code = transport_gm_lib(strip, cols, threads).hm_transport_gm_info(Nx, Ny, len(bands),
                                                                          out)
        keys += ("bands", "groups_resident")
        extra = dict(strip=strip, cols=cols)
    elif kernel == "transport_upwind_rt":
        plan = transport.rt_plan(Nx, Ny)
        if plan is None:
            raise ValueError(f"{kernel}: no strip plan takes a {Nx}x{Ny} grid")
        code = transport_rt_lib(Nx, Ny, *plan).hm_transport_rt_info(Nx, Ny, out)
        extra = dict(strip=plan[0], faces=plan[1])
    elif kernel in ("transport_upwind_rt1", "transport_upwind_gm1"):
        plan = transport._plan(kernel[-3:], Nx, Ny, None, plan)
        if isinstance(plan, transport.GM1Device):
            code = lib().hm_transport_gm1_info(out)
            keys += ("blocks",)
            extra = dict(plan=plan._asdict())
        else:
            code = transport_tile_lib(plan, kernel.endswith("gm1")).hm_transport_tile_info(
                Nx, Ny, plan.gr, plan.gc, plan.threads, out)
            keys += ("tiles", "groups_resident")
            extra = dict(plan=plan._asdict())
    elif kernel.startswith("transport"):
        code = lib().hm_transport_info(Nx, Ny, out)
    elif kernel.endswith("_cl"):
        plan = plan or pressure.cl_plan(Nx, Ny, bool(unit))
        code = pressure_cl_lib(Nx, Ny, *plan).hm_pressure_cl_info(Nx, Ny, cheb, unit, out)
    elif kernel.endswith("_gm"):
        plan = pressure.gm_plan(Nx, Ny, bool(unit))
        if plan is None:
            raise ValueError(f"{kernel}: no plan of P-gm fits a {Nx}x{Ny} grid")
        code = pressure_gm_lib(Nx, Ny, *plan).hm_pressure_gm_info(Nx, Ny, cheb, unit, out)
        keys += ("blocks", "groups_resident")
    elif kernel.endswith("_gm1"):
        plan = pressure.gm1_plan(Nx, Ny, bool(unit))
        code = lib().hm_pressure_gm1_info(plan.threads, plan.smem_bytes, cheb, unit, out)
    else:
        code = pressure_lib(Nx, Ny).hm_pressure_info(Nx, Ny, cheb, unit, out)
    check(code, kernel)
    if kernel.endswith("_cl"):
        keys += ("cluster", "max_active_clusters")
    return dict(zip(keys, out), **extra)


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
