"""What the CPU can check of the hand kernels' contract: the grids the
main libraries instantiate, the grids the kernels take and refuse, and the
device the port's entry points default to. The kernels themselves run
only on the card (tests/test_torch_kernels_cuda.py)."""

import os
import re

import pytest
import torch

from historymatching_tpu_torch import ResSim
from historymatching_tpu_torch.ops import pressure, transport
from historymatching_tpu_torch.ops._build import CSRC, GRIDS, SMEM_LIMIT
from historymatching_tpu_torch.ops.multigrid import build_hierarchy_5pt, n_levels
from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda, smem_bytes
from historymatching_tpu_torch.ops.transport import transport_substeps_cuda


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_grid_list_matches_the_cuda_header():
    with open(os.path.join(CSRC, "grids.cuh")) as f:
        line = next(ln for ln in f if ln.startswith("#define HM_FOR_GRIDS"))
    pairs = re.findall(r"F\((\d+), (\d+)\)", line)
    assert tuple((int(a), int(b)) for a, b in pairs) == GRIDS


def _call(kernel, Nx, Ny, unit_diag=True):
    """The wrapper on CPU tensors of the right shapes: its grid check runs
    first, then it refuses the CPU tensors."""
    z = torch.zeros(2, Nx, Ny)
    if kernel == "pressure":
        hier = build_hierarchy_5pt(torch.zeros(2, Nx - 1, Ny), torch.zeros(2, Nx, Ny - 1), z)
        nc = hier[-1][2][0].numel()
        pressure_solve_cuda(hier, torch.zeros(2, nc, nc), z, z, z, tol=1e-3, maxiter=8,
                            unit_diag=unit_diag)
    else:
        transport_substeps_cuda(z, torch.zeros(2, Nx + 1, Ny), torch.zeros(2, Nx, Ny + 1), z,
                                torch.ones(2), torch.ones(2, dtype=torch.int32),
                                (1.0, 1.0, 0.0, 0.0))


def _need(kernel, Nx, Ny, unit_diag=True):
    if kernel == "transport":
        return 8 * Nx * Ny
    return smem_bytes(Nx, Ny, n_levels(Nx, Ny), unit_diag)


@pytest.mark.parametrize("kernel", ["pressure", "transport"])
@pytest.mark.parametrize("Nx,Ny", [(24, 24), (64, 32), (128, 128)])
def test_uninstantiated_grid_raises(kernel, Nx, Ny):
    """A grid outside `GRIDS` is taken where its layout fits one block's
    shared memory (the wrapper gets past its grid check to the CPU tensors'
    refusal), and refused with the bytes it would need where it does not
    (P at 128x128 needs 458,528 bytes)."""
    need = _need(kernel, Nx, Ny)
    if need > SMEM_LIMIT:
        with pytest.raises(ValueError, match=f"{Nx}x{Ny} grid needs {need} bytes of shared"):
            _call(kernel, Nx, Ny)
    else:
        with pytest.raises(ValueError, match="need float32 CUDA"):
            _call(kernel, Nx, Ny)


@pytest.mark.parametrize("kernel,Nx,Ny,unit_diag,need", [
    ("pressure", 96, 96, True, 257_584),
    ("pressure", 80, 80, False, 231_872),
    ("pressure", 96, 64, False, None),
    ("transport", 171, 171, True, 233_928),
    ("transport", 8, 3632, True, 232_448),
])
def test_shared_memory_limit(kernel, Nx, Ny, unit_diag, need):
    """At and around the 232,448 bytes one block may take: the byte counts
    of the layouts, and the refusal that names them."""
    got = _need(kernel, Nx, Ny, unit_diag)
    if need is not None:
        assert got == need
    if got > SMEM_LIMIT:
        with pytest.raises(ValueError, match=f"needs {got} bytes"):
            _call(kernel, Nx, Ny, unit_diag)
    else:
        with pytest.raises(ValueError, match="need float32 CUDA"):
            _call(kernel, Nx, Ny, unit_diag)


@pytest.mark.parametrize("Nx,Ny", [(15, 15), (12, 9), (4, 4), (6, 5)])
def test_pressure_kernel_needs_a_hierarchy(Nx, Ny):
    """Grids without a multigrid hierarchy take the plain Jacobi-PCG (in
    torch ops on either device); kernel P refuses them, K takes them."""
    assert n_levels(Nx, Ny) < 2
    with pytest.raises(ValueError, match="has no multigrid hierarchy"):
        pressure.check_grid(Nx, Ny)
    transport.check_grid(Nx, Ny)


def test_build_defaults_to_the_card():
    """Without `device` the model lands on CUDA; on a host without CUDA the
    call raises torch's own error instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert ResSim.build(Nx=16, Ny=16).K.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ResSim.build(Nx=16, Ny=16)
    assert ResSim.build(Nx=16, Ny=16, device="cpu").K.device.type == "cpu"
