"""What the CPU can check of the hand kernels' contract: the grids they
are instantiated for, the refusal of any other grid, and the device the
port's entry points default to. The kernels themselves run only on the
card (tests/test_torch_kernels_cuda.py)."""

import os
import re

import pytest
import torch

from historymatching_tpu_torch import ResSim
from historymatching_tpu_torch.ops._build import CSRC, GRIDS
from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda
from historymatching_tpu_torch.ops.transport import transport_substeps_cuda


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_grid_list_matches_the_cuda_header():
    with open(os.path.join(CSRC, "grids.cuh")) as f:
        line = next(ln for ln in f if ln.startswith("#define HM_FOR_GRIDS"))
    pairs = re.findall(r"F\((\d+), (\d+)\)", line)
    assert tuple((int(a), int(b)) for a, b in pairs) == GRIDS


@pytest.mark.parametrize("kernel", ["pressure", "transport"])
@pytest.mark.parametrize("Nx,Ny", [(24, 24), (64, 32), (128, 128)])
def test_uninstantiated_grid_raises(kernel, Nx, Ny):
    """Refused before any tensor is looked at, so CPU tensors show it."""
    z = torch.zeros(2, Nx, Ny)
    names = ", ".join(f"{a}x{b}" for a, b in GRIDS)
    with pytest.raises(ValueError, match=f"instantiated for the grids {names}; got {Nx}x{Ny}"):
        if kernel == "pressure":
            pressure_solve_cuda([], torch.zeros(2, 16, 16), z, z, z, tol=1e-3, maxiter=8)
        else:
            transport_substeps_cuda(z, z, z, z, torch.ones(2), torch.ones(2, dtype=torch.int32),
                                    (1.0, 1.0, 0.0, 0.0))


def test_build_defaults_to_the_card():
    """Without `device` the model lands on CUDA; on a host without CUDA the
    call raises torch's own error instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert ResSim.build(Nx=16, Ny=16).K.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ResSim.build(Nx=16, Ny=16)
    assert ResSim.build(Nx=16, Ny=16, device="cpu").K.device.type == "cpu"
