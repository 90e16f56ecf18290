"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, in float32. Skipped without CUDA (this file imports no JAX, so it
also runs on a host without it: `python -m pytest --noconftest
tests/test_torch_kernels_cuda.py`).

Tolerances: K 1e-5 absolute on saturations (FMA contraction and operation
order over hundreds of substeps); P 1e-3 relative on p after fixed work
(block reductions sum in another order than torch)."""

import numpy as np
import pytest
import torch

from historymatching_tpu_torch.models.ressim import ResSim, scaled_system
from historymatching_tpu_torch.ops import _build
from historymatching_tpu_torch.ops.pressure import pressure_solve_cuda, pressure_solve_torch
from historymatching_tpu_torch.ops.transport import (
    transport_substeps,
    transport_substeps_torch,
)
from historymatching_tpu_torch.parallel.runner import set_perm

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _model(Nx, Ny, dev):
    near01 = np.array([0.12, 0.87])
    prd = [[x, y] for y in near01 for x in 2.0 * near01]
    return ResSim.build(Nx=Nx, Ny=Ny, Lx=2.0, Ly=1.0, inj_xy=[[1.0, 0.5]], prd_xy=prd,
                        inj_rates=[[1.0]], prd_rates=np.ones((4, 1)) / 4,
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("Nx,Ny", [(16, 16), (20, 20), (64, 64)])
def test_transport_kernel_matches_plain(dev, Nx, Ny):
    g = torch.Generator(device=dev).manual_seed(0)
    B = 8
    s = torch.rand(B, Nx, Ny, generator=g, device=dev)
    Fx = 0.1 * torch.randn(B, Nx + 1, Ny, generator=g, device=dev)
    Fy = 0.1 * torch.randn(B, Nx, Ny + 1, generator=g, device=dev)
    Fx[:, 0] = Fx[:, -1] = 0
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    dts_pv = torch.full((B,), 0.05, device=dev)
    n_sub = torch.arange(1, 8 * B, 8, dtype=torch.int32, device=dev)
    fluid = (1.0, 1.0, 0.0, 0.0)
    before = _build.LAUNCHES["transport_upwind"]
    out = transport_substeps(s, Fx, Fy, q, dts_pv, n_sub, fluid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transport_upwind"] == before + 1
    ref = transport_substeps_torch(s, Fx, Fy, q[None], dts_pv, n_sub, fluid)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("Nx,Ny", [(16, 16), (20, 20), (64, 64)])
def test_pressure_kernel_matches_plain(dev, Nx, Ny):
    g = torch.Generator(device=dev).manual_seed(1)
    m = _model(Nx, Ny, dev)
    B = 8
    mm = set_perm(m, torch.randn(B, m.Nxy, generator=g, device=dev))
    s = torch.zeros(B, Nx, Ny, device=dev)
    _, _, diag, sd, hier, Ainv = scaled_system(mm, s)
    q = torch.zeros(Nx, Ny, device=dev)
    q[Nx // 2, Ny // 2], q[1, 1] = 1.0, -1.0
    args = (hier, Ainv, (q * sd).contiguous(), torch.zeros_like(s), (diag * sd).contiguous())
    before = _build.LAUNCHES["pressure_pcg"]
    p_k, it_k, rel_k = pressure_solve_cuda(*args, tol=0.0, maxiter=16, patience_iters=160)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pressure_pcg"] == before + 1
    p_t, it_t, rel_t = pressure_solve_torch(*args, tol=0.0, maxiter=16, patience_iters=160)
    assert torch.equal(it_k, it_t)
    dn, nt = (p_k - p_t).norm(dim=(-2, -1)), p_t.norm(dim=(-2, -1))
    # zero from both: the member's weighted residual never improved on its start
    err = torch.where((dn == 0) & (nt == 0), 0.0, dn / nt)
    assert float(err.max()) <= 1e-3


def test_kernels_refuse_what_they_do_not_take(dev):
    s = torch.zeros(2, 8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        transport_substeps(s, torch.zeros(2, 9, 8, dtype=torch.float64, device=dev),
                           torch.zeros(2, 8, 9, dtype=torch.float64, device=dev), s,
                           torch.ones(2, dtype=torch.float64, device=dev),
                           torch.ones(2, dtype=torch.int32, device=dev), (1.0, 1.0, 0.0, 0.0))
    big = torch.zeros(1, 128, 128, device=dev)
    with pytest.raises(ValueError):
        transport_substeps(big, torch.zeros(1, 129, 128, device=dev),
                           torch.zeros(1, 128, 129, device=dev), big,
                           torch.ones(1, device=dev),
                           torch.ones(1, dtype=torch.int32, device=dev), (1.0, 1.0, 0.0, 0.0))
