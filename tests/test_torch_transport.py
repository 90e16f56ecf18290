"""Port vs JAX: the transport step and kernel K's plain version
(ops/transport.py), on the CPU.

- float64 against JAX `transport_step`: 1e-12 relative (same arithmetic).
- float32 against the Pallas kernel `transport_substeps_pallas` run in
  interpret mode, as tests/test_pallas_kernels.py runs it: atol 1e-6, the
  tolerance that file holds the Pallas kernel to against XLA."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historymatching_tpu.models.ressim import transport_step as transport_step_j
from historymatching_tpu.ops.transport_pallas import transport_substeps_pallas
from historymatching_tpu_torch import convert
from historymatching_tpu_torch.models.ressim import transport_step
from historymatching_tpu_torch.ops.transport import transport_substeps, transport_substeps_torch
from tests.torch_helpers import default_model, rel_err


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, B, Nx, Ny, dtype):
    rng = np.random.default_rng(seed)
    s = np.clip(0.4 + 0.2 * rng.normal(size=(B, Nx, Ny)), 0, 1)
    Fx = 0.1 * rng.normal(size=(B, Nx + 1, Ny))
    Fx[:, 0] = Fx[:, -1] = 0
    Fy = 0.1 * rng.normal(size=(B, Nx, Ny + 1))
    Fy[:, :, 0] = Fy[:, :, -1] = 0
    q = np.zeros((Nx, Ny))
    q[Nx // 2, Ny // 2] = 1.0
    q[1, 1] = -1.0
    return tuple(x.astype(dtype) for x in (s, Fx, Fy, q))


def test_transport_step_f64_matches_jax():
    m = default_model(Nx=12, Ny=10)
    mt = convert.ressim_from_reference(m, dtype=torch.float64, device="cpu")
    s, Fx, Fy, q = _inputs(0, 3, 12, 10, np.float64)
    s_t, n_t = transport_step(mt, *map(torch.as_tensor, (s, Fx, Fy, q)), 0.01)
    for b in range(3):
        s_j, n_j = transport_step_j(m, jnp.asarray(s[b]), jnp.asarray(Fx[b]),
                                    jnp.asarray(Fy[b]), jnp.asarray(q), 0.01)
        assert int(n_t[b]) == int(n_j)
        assert rel_err(s_t[b], s_j) < 1e-12


def test_plain_kernel_twin_matches_pallas_interpret_f32():
    m = default_model(Nx=12, Ny=12)
    fl = m.fluid
    fluid = (fl.vw, fl.vo, fl.swc, fl.sor)
    B = 4
    s, Fx, Fy, q = _inputs(1, B, 12, 12, np.float32)
    dts_pv = np.linspace(0.005, 0.02, B).astype(np.float32)
    n_sub = np.array([1, 3, 7, 12], np.int32)  # ragged: each member stops on its own
    out = transport_substeps_torch(*map(torch.as_tensor, (s, Fx, Fy, q[None], dts_pv, n_sub)),
                                   fluid)
    assert out.dtype == torch.float32
    # The dispatching entry takes the plain version on CPU tensors.
    same = transport_substeps(*map(torch.as_tensor, (s, Fx, Fy, q, dts_pv, n_sub)), fluid)
    assert torch.equal(same, out)
    for b in range(B):
        ref = transport_substeps_pallas(jnp.asarray(s[b]), jnp.asarray(Fx[b]),
                                        jnp.asarray(Fy[b]), jnp.asarray(q), dts_pv[b],
                                        n_sub[b], fluid, interpret=True)
        assert np.allclose(out[b].numpy(), np.asarray(ref), atol=1e-6), b
