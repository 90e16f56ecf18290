"""Operators and the hand-written kernels of the port."""

from historymatching_tpu_torch.ops.cg import pcg  # noqa: F401
from historymatching_tpu_torch.ops.stencil import (  # noqa: F401
    stencil_diag,
    stencil_matvec,
    transmissibilities,
)
