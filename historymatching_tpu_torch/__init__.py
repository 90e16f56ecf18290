"""historymatching_tpu_torch — the PyTorch/CUDA port of `historymatching_tpu`.

Ensemble history matching on one NVIDIA GPU: the TPFA two-phase simulator
run over an ensemble, the Gaussian-field prior, and the ES-MDA (plain or
localized) and IES analyses.
The module layout and names mirror the JAX package. Plain tensor code is
PyTorch; the two hot loops (the MG-PCG pressure solve and the CFL-substep
transport) are hand-written CUDA kernels for sm_90a (`csrc/`), built on
first use. On CPU tensors each kernel's plain PyTorch version runs
instead. Entry points that create tensors (`ResSim.build`, the samplers,
`temporal_R`, `mda_alphas`, `convert`) put them on the card unless the
caller names another device; functions that take tensors follow their
inputs' device.

Importing this package turns TF32 off: the DA algebra and the multigrid
transfers need full float32 products (the JAX package forces the same with
`precision="highest"`).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from historymatching_tpu_torch.grid import Grid2D  # noqa: E402
from historymatching_tpu_torch.models.ressim import Fluid, ResSim, SimResult, simulate  # noqa: E402
from historymatching_tpu_torch.da.update import (  # noqa: E402
    ens_update0,
    ens_update0_loc,
    ens_update0_loc_domains,
    es_mda,
    ies,
    mda_alphas,
)
from historymatching_tpu_torch.da import localization  # noqa: E402
from historymatching_tpu_torch.da.localization import bump, pairwise_distances  # noqa: E402
from historymatching_tpu_torch.da.geostat import gaussian_fields_fft, sample_prior_perm  # noqa: E402
from historymatching_tpu_torch.parallel.runner import forward_model, obs_ens_fn  # noqa: E402
from historymatching_tpu_torch.utils import center, gaussian_noise, temporal_R, vect  # noqa: E402

__all__ = [
    "Grid2D",
    "Fluid",
    "ResSim",
    "SimResult",
    "simulate",
    "forward_model",
    "obs_ens_fn",
    "sample_prior_perm",
    "gaussian_fields_fft",
    "localization",
    "bump",
    "pairwise_distances",
    "ens_update0",
    "ens_update0_loc",
    "ens_update0_loc_domains",
    "ies",
    "es_mda",
    "mda_alphas",
    "gaussian_noise",
    "center",
    "temporal_R",
    "vect",
]
