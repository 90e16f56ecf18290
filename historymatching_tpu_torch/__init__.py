"""historymatching_tpu_torch — the PyTorch/CUDA port of `historymatching_tpu`.

Ensemble history matching and production optimisation on one NVIDIA GPU:
the TPFA two-phase simulator run over an ensemble, the Gaussian-field
prior, the ES-MDA (plain or localized, with resume), IES and ILES
analyses, EnOpt with its NPV objective (`opt`), checkpoints and profiling,
JAX's random draws (`prng`), the workload parity harness (`parity`) and
plotting (`plotting`, matplotlib imported on use).
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
    iles,
    iles_domains,
    mda_alphas,
)
from historymatching_tpu_torch.da import geostat, localization  # noqa: E402
from historymatching_tpu_torch.da.localization import bump, pairwise_distances  # noqa: E402
from historymatching_tpu_torch.da.geostat import (  # noqa: E402
    gaussian_fields,
    gaussian_fields_dense,
    gaussian_fields_fft,
    sample_prior_perm,
)
from historymatching_tpu_torch.opt import (  # noqa: E402
    GD,
    Backtracker,
    EnGrad,
    NPVConfig,
    accounting,
    gd_scan,
    gd_scan_multi,
    npv,
    npv_value,
)
from historymatching_tpu_torch.parallel.runner import (  # noqa: E402
    ensemble_simulate,
    forward_model,
    obs_ens_fn,
)
from historymatching_tpu_torch import checkpoint, profiling, utils  # noqa: E402
from historymatching_tpu_torch.utils import (  # noqa: E402
    center,
    corr,
    cov,
    gaussian_noise,
    rinv,
    svals,
    temporal_R,
    vect,
)

__all__ = [
    "Grid2D",
    "Fluid",
    "ResSim",
    "SimResult",
    "simulate",
    "forward_model",
    "ensemble_simulate",
    "obs_ens_fn",
    "sample_prior_perm",
    "gaussian_fields",
    "gaussian_fields_dense",
    "gaussian_fields_fft",
    "NPVConfig",
    "npv",
    "npv_value",
    "accounting",
    "EnGrad",
    "Backtracker",
    "GD",
    "gd_scan",
    "gd_scan_multi",
    "geostat",
    "localization",
    "bump",
    "pairwise_distances",
    "ens_update0",
    "ens_update0_loc",
    "ens_update0_loc_domains",
    "ies",
    "iles",
    "iles_domains",
    "es_mda",
    "mda_alphas",
    "gaussian_noise",
    "center",
    "cov",
    "corr",
    "svals",
    "rinv",
    "checkpoint",
    "profiling",
    "utils",
    "temporal_R",
    "vect",
]
