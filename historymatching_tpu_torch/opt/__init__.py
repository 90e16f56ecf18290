"""Ensemble optimisation (EnOpt): gradients, line search, NPV objective."""

from historymatching_tpu_torch.opt.enopt import (  # noqa: F401
    EnGrad,
    Backtracker,
    GD,
    gd_scan,
    gd_scan_multi,
    robust_mean,
)
from historymatching_tpu_torch.opt.npv import (  # noqa: F401
    NPVConfig,
    accounting,
    npv,
    npv_value,
    prd_sats,
)
from historymatching_tpu_torch.opt.transforms import (  # noqa: F401
    balance_rates,
    coordinate_transform,
    equalize,
    rate_transform,
    sigmoid,
)
