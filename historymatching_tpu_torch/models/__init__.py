"""The reservoir simulator."""

from historymatching_tpu_torch.models.ressim import Fluid, ResSim, SimResult, simulate  # noqa: F401
