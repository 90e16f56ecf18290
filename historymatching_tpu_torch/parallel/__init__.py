"""The ensemble forward runner."""

from historymatching_tpu_torch.parallel.mesh import ens_mesh, shard_ens  # noqa: F401

_RUNNER = ("ensemble_simulate", "forward_model", "perm_transf", "set_perm")


def __getattr__(name):
    """The runner's entry points, imported on first use: the runner imports
    the simulator, which imports this package's mesh (through `utils`)."""
    if name in _RUNNER:
        from historymatching_tpu_torch.parallel import runner

        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
