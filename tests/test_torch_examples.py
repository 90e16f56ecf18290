"""Smoke tests of the port's tutorial examples
(`historymatching_tpu_torch/examples`), the counterparts of
tests/test_examples.py: each runs in a subprocess at its `--small --cpu`
configuration, with JAX and the JAX package blocked at the finder level,
so a run also shows that the example imports no JAX. The history-matching
run also writes its figures (`--plot`). The same printed
tokens are asserted as for the JAX examples; the history-matching run's
posterior RMSEs must be finite and at least one method must improve on
the prior."""

import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = """
import runpy, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'historymatching_tpu'):
            raise ImportError(name + ' must not be imported by the port')
        return None

sys.meta_path.insert(0, _Block())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)
"""


def _run(module, *args):
    proc = subprocess.run([sys.executable, "-c", _RUN, module, *args], cwd=REPO, timeout=600,
                          capture_output=True, text=True,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, (module, proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stdout


def _table(out, title):
    """{series: rms err} of one printed accuracy table."""
    block = out.split(title, 1)[1].split("\n\n", 1)[0]
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\w+)\s*:\s*(\S+)\s+\S+$", block, re.M)}


def test_history_match_example_smoke(tmp_path):
    out = _run("historymatching_tpu_torch.examples.history_match", "--small", "--cpu", "--plot",
               "--outdir", str(tmp_path))
    for name in ("perm_means", "productions", "correlation", "corr_wells"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name
    for token in ("Prior", "ES", "MDA", "taper tuning", "spectrum"):
        assert token in out, (token, out[-2000:])
    rmse = _table(out, "Accuracy wrt (supposedly unknown) parameter field")
    methods = ("ES", "LES", "IES", "ILES", "MDA")
    assert set(methods) <= set(rmse), rmse
    assert all(np.isfinite(rmse[m]) for m in methods + ("Prior",)), rmse
    assert min(rmse[m] for m in methods) < rmse["Prior"], rmse


def test_optimise_example_smoke():
    out = _run("historymatching_tpu_torch.examples.optimise", "--small", "--cpu",
               "--cases", "inj_xy,rate,toys")
    assert "[inj_xy] exhaustive optimum" in out, out[-2000:]
    assert "[rate" in out, out[-2000:]
    assert "[toys] GD trial sweep" in out, out[-2000:]
