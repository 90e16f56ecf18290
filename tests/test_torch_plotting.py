"""Port vs JAX: the plotting module (`historymatching_tpu_torch.plotting`),
on the Agg backend, at 8x8.

- `anim` renders every frame when the first frame is a filled-contour
  set. The JAX package's `anim` fails there (its `update` calls
  `set_data` on the contour set), which the test shows on the same input.
- The field, production and NPV-density plots draw from tensors, and
  their artists carry the JAX module's data for the same inputs: contour
  levels, image arrays, line data.
"""

import matplotlib

matplotlib.use("Agg", force=True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib import pyplot as plt  # noqa: E402
from matplotlib.contour import QuadContourSet  # noqa: E402
from matplotlib.image import AxesImage  # noqa: E402
from PIL import Image  # noqa: E402

from historymatching_tpu import plotting as pj  # noqa: E402
from historymatching_tpu_torch import convert  # noqa: E402
from historymatching_tpu_torch import plotting as pt  # noqa: E402
from tests.torch_helpers import default_model  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield
    plt.close("all")


def _models():
    m = default_model(Nx=8, Ny=8)
    return m, convert.ressim_from_reference(m, dtype=torch.float64, device="cpu")


def test_anim_draws_every_frame_from_a_contour_first_frame(tmp_path):
    mj, mt = _models()
    rng = np.random.default_rng(0)
    wsats = rng.uniform(size=(3, mt.Nxy))
    prods = rng.uniform(size=(3, 4))
    _, ax = pt.freshfig("first frame")
    assert isinstance(pt.plt_field(ax, mt, wsats[0], "water"), QuadContourSet)
    a = pt.anim(mt, torch.from_numpy(wsats), torch.from_numpy(prods))
    a.save(tmp_path / "port.gif", writer="pillow")
    with Image.open(tmp_path / "port.gif") as im:
        assert im.n_frames == 3
    # The last frame's field is a contour set of the last saturations, the
    # first one gone.
    ax0 = a._fig.axes[0]
    sets = [c for c in ax0.collections if isinstance(c, QuadContourSet)]
    assert len(sets) == 1 and ax0.get_title() == "t = 2"
    # The JAX package's anim on the same input: its first update fails (the
    # writer's cleanup then raises on the empty file, with it as context).
    with pytest.raises(Exception) as err:
        pj.anim(mj, wsats, prods).save(tmp_path / "jax.gif", writer="pillow")
    assert any(isinstance(e, AttributeError) and "set_data" in str(e)
               for e in (err.value, err.value.__context__))


def test_field_production_and_npv_plots_draw_as_jax():
    mj, mt = _models()
    rng = np.random.default_rng(1)
    f = rng.normal(size=mt.Nxy)
    for style, kind, art in (("corr", "auto", QuadContourSet), ("pperm", "image", AxesImage)):
        _, axj = pj.freshfig("j")
        _, axt = pt.freshfig("t")
        aj = pj.plt_field(axj, mj, f, style, kind=kind, argmax=True)
        at = pt.plt_field(axt, mt, torch.from_numpy(f), style, kind=kind, argmax=True)
        assert isinstance(at, art) and isinstance(aj, art)
        if art is QuadContourSet:
            np.testing.assert_array_equal(at.levels, aj.levels)
        else:
            np.testing.assert_array_equal(at.get_array(), aj.get_array())
        lines = lambda ax: [ln.get_xydata() for ln in ax.get_lines()]  # noqa: E731
        np.testing.assert_allclose(np.concatenate(lines(axt)), np.concatenate(lines(axj)))
        axt.figure.canvas.draw()

    ens = rng.normal(size=(5, mt.Nxy))
    fig_t, axs_t = pt.fields(mt, torch.from_numpy(ens), "pperm", "ens")
    fig_j, axs_j = pj.fields(mj, ens, "pperm", "ens")
    assert [a.get_title() for a in axs_t.ravel()] == [a.get_title() for a in axs_j.ravel()]
    fig_t.canvas.draw()
    fig_t, _ = pt.fields(mt, {"a": torch.from_numpy(ens[0]), "b": ens[1]}, "perm", "named")
    fig_t.canvas.draw()

    prod = {"Truth": rng.uniform(size=(6, 4)), "Prior": rng.uniform(size=(3, 6, 4))}
    fig_t, axs_t = pt.productions({k: torch.from_numpy(v) for k, v in prod.items()}, "past")
    fig_j, axs_j = pj.productions(prod, "past")
    for a, b in zip(axs_t.ravel(), axs_j.ravel()):
        np.testing.assert_array_equal(np.concatenate([ln.get_xydata() for ln in a.get_lines()]),
                                      np.concatenate([ln.get_xydata() for ln in b.get_lines()]))
    fig_t.canvas.draw()
    _, ax = pt.freshfig("prd")
    pt.plt_production(ax, torch.from_numpy(prod["Truth"]), obs=prod["Truth"] + 0.01, dt=0.025)
    ax.figure.canvas.draw()

    condnl, robust = rng.normal(size=(4, 31)), rng.normal(size=31)
    fig_t = pt.npv_kde(torch.from_numpy(condnl), torch.from_numpy(robust))
    fig_j = pj.npv_kde(condnl, robust)
    lt, lj = fig_t.axes[0].get_lines(), fig_j.axes[0].get_lines()
    assert len(lt) == len(lj) == 5
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.get_xydata(), b.get_xydata(), rtol=1e-12)
    fig_t.canvas.draw()


def test_remaining_surface_draws():
    _, mt = _models()
    rng = np.random.default_rng(2)
    pt.spectrum(torch.logspace(0, -3, 10), "spec")[0].canvas.draw()
    pt.iterative("iters", {"error": torch.linspace(1, 0.5, 5),
                           "obsrv": np.linspace(2, 1, 5)})[0].canvas.draw()
    fig, axs = pt.figure12("opt")
    pt.add_path12(*axs, torch.from_numpy(rng.normal(size=(4, 2))), torch.arange(4.0))
    fig.canvas.draw()

    def comp(x=0, y=0):
        Z = np.zeros(mt.Nxy)
        Z[int(mt.xy2ind((x + 0.5) * 0.25, (y + 0.5) * 0.125))] = 1.0
        return Z

    comp.controls = dict(x=(0, 7), y=(0, 7))
    out = pt.field_console(mt, comp, "corr", "probe")
    assert out is None or len(out) == 3
    assert pt.ens_style("ES")["color"] == "C2"
    assert pt.ens_style("X", N=1000) == pj.ens_style("X", N=1000)
    assert pt.dash_join("a", "", "b") == "a — b"
    assert pt.init("Agg").lower() == "agg"
    assert pt.AsinhNorm is matplotlib.colors.AsinhNorm
