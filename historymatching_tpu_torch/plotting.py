"""Host-side plotting (PyTorch counterpart of `historymatching_tpu.plotting`).

The same surface as the JAX package's module: the style registry, one
field with its wells, a grid of ensemble fields, production series, the
singular spectrum, iteration curves, the optimisation-trajectory panels,
the saturation animation, the field dashboards and the NPV densities.
Every function takes tensors (on any device) or arrays and draws on the
host. matplotlib (and scipy, for `npv_kde`) is imported inside the
functions, so the package imports on a host without them, such as the
card's.

`anim` draws every frame whatever the first frame's artist: the JAX
package's `anim` calls `set_data` on it, which a filled-contour set has
not, so a non-constant first frame fails there.
"""

from __future__ import annotations

import numpy as np
import torch

styles = {
    "default": dict(title="", cmap="viridis", levels=17),
    "oil": dict(title="Oil saturation", cmap="viridis", levels=np.linspace(0, 1, 17),
                vmin=0, vmax=1, cticks=np.linspace(0, 1, 6)),
    "water": dict(title="Water saturation", cmap="Blues", levels=np.linspace(0, 1, 17),
                  vmin=0, vmax=1, cticks=np.linspace(0, 1, 6)),
    "perm": dict(title="Permeability", cmap="viridis", levels=17, locator="log"),
    "pperm": dict(title="Pre-perm", cmap="jet", levels=np.linspace(-4, 4, 21),
                  vmin=-4, vmax=4, cticks=np.arange(-4, 5)),
    "corr": dict(title="Correlation", cmap="bwr", levels=np.linspace(-1, 1, 21),
                 vmin=-1, vmax=1, under="green", over="orange", bad="black",
                 cticks=np.linspace(-1, 1, 9)),
    "NPV": dict(title="NPV", cmap="inferno", levels=17),
    "domain": dict(title="", cmap="Greys", levels=2, colorbar=False),
}


def _plt():
    from matplotlib import pyplot as plt

    return plt


def _np(x):
    """A tensor (any device) or array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def __getattr__(name):
    # matplotlib's AsinhNorm, re-exported as the JAX module does, on demand
    if name == "AsinhNorm":
        from matplotlib.colors import AsinhNorm

        return AsinhNorm
    raise AttributeError(name)


def freshfig(num=None, figsize=None, **kwargs):
    """Create or clear a named figure; with any of ncols, nrows, sharex,
    sharey, its subplots, else one axes."""
    fig = _plt().figure(num=num, figsize=figsize)
    fig.clear()
    ax_kw = {k: kwargs.pop(k) for k in list(kwargs) if k in ("ncols", "nrows", "sharex", "sharey")}
    if ax_kw:
        return fig, fig.subplots(**ax_kw)
    return fig, fig.add_subplot(111)


def _style(style):
    if isinstance(style, str):
        return dict(styles.get(style, styles["default"]))
    return dict(style or styles["default"])


def plt_field(ax, model, Z, style="default", wells=True, argmax=False, colorbar=True,
              title=None, grid=False, kind="auto"):
    """One field on the model grid, with well markers. A style's `levels`
    draw filled contours on the cell centres, `cticks` set the colorbar
    ticks and `under`/`over`/`bad` mark out-of-range and masked cells.
    `kind`: "auto" (contours where the style has levels and the field is
    finite and not constant), "image" (the grid's cells) or "contour".
    Returns the artist: a contour set or an image."""
    plt = _plt()
    st = _style(style)
    Z = _np(Z).reshape(model.shape)
    cmap = plt.get_cmap(st.get("cmap", "viridis")).copy()
    for which, setter in (("under", cmap.set_under), ("over", cmap.set_over),
                          ("bad", cmap.set_bad)):
        if st.get(which):
            setter(st[which])
    norm = None
    if st.get("locator") == "log":
        from matplotlib.colors import LogNorm

        norm = LogNorm(vmin=max(np.min(Z), 1e-12), vmax=np.max(Z))
        st.pop("vmin", None), st.pop("vmax", None)
    levels = st.get("levels")
    contours = kind == "contour" or (kind == "auto" and levels is not None and norm is None
                                     and bool(np.isfinite(Z).all()) and np.ptp(Z) > 0)
    if contours:
        x = (np.arange(model.Nx) + 0.5) * model.Lx / model.Nx
        y = (np.arange(model.Ny) + 0.5) * model.Ly / model.Ny
        extend = "both" if (st.get("under") or st.get("over")) else "neither"
        im = ax.contourf(x, y, Z.T, levels=levels, cmap=cmap, vmin=st.get("vmin"),
                         vmax=st.get("vmax"), extend=extend)
        ax.set(xlim=(0, model.Lx), ylim=(0, model.Ly))
    else:
        im = ax.imshow(Z.T, origin="lower", extent=(0, model.Lx, 0, model.Ly), cmap=cmap,
                       vmin=st.get("vmin"), vmax=st.get("vmax"), norm=norm,
                       interpolation="nearest", aspect="auto")
    if wells:
        inj = np.atleast_2d(_np(model.inj_xy))
        prd = np.atleast_2d(_np(model.prd_xy))
        ax.plot(inj[:, 0], inj[:, 1], "v", color="w", mec="k", ms=9)
        ax.plot(prd[:, 0], prd[:, 1], "^", color="w", mec="k", ms=9)
    if argmax:
        xy = _np(model.ind2xy(int(np.argmax(Z.reshape(-1)))))
        ax.plot(*xy, "*", color="gold", mec="k", ms=14)
    if grid:
        ax.set_xticks(np.linspace(0, model.Lx, model.Nx + 1), minor=True)
        ax.set_yticks(np.linspace(0, model.Ly, model.Ny + 1), minor=True)
        ax.grid(True, which="minor", lw=0.3, color="w", alpha=0.4)
    ax.set(title=title if title is not None else st.get("title", ""))
    if colorbar and st.get("colorbar", True):
        ax.figure.colorbar(im, ax=ax, ticks=st.get("cticks"))
    return im


def fields(model, ensemble, style="pperm", title="", max_panels=12, colorbar=True):
    """A grid of fields (an ensemble's first `max_panels` members, or a
    dict of labelled fields) on one color scale with one colorbar: the
    style's, or the fields' common range."""
    if isinstance(ensemble, dict):
        labels = list(ensemble)
        data = [_np(v) for v in ensemble.values()]
    else:
        data = list(np.atleast_2d(_np(ensemble))[:max_panels])
        labels = [str(i) for i in range(len(data))]
    n = len(data)
    ncols = min(4, n)
    nrows = -(-n // ncols)
    fig, axs = _plt().subplots(nrows, ncols, num=f"Fields: {title}", squeeze=False,
                               figsize=(3 * ncols, 2.2 * nrows), layout="constrained")
    for ax in axs.ravel()[n:]:
        ax.axis("off")
    st = _style(style)
    if st.get("vmin") is None and st.get("locator") != "log":
        finite = [d[np.isfinite(d)] for d in data]
        finite = [d for d in finite if d.size]
        if finite:
            st["vmin"] = float(min(d.min() for d in finite))
            st["vmax"] = float(max(d.max() for d in finite))
    if np.ndim(st.get("levels")) == 0 and st.get("vmin") is not None:
        # contour panels share level positions, not a count on each one's range
        st["levels"] = np.linspace(st["vmin"], st["vmax"], int(st.get("levels") or 17))
    im = None
    for lbl, Z, ax in zip(labels, data, axs.ravel()):
        im = plt_field(ax, model, Z, st, wells=False, colorbar=False, title=lbl)
    if colorbar and im is not None and st.get("colorbar", True):
        fig.colorbar(im, ax=axs.ravel().tolist(), shrink=0.9, ticks=st.get("cticks"))
    fig.suptitle(title)
    return fig, axs


def productions(prod_dict, title="", obs_key="Noisy", nrows=None):
    """Per-well production series, 1 - saturation (oil): an ensemble
    (N, nTime, nPrd) as a bundle of thin lines, one series (nTime, nPrd)
    as a thick one."""
    prod_dict = {k: _np(v) for k, v in prod_dict.items()}
    nPrd = next(v for v in prod_dict.values() if v.ndim >= 2).shape[-1]
    ncols = min(4, nPrd)
    nrows = nrows or -(-nPrd // ncols)
    fig, axs = _plt().subplots(nrows, ncols, num=f"Production: {title}", squeeze=False,
                               sharex=True, sharey=True, figsize=(3 * ncols, 2.5 * nrows))
    colors = {k: f"C{i}" for i, k in enumerate(prod_dict)}
    for w, ax in enumerate(axs.ravel()[:nPrd]):
        for k, v in prod_dict.items():
            if v.ndim == 2:
                ax.plot(1 - v[:, w], color=colors[k], lw=2, label=k)
            else:
                ax.plot(1 - v[:, :, w].T, color=colors[k], lw=0.5, alpha=0.3)
                ax.plot([], [], color=colors[k], label=k)
        ax.set_title(f"Well {w}")
        ax.set_ylim(-0.05, 1.05)
    axs.ravel()[0].legend(fontsize="x-small")
    fig.suptitle(title)
    fig.tight_layout()
    return fig, axs


def spectrum(svals, title=""):
    """Singular values on a log scale."""
    fig, ax = freshfig(f"Spectrum: {title}", figsize=(5, 3))
    ax.semilogy(_np(svals), ".-")
    ax.set(xlabel="index", ylabel="singular value", title=title)
    fig.tight_layout()
    return fig, ax


def iterative(title, series_dict):
    """RMS against iteration; the series "obsrv" on a twin axis."""
    fig, ax = freshfig(title, figsize=(6, 3.5))
    ax2 = ax.twinx()
    for i, (k, v) in enumerate(series_dict.items()):
        (ax2 if k == "obsrv" else ax).plot(_np(v), f"C{i}.-", label=k)
    ax.set(xlabel="iteration", ylabel="RMS (state)")
    ax2.set_ylabel("RMS (obs)")
    lines = ax.get_lines() + ax2.get_lines()
    ax.legend(lines, [ln.get_label() for ln in lines])
    fig.tight_layout()
    return fig, (ax, ax2)


def figure12(title="", figsize=(9, 4)):
    """Two panels for an optimisation: the path in the plane and the
    objective against iteration."""
    fig, axs = _plt().subplots(1, 2, num=title, figsize=figsize)
    axs[0].set(xlabel="x", ylabel="y")
    axs[1].set(xlabel="iteration", ylabel="objective")
    return fig, axs


def add_path12(ax0, ax1, path, objs=None, color="C0", labels=True):
    """One optimisation trajectory on `figure12`'s panels."""
    path = np.atleast_2d(_np(path))
    if path.shape[1] >= 2:
        ax0.plot(path[:, 0], path[:, 1], "-o", color=color, ms=3)
        ax0.plot(*path[-1, :2], "s", color=color, ms=7)
    else:
        ax0.plot(path[:, 0], "-o", color=color, ms=3)
    if objs is not None:
        ax1.plot(_np(objs), "-o", color=color, ms=3)
    if labels:
        ax0.annotate("end", path[-1, :2], color=color, fontsize="x-small")


def plt_production(ax, production, obs=None, dt=None, title=""):
    """All producers' series (nTime, nPrd) on one axes, `obs` as markers."""
    production = _np(production)
    t = np.arange(1, production.shape[0] + 1) * (dt or 1.0)
    for w in range(production.shape[1]):
        ax.plot(t, production[:, w], f"C{w}", lw=2, label=f"prd {w}")
    if obs is not None:
        obs = _np(obs)
        for w in range(obs.shape[1]):
            ax.plot(t, obs[:, w], f"C{w}", marker="*", ls="", ms=5)
    ax.set(xlabel="time", ylabel="water sat. at producers", title=title, ylim=(-0.01, 1.01))
    ax.legend(fontsize="x-small")
    return ax


def anim(model, wsat_series, prod_series=None, style="water", interval=80):
    """Saturation animation over `wsat_series` (nT, Nxy), with the
    production series beside it and a cursor on the current step. Returns
    a matplotlib FuncAnimation (`.save(path)`, or `to_jshtml()` in a
    notebook). Each frame redraws the field with `plt_field`'s rendering,
    contours or image, in place of the previous one."""
    from matplotlib import animation

    wsat_series = _np(wsat_series)
    fig, axs = _plt().subplots(1, 2 if prod_series is not None else 1, squeeze=False,
                               figsize=(9, 3.2))
    ax0 = axs[0, 0]
    art = [plt_field(ax0, model, wsat_series[0], style, colorbar=True)]
    if prod_series is not None:
        plt_production(axs[0, 1], prod_series)
        vline = axs[0, 1].axvline(0, color="k", lw=1)

    def update(t):
        art[0].remove()
        art[0] = plt_field(ax0, model, wsat_series[t], style, wells=False, colorbar=False,
                           title=f"t = {t}")
        arts = [art[0]]
        if prod_series is not None:
            vline.set_xdata([t, t])
            arts.append(vline)
        return arts

    return animation.FuncAnimation(fig, update, frames=len(wsat_series), interval=interval,
                                   blit=False)


def field_console(model, compute, style="corr", title="", wells=False, argmax=False,
                  controls=None, **fixed):
    """A field dashboard: with ipywidgets, interactive over `controls`;
    without, one frame at each control's first value (and `fixed`),
    returned as (fig, ax, field)."""
    controls = controls or getattr(compute, "controls", {})
    vals = {k: v[0] if isinstance(v, (list, tuple, np.ndarray)) else v
            for k, v in controls.items()}
    vals.update(fixed)
    try:  # pragma: no cover - notebook path
        from ipywidgets import interact as _interact

        def show_frame(**kw):
            fig, ax = freshfig(title)
            plt_field(ax, model, compute(**kw), style, wells=wells, argmax=argmax, title=title)
            _plt().show()

        _interact(show_frame, **controls)
        return None
    except ImportError:
        Z = compute(**vals)
        fig, ax = freshfig(title)
        plt_field(ax, model, Z, style, wells=wells, argmax=argmax, title=title)
        return fig, ax, Z


def layout1(ww, output):
    """Widget layout for the dashboards: cN | cF/cFt | cP/cPt above,
    output | cY, then cX. Without ipywidgets, `output` unchanged."""
    try:  # pragma: no cover - notebook path
        import ipywidgets as w

        def grab(*names):
            got = [ww[n] for n in names if n in ww]
            return w.VBox(got) if len(got) > 1 else (got[0] if got else w.Box())

        top = w.HBox([grab("N"), grab("F", "Ft"), grab("P", "Pt")])
        return w.VBox([top, w.HBox([output, grab("Y", "y")]), grab("X", "x")])
    except ImportError:
        return output


def toggle_items(series: dict, plot_fn):
    """Checkboxes that choose which series `plot_fn` draws; without
    ipywidgets it draws them all."""
    try:  # pragma: no cover - notebook path
        import ipywidgets as w
        from IPython.display import display

        boxes = {k: w.Checkbox(value=True, description=k) for k in series}
        display(w.interactive(lambda **kw: plot_fn({k: v for k, v in series.items() if kw[k]}),
                              **boxes))
    except ImportError:
        plot_fn(series)


def label_ax(ax, txt, **kwargs):
    kwargs.setdefault("fontsize", "small")
    return ax.text(0.01, 0.99, txt, transform=ax.transAxes, va="top", **kwargs)


def dash_join(*txts):
    return " — ".join(t for t in txts if t)


def ens_style(label, N=100):
    """Line style of a method's series, the alpha scaled down with N."""
    base = {
        "Truth": dict(color="k", lw=2.0, alpha=1.0),
        "Noisy": dict(color="C1", lw=0.0, alpha=1.0, marker="*"),
        "Prior": dict(color="C0", lw=0.5),
        "ES": dict(color="C2", lw=0.5),
        "LES": dict(color="C3", lw=0.5),
        "IES": dict(color="C4", lw=0.5),
        "ILES": dict(color="C5", lw=0.5),
        "ES0": dict(color="C6", lw=0.5),
        "MDA": dict(color="C8", lw=0.5),
    }
    st = dict(base.get(label, dict(color="C7", lw=0.5)))
    if "alpha" not in st:
        st["alpha"] = float(np.clip(1 - 0.5 * np.log10(max(N, 1) / 100 + 1e-9), 0.1, 1.0))
    return st


def interact(**controls):
    """Dashboard decorator: ipywidgets' `interact` where it is installed;
    otherwise the function unchanged, its `controls` attached."""

    def deco(fn):
        try:  # pragma: no cover - notebook path
            from ipywidgets import interact as _interact

            _interact(fn, **controls)
        except ImportError:
            fn.controls = controls
        return fn

    return deco


def init(backend=None):
    """Choose the matplotlib backend and return the one in effect: an
    explicit `backend`; inline in Colab or a Jupyter kernel; 'Agg' on a
    host without a display; else QtAgg or TkAgg, the first that loads."""
    import os
    import sys

    import matplotlib

    if backend:
        matplotlib.use(backend, force=True)
        return matplotlib.get_backend()
    in_zmq_kernel = False
    try:  # pragma: no cover - notebook path
        from IPython import get_ipython

        shell = get_ipython()
        in_zmq_kernel = bool(shell) and type(shell).__name__ == "ZMQInteractiveShell"
    except ImportError:
        pass
    if "google.colab" in sys.modules or in_zmq_kernel:  # pragma: no cover - notebook path
        try:
            matplotlib.use("module://matplotlib_inline.backend_inline", force=True)
        except ImportError:
            pass
    elif not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
              or sys.platform == "darwin"):
        matplotlib.use("Agg", force=True)
    else:  # pragma: no cover - needs a display
        for cand in ("QtAgg", "TkAgg"):
            try:
                matplotlib.use(cand, force=True)
                break
            except ImportError:
                continue
    return matplotlib.get_backend()


def show():
    _plt().show()


def npv_kde(npvs_condnl, npvs_robust, title="NPV densities for optimal controls"):
    """Gaussian-KDE densities of the NPV of each nominally optimal control
    over the uncertainty ensemble (rows of `npvs_condnl`), thin lines,
    against the robust control's, a thick white line; means and minima in
    a legend."""
    from scipy.stats import gaussian_kde

    npvs_condnl, npvs_robust = _np(npvs_condnl), _np(npvs_robust)
    fig, ax = freshfig(title, figsize=(7, 4))
    a, b = float(npvs_condnl.min()), float(npvs_condnl.max())
    grid = np.linspace(a, b if b > a else a + 1.0, 100)
    cmap = _plt().get_cmap("tab20")
    for n, row in enumerate(npvs_condnl):
        if np.std(row) > 0:
            ax.plot(grid, gaussian_kde(row)(grid), c=cmap(n % 20), lw=1.2, alpha=0.7)
    if np.std(npvs_robust) > 0:
        ax.plot(grid, gaussian_kde(npvs_robust)(grid), "w", lw=3)
    leg = ("         Mean    Min",
           f"Robust:  {npvs_robust.mean():<6.3g}  {npvs_robust.min():.3g}",
           f"Nominal: {npvs_condnl.mean():<6.3g}  {npvs_condnl.min():.3g}")
    ax.text(0.02, 0.97, "\n".join(leg), transform=ax.transAxes, va="top", ha="left",
            fontsize="medium", fontfamily="monospace",
            bbox=dict(facecolor="lightyellow", edgecolor="k", alpha=0.99,
                      boxstyle="round,pad=0.25"))
    ax.set(facecolor="k", xlabel="NPV", ylabel="Density (pdf)", xlim=(a, b), ylim=0)
    ax.tick_params(axis="y", left=False, labelleft=False)
    fig.tight_layout()
    return fig
