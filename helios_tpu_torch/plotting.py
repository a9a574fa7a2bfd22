"""Realtime / progress plotting: TP-profile and net-flux panels (a copy of
the JAX-free :mod:`helios_tpu.plotting`; matplotlib is imported only when
a figure is drawn).

Rebuild of reference source/realtime_plotting.py:28-151 plus the post-hoc
plotting scripts (plotting/plot_tp.py, plot_spectrum.py).  The structural
difference from the reference: the loop runs whole iteration chunks between
host observations, so "realtime" plotting renders between chunks (or at the
end) from loop-state snapshots; a ``savefig`` path makes it
headless-friendly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Plot:
    """Live two-panel TP + net-flux canvas (realtime_plotting.py:28-49)."""

    def __init__(self, interactive: bool = True):
        self.fig = None
        self.ax_left = None
        self.ax_right = None
        self.ax_right2 = None
        self.interactive = interactive

    def create_canvas(self):
        import matplotlib
        if not self.interactive:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        self.fig, (self.ax_left, self.ax_right) = plt.subplots(
            nrows=1, ncols=2, gridspec_kw={"width_ratios": [5, 4]},
            figsize=(10, 5))
        self.ax_right2 = self.ax_right.twinx()
        self.fig.set_tight_layout(tight=True)
        if self.interactive:
            self.fig.canvas.manager.show()

    def plot_tp_and_flux(self, *, T_lay, F_net, F_intern, p_boa, p_toa,
                         marked_red=None, conv_layer=None,
                         iter_value: int = 0,
                         savefig: Optional[str] = None):
        """One frame (realtime_plotting.py:51-151).

        T_lay: [L+1] incl. surface ghost; F_net: [L+1] interfaces;
        marked_red/conv_layer: [L+1] flags."""
        import matplotlib.ticker as tkr

        if self.fig is None:
            self.create_canvas()

        L = len(T_lay) - 1
        nlayer_axis = np.arange(-1, L)
        marked_red = (np.zeros(L + 1, int) if marked_red is None
                      else np.asarray(marked_red).astype(int))
        conv_layer = (np.zeros(L + 1, int) if conv_layer is None
                      else np.asarray(conv_layer).astype(int))

        red_layer = [i if i < L else -1 for i in range(L + 1)
                     if marked_red[i]]
        red_temp = [T_lay[i] for i in range(L + 1) if marked_red[i]]
        conv_l = [i if i < L else -1 for i in range(L + 1)
                  if conv_layer[i]]
        conv_t = [T_lay[i] for i in range(L + 1) if conv_layer[i]]

        temp_plot = np.insert(np.asarray(T_lay)[:-1], 0, T_lay[-1])

        ax = self.ax_left
        ax.plot(temp_plot, nlayer_axis, color="cornflowerblue",
                linewidth=2)
        ax.scatter(temp_plot, nlayer_axis, color="forestgreen", s=30)
        ax.scatter(red_temp, red_layer, color="red", s=30)
        ax.scatter(conv_t, conv_l, color="orange", s=50)
        ax.set(ylim=[-1, L - 1], ylabel="layer index",
               xlabel="temperature (K)")
        ax.yaxis.set_major_locator(tkr.MultipleLocator(10))
        for which in ("minor", "major"):
            ax.xaxis.grid(True, which, color="grey")
            ax.yaxis.grid(True, which, color="grey")

        axr = self.ax_right
        ninterface = L + 1
        fnet_plot = np.insert(np.asarray(F_net), 0, F_intern)
        axr.plot(fnet_plot, np.arange(-1, ninterface),
                 color="cornflowerblue", linewidth=2)
        axr.scatter(fnet_plot, np.arange(-1, ninterface),
                    color="forestgreen", s=30)
        for i in conv_l:
            axr.axhspan(i, i + 1, color="orange", alpha=0.5)
        for i in red_layer:
            axr.axhspan(i, i + 1, color="red", alpha=0.4)
        axr.set(ylim=[-1, ninterface - 1], ylabel="interface index",
                xlabel="rad. net flux (erg s$^{-1}$ cm$^{-2}$)")
        axr.vlines(F_intern, -1, ninterface, colors="blue",
                   linestyles="--", linewidth=2, alpha=0.5)
        if F_intern > 0:
            axr.set(xlim=[-F_intern / 2, F_intern * 2])
        axr.yaxis.set_major_locator(tkr.MultipleLocator(10))
        for which in ("minor", "major"):
            axr.xaxis.grid(True, which, color="grey")
            axr.yaxis.grid(True, which, color="grey")

        self.ax_right2.set(ylabel="pressure (bar)",
                           ylim=[p_boa * 1e-6, p_toa * 1e-6], yscale="log")

        self.fig.canvas.draw()
        if savefig:
            self.fig.savefig(savefig)
        self.ax_left.clear()
        self.ax_right.clear()
        self.ax_right2.clear()
        if self.interactive:
            self.fig.canvas.flush_events()


def plot_tp_from_file(tp_path: str, out_path: Optional[str] = None):
    """Post-hoc TP plot from a *_tp.dat file (plotting/plot_tp.py)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    press, temp = [], []
    with open(tp_path) as f:
        lines = f.read().splitlines()
    for ln in lines[3:]:
        col = ln.split()
        temp.append(float(col[1]))
        press.append(float(col[2]) * 1e-6)
    fig, ax = plt.subplots()
    ax.plot(temp, press, color="cornflowerblue", linewidth=2)
    ax.set(yscale="log", ylim=[max(press), min(press)],
           xlabel="temperature (K)", ylabel="pressure (bar)")
    if out_path:
        fig.savefig(out_path)
    return fig


def plot_spectrum_from_file(toa_path: str, out_path: Optional[str] = None):
    """Post-hoc emission-spectrum plot from *_TOA_flux_eclipse.dat
    (plotting/plot_spectrum.py)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    lam, fup = [], []
    with open(toa_path) as f:
        lines = f.read().splitlines()
    for ln in lines[3:]:
        col = ln.split()
        lam.append(float(col[1]))
        fup.append(float(col[5]))
    fig, ax = plt.subplots()
    ax.plot(lam, fup, color="firebrick", linewidth=1.5)
    ax.set(xscale="log", yscale="log", xlabel="wavelength ($\\mu$m)",
           ylabel="TOA flux (erg s$^{-1}$ cm$^{-3}$)")
    if out_path:
        fig.savefig(out_path)
    return fig
