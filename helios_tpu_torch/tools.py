"""Spectrum tools (a copy of the parts of :mod:`helios_tpu.tools` that the
cloud preprocessing calls; that module imports only numpy, keep the two
alike): energy-conserving rebinning and its analytic Planck bin integral
for the extrapolation.

Math parity with reference source/tools.py:35-294, with the
O(n_new * n_old) per-bin trapezoid loops replaced by one cumulative
trapezoid over the old grid (identical sums, vectorized).
"""

from __future__ import annotations

import numpy as np

from helios_tpu_torch import constants as pc


def calc_analyt_planck_in_interval(temp, lower_lambda, higher_lambda,
                                   n_terms: int = 200):
    """Bin-averaged blackbody function via the 200-term analytic series
    (tools.py:35-63).  Accepts scalars or arrays."""
    lower = np.asarray(lower_lambda, float)
    higher = np.asarray(higher_lambda, float)
    d = 2.0 * (pc.K_B / pc.H) ** 3 * pc.K_B * temp ** 4 / pc.C ** 2
    y_top = pc.H * pc.C / (higher * pc.K_B * temp)
    y_bot = pc.H * pc.C / (lower * pc.K_B * temp)

    def S(y):
        n = np.arange(1, n_terms)[:, None]
        y = np.atleast_1d(y)[None, :]
        return np.sum(np.exp(-n * y) * (y ** 3 / n + 3 * y ** 2 / n ** 2
                                        + 6 * y / n ** 3 + 6 / n ** 4),
                      axis=0)

    res = d * (S(y_top) - S(y_bot)) / (higher - lower)
    return res if res.size > 1 else float(res.ravel()[0])


def _edges_from_centers(new_lambda):
    """tools.py:144-153."""
    nl = np.asarray(new_lambda, float)
    edges = np.empty(len(nl) + 1)
    edges[0] = nl[0] - (nl[1] - nl[0]) / 2
    edges[1:-1] = 0.5 * (nl[1:] + nl[:-1])
    edges[-1] = nl[-1] + (nl[-1] - nl[-2]) / 2
    return edges


def convert_spectrum(old_lambda, old_flux, new_lambda, int_lambda=None,
                     type: str = "linear", extrapolate_with_BB_T: float = 0):
    """Energy-conserving spectrum rebinning (tools.py:116-294).

    The new-bin value is the old spectrum's trapezoid average over the bin
    ('linear') or the geometric/trapezoid-in-log average ('log').  Bins
    reaching outside the old grid are filled with a blackbody value at
    ``extrapolate_with_BB_T`` (or zero).
    """
    old_lambda = np.asarray(old_lambda, float)
    old_flux = np.asarray(old_flux, float)
    new_lambda = np.asarray(new_lambda, float)
    if int_lambda is None:
        int_lambda = _edges_from_centers(new_lambda)
    int_lambda = np.asarray(int_lambda, float)

    if extrapolate_with_BB_T > 0:
        extrapol = np.pi * calc_analyt_planck_in_interval(
            extrapolate_with_BB_T, int_lambda[:-1], int_lambda[1:])
        extrapol = np.atleast_1d(extrapol)
    elif extrapolate_with_BB_T == 0:
        extrapol = np.zeros(len(new_lambda))
    else:
        raise ValueError(
            "extrapolation blackbody temperature cannot be negative")

    if type == "linear":
        f = old_flux
    elif type == "log":
        with np.errstate(divide="ignore"):
            f = np.log(old_flux)
    else:
        raise ValueError(f"unknown type {type!r}")

    # edge values of the (possibly log-) spectrum at the new bin edges
    inside = (int_lambda >= old_lambda[0]) & (int_lambda <= old_lambda[-1])
    edge_f = np.interp(int_lambda, old_lambda, f)

    # cumulative trapezoid of f over the old grid, evaluated at bin edges
    cum_old = np.concatenate([[0.0], np.cumsum(
        0.5 * (f[1:] + f[:-1]) * np.diff(old_lambda))])
    idx = np.clip(np.searchsorted(old_lambda, int_lambda, side="right") - 1,
                  0, len(old_lambda) - 2)
    lam_lo = old_lambda[idx]
    cum_edges = (cum_old[idx]
                 + 0.5 * (f[idx] + edge_f) * (int_lambda - lam_lo))

    avg = (cum_edges[1:] - cum_edges[:-1]) / np.diff(int_lambda)
    if type == "log":
        new_flux = np.exp(avg)
        edge_zero = ~np.isfinite(edge_f)
    else:
        new_flux = avg
        edge_zero = edge_f == 0.0

    # out-of-range or zero-edge bins use the extrapolation value
    # (tools.py:209-210, :264-265)
    bad = (~inside[:-1]) | (~inside[1:]) | edge_zero[:-1] | edge_zero[1:]
    new_flux = np.where(bad, extrapol, new_flux)
    return new_flux
