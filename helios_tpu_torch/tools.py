"""Spectrum tools: energy-conserving rebinning, Gaussian convolution,
analytic Planck bin integrals, and the readers of the output files.

A copy of :mod:`helios_tpu.tools`, which imports only numpy; keep the two
alike.  Host-side numpy utilities shared by the clouds, star-tool and
ktable pipelines.  Math parity with reference source/tools.py:35-294,
with the O(n_new * n_old) per-bin trapezoid loops replaced by one
cumulative trapezoid over the old grid (identical sums, vectorized).
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


def read_helios_spectrum(file, type: str = "emission",
                         star_fudge_factor=None):
    """Read a ``*_TOA_flux_eclipse.dat`` output file (tools.py:297-343).

    type: 'star', 'emission' or 'eclipse' selects the column; the
    optional fudge factor scales the stellar spectrum (divides the
    eclipse depth, where the star is in the denominator).
    Returns (wavelength in the file's units [micron], spectrum) as
    numpy arrays.
    """
    col = {"star": 4, "emission": 5, "eclipse": 6}.get(type)
    if col is None:
        raise ValueError("Unknown input for spectrum type!")
    lamda, spec = [], []
    with open(file) as f:
        for _ in range(3):
            next(f)
        for line in f:
            c = line.split()
            if c:
                lamda.append(float(c[1]))
                spec.append(float(c[col]))
    lamda, spec = np.asarray(lamda), np.asarray(spec)
    if star_fudge_factor is not None:
        if type == "star":
            spec = spec * star_fudge_factor
        elif type == "eclipse":
            spec = spec / star_fudge_factor
    return lamda, spec


def rebin_spectrum_to_resolution(old_lamda, old_flux, resolution,
                                 w_unit: str = "cm",
                                 type: str = "linear"):
    """Rebin a spectrum to a fixed resolution R = lamda/dlamda
    (tools.py:346-394).

    type 'linear' conserves bin energy, 'log' suits opacities, and
    'gaussian' convolves with a Gaussian of FWHM = R.  w_unit 'cm' or
    'micron' applies to both input and output wavelengths.
    """
    old_lamda = np.asarray(old_lamda, float)
    old_flux = np.asarray(old_flux, float)
    if w_unit == "micron":
        old_lamda = old_lamda * 1e-4

    ratio = (resolution + 1.0) / resolution
    n = int(np.floor(np.log(old_lamda[-1] / old_lamda[0]) / np.log(ratio)))
    rebin_lamda = old_lamda[0] * ratio ** np.arange(n + 1)
    rebin_lamda = rebin_lamda[rebin_lamda < old_lamda[-1]]

    if type == "gaussian":
        _, rebin_flux = convolve_with_gaussian(old_lamda, old_flux,
                                               resolution, rebin_lamda)
    else:
        rebin_flux = convert_spectrum(old_lamda, old_flux, rebin_lamda,
                                      type=type, extrapolate_with_BB_T=0)

    if w_unit == "micron":
        rebin_lamda = rebin_lamda * 1e4
    return rebin_lamda, rebin_flux


def read_helios_tp(file, coupling_format: int = 0):
    """Read a ``*_tp.dat`` TP profile incl. up to four convective zones
    (tools.py:397-486).

    Returns (press [bar], temp, press_conv0, temp_conv0, ...,
    press_conv3, temp_conv3) -- the reference's 10-tuple, with the
    convective zones being the first four contiguous runs of the
    convective-layer flag (last row excluded, as in the reference).
    coupling_format=1 reads the two-column coupling TP layout instead
    (no convective zones).
    """
    press, temp, convective = [], [], []
    if coupling_format == 0:
        with open(file) as f:
            next(f)
            next(f)
            for line in f:
                c = line.split()
                if not c:
                    continue
                press.append(float(c[2]) * 1e-6)
                temp.append(float(c[1]))
                try:
                    convective.append(float(c[6]))
                except (IndexError, ValueError):
                    convective.append(0.0)
    else:
        with open(file) as f:
            next(f)
            for line in f:
                c = line.split()
                if c:
                    press.append(float(c[0]) * 1e-6)
                    temp.append(float(c[1]))

    zones = [([], []) for _ in range(4)]
    if coupling_format == 0 and len(press) > 1:
        z = -1
        prev = 0.0
        for i in range(len(press) - 1):     # last row never examined
            if convective[i] == 1:
                if prev != 1:
                    z += 1
                if z >= 4:
                    break
                zones[z][0].append(press[i])
                zones[z][1].append(temp[i])
            prev = convective[i]

    return (press, temp, zones[0][0], zones[0][1], zones[1][0],
            zones[1][1], zones[2][0], zones[2][1], zones[3][0],
            zones[3][1])


def gauss_pdf(x, mu, hwhm):
    """Gaussian pdf parameterized by half-width at half-maximum
    (tools.py's gauss_pdf)."""
    sigma = hwhm / np.sqrt(2.0 * np.log(2.0))
    return (1.0 / (sigma * np.sqrt(2 * np.pi))
            * np.exp(-0.5 * ((x - mu) / sigma) ** 2))


def convolve_with_gaussian(old_lamda, old_flux, resolution, new_lamda=None):
    """Gaussian convolution onto an R = ``resolution`` grid
    (tools.py:66-113)."""
    old_lamda = np.asarray(old_lamda, float)
    old_flux = np.asarray(old_flux, float)

    if new_lamda is None:
        new_lamda = [old_lamda[0]]
        while new_lamda[-1] < old_lamda[-1]:
            new_lamda.append(new_lamda[-1] * (1.0 + 1.0 / resolution))
    new_lamda = np.asarray(new_lamda, float)

    delta = np.empty_like(old_lamda)
    delta[0] = old_lamda[1] - old_lamda[0]
    delta[-1] = old_lamda[-1] - old_lamda[-2]
    delta[1:-1] = (old_lamda[2:] - old_lamda[:-2]) / 2

    hwhm = new_lamda / (2.0 * resolution)
    # [n_new, n_old] kernel, truncated at +-5 hwhm like the reference
    d = old_lamda[None, :] - new_lamda[:, None]
    k = gauss_pdf(d, 0.0, hwhm[:, None])
    k = np.where(np.abs(d) <= 5.0 * hwhm[:, None], k, 0.0)
    return new_lamda, k @ (old_flux * delta)
