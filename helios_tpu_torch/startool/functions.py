"""star_tool: build stellar-spectrum HDF5 inputs on the opacity wavelength
grid.

Rebuild of reference star_tool/functions.py: readers for PHOENIX (local
FITS files, trilinear interpolation in T_eff / log g / [M/H]), MUSCLES,
BT-Settl, and ASCII sources; energy-conserving rebinning to the opacity
grid with blackbody extrapolation beyond the source coverage, including
the automatic Newton-Raphson fit of the extrapolation temperature; output
into the reference HDF5 dataset layout
(/{target}/{format}/{name} + /{target}/lambda).

Differences from the reference: PHOENIX downloads are OPT-IN
(``-download_phoenix yes`` / ``download=True``; by default missing grid
files raise with their exact Goettingen URLs for out-of-band fetching),
and there is no interactive matplotlib accept/reject loop (the
'automatic' Newton-Raphson mode replaces it).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from helios_tpu_torch import constants as pc
from helios_tpu_torch import tools as tls

PC_CM = 3.0856775814913673e18   # parsec [cm]


def read_ascii_file(path, w_conversion_factor, flux_conversion_factor,
                    skip_header: int = 8):
    """ASCII spectrum scaled from 1 AU to the stellar surface
    (functions.py:22-49)."""
    data = np.loadtxt(path, skiprows=skip_header)
    lam = data[:, 0] * w_conversion_factor
    flux = (data[:, 1] * flux_conversion_factor
            * (pc.AU / pc.R_SUN) ** 2)
    return lam, flux


def read_muscles_file(path, w_conversion_factor, flux_conversion_factor,
                      distance_from_earth_pc, R_star_rsun):
    """MUSCLES fits spectrum scaled to the stellar surface
    (functions.py:51-65)."""
    from astropy.io import fits
    contents = fits.getdata(path, 1)
    lam = np.asarray(contents["WAVELENGTH"], float) * w_conversion_factor
    dist = distance_from_earth_pc * PC_CM
    rstar = R_star_rsun * pc.R_SUN
    flux = (np.asarray(contents["FLUX"], float) * flux_conversion_factor
            * (dist / rstar) ** 2)
    return lam, flux


def read_btsettl_file(path, w_conversion_factor, flux_conversion_factor):
    """BT-Settl fits spectrum (functions.py:67-80)."""
    from astropy.io import fits
    contents = fits.getdata(path, 0)
    return (np.asarray(contents[0], float) * w_conversion_factor,
            np.asarray(contents[1], float) * flux_conversion_factor)


def _phoenix_path(phoenix_dir, name, t, g, m):
    return os.path.join(phoenix_dir, name,
                        "{:05d}_{:.2f}_{:.1f}.fits".format(t, g, m))


# Goettingen PHOENIX-ACES-AGSS-COND-2011 grid (functions.py:119-129)
_PHOENIX_BASE = ("ftp://phoenix.astro.physik.uni-goettingen.de/HiResFITS/"
                 "PHOENIX-ACES-AGSS-COND-2011")
_PHOENIX_WAVE_URL = ("ftp://phoenix.astro.physik.uni-goettingen.de/"
                     "HiResFITS//WAVE_PHOENIX-ACES-AGSS-COND-2011.fits")


def _phoenix_url(t, g, m):
    z = "Z-{:.1f}".format(abs(m)) if m <= 0 else "Z+{:.1f}".format(m)
    sign = "-{:.1f}".format(abs(m)) if m <= 0 else "+{:.1f}".format(m)
    return (f"{_PHOENIX_BASE}/{z}/lte{t:05d}-{g:.2f}{sign}"
            ".PHOENIX-ACES-AGSS-COND-2011-HiRes.fits")


def download_phoenix_file(url: str, dest: str) -> None:
    """Fetch one PHOENIX grid file (reference functions.py:129 wget).
    Uses stdlib urllib; atomic rename so interrupted downloads never
    leave a truncated FITS behind."""
    import urllib.request
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    urllib.request.urlretrieve(url, tmp)
    os.replace(tmp, dest)


def ensure_phoenix_files(phoenix_dir, name, grid_points,
                         download: bool = False):
    """Check the (t, log g, [M/H]) grid FITS files exist; optionally
    download missing ones from the Goettingen server
    (functions.py:119-129).  Raises with the exact URLs when files are
    missing and downloading is disabled or fails -- so air-gapped users
    can fetch them out of band."""
    missing = []
    for (t, g, m) in grid_points:
        path = _phoenix_path(phoenix_dir, name, t, g, m)
        if not os.path.exists(path):
            missing.append((path, _phoenix_url(t, g, m)))
    wave = os.path.join(phoenix_dir,
                        "WAVE_PHOENIX-ACES-AGSS-COND-2011.fits")
    if not os.path.exists(wave):
        missing.append((wave, _PHOENIX_WAVE_URL))
    if not missing:
        return
    if download:
        errors = []
        for path, url in missing:
            try:
                download_phoenix_file(url, path)
            except Exception as e:   # no egress, server down, ...
                errors.append(f"{url} -> {path}: {e}")
        if not errors:
            return
        missing_msg = "; ".join(errors)
        raise IOError(
            f"PHOENIX download failed ({missing_msg}). Fetch the files "
            "manually and place them at the listed paths.")
    listing = "\n".join(f"  {url}\n    -> {path}" for path, url in missing)
    raise FileNotFoundError(
        "Missing PHOENIX grid files (pass download=True / CLI "
        f"-download_phoenix yes to fetch them):\n{listing}")


def read_fits_flux(path):
    from astropy.io import fits
    with fits.open(path) as f:
        return np.asarray(f[0].data[:], float)


def interpol_phoenix_spectrum(phoenix_dir, name, teff, log_g, metal,
                              download: bool = False):
    """Trilinear interpolation of PHOENIX grids in (T_eff, log g, [M/H])
    (functions.py:93-223).  Grid files live under
    phoenix_dir/name/TTTTT_G.GG_M.M.fits; with ``download=True`` missing
    files are fetched from the Goettingen server (reference wget path,
    functions.py:119-129)."""
    if teff < 7000:
        tdown, tup = 100 * np.floor(teff / 100), 100 * np.ceil(teff / 100)
    else:
        tdown, tup = 200 * np.floor(teff / 200), 200 * np.ceil(teff / 200)
    tdown, tup = int(tdown), int(tup)
    gdown, gup = 0.5 * np.floor(log_g / 0.5), 0.5 * np.ceil(log_g / 0.5)
    if not (-2.0 <= metal <= 1.0):
        raise ValueError("Metallicity out of bounds.")
    mdown, mup = 0.5 * np.floor(metal / 0.5), 0.5 * np.ceil(metal / 0.5)

    def load(t, g, m):
        return read_fits_flux(_phoenix_path(phoenix_dir, name, t, g, m))

    # trilinear with degenerate-axis collapse
    def axis_weights(x, lo, hi):
        if hi == lo:
            return [(lo, 1.0)]
        return [(lo, (hi - x) / (hi - lo)), (hi, (x - lo) / (hi - lo))]

    points = [(t, g, m)
              for t, _ in axis_weights(teff, tdown, tup)
              for g, _ in axis_weights(log_g, gdown, gup)
              for m, _ in axis_weights(metal, mdown, mup)]
    ensure_phoenix_files(phoenix_dir, name, points, download=download)

    out = None
    for t, wt in axis_weights(teff, tdown, tup):
        for g, wg in axis_weights(log_g, gdown, gup):
            for m, wm in axis_weights(metal, mdown, mup):
                flux = load(t, g, m)
                contrib = wt * wg * wm * flux
                out = contrib if out is None else out + contrib
    return out


def phoenix_wavelengths(phoenix_dir):
    """The PHOENIX wavelength grid [cm] from the local WAVE file."""
    path = os.path.join(phoenix_dir,
                        "WAVE_PHOENIX-ACES-AGSS-COND-2011.fits")
    return read_fits_flux(path) * 1e-8      # Angstrom -> cm


def fit_bb_extrapolation_temp(orig_lambda, converted_flux, int_lambda,
                              BB_temp0, n_iter: int = 10):
    """Newton-Raphson fit of the blackbody extrapolation temperature to
    the last fully-covered bin (functions.py:381-418).

    Returns the fitted temperature (or BB_temp0 when no extrapolation is
    needed)."""
    int_lambda = np.asarray(int_lambda, float)
    index = None
    for i in range(len(int_lambda)):
        if int_lambda[i] > orig_lambda[-1]:
            index = i - 2
            break
    if index is None:
        return BB_temp0

    BB_before, BB_now = BB_temp0 - 100.0, BB_temp0
    BB_new = BB_now
    for n in range(n_iter):
        v_before = np.pi * tls.calc_analyt_planck_in_interval(
            BB_before, int_lambda[index], int_lambda[index + 1])
        v_now = np.pi * tls.calc_analyt_planck_in_interval(
            BB_now, int_lambda[index], int_lambda[index + 1])
        if v_before != v_now:
            BB_new = BB_now - ((v_now - converted_flux[index])
                               / (v_now - v_before) * (BB_now - BB_before))
        else:
            BB_new = BB_now
        BB_before, BB_now = BB_now, BB_new
    return float(BB_new)


def opacity_grid_wavelengths(opac_file):
    """(centers, interfaces-or-None) from an opacity HDF5 file
    (functions.py:294-310)."""
    import h5py
    with h5py.File(opac_file, "r") as f:
        for key in ("centre wavelengths", "center wavelengths"):
            if key in f:
                return (np.asarray(f[key][:]),
                        np.asarray(f["interface wavelengths"][:]))
        if "wavelengths" in f:
            return np.asarray(f["wavelengths"][:]), None
    raise IOError("Unable to read wavelength data set!")


def convert_star(star: dict, convert_to: str, opac_file: str,
                 output_file: str, mode: str = "automatic",
                 BB_temp: Optional[float] = None,
                 phoenix_dir: str = "./input/phoenix/",
                 download: bool = False):
    """Full star_tool conversion (functions.py:292-486, non-interactive).

    star: dict with name, data_format (phoenix|ascii|muscles|btsettl),
    temp, and format-specific keys (source_file, w/flux conversion
    factors, log_g, m, distance_from_Earth, R_star).
    Returns (new_lambda, converted_flux); writes the HDF5 output.
    """
    import h5py

    new_lambda, int_lambda = opacity_grid_wavelengths(opac_file)

    fmt = star["data_format"]
    if fmt == "phoenix":
        # interpolation checks/downloads the grid files (incl. the WAVE
        # file) before anything is read
        orig_flux = interpol_phoenix_spectrum(
            phoenix_dir, star["name"], star["temp"], star["log_g"],
            star["m"], download=download)
        orig_lambda = phoenix_wavelengths(phoenix_dir)
    elif fmt == "ascii":
        orig_lambda, orig_flux = read_ascii_file(
            star["source_file"], star["w_conversion_factor"],
            star["flux_conversion_factor"],
            star.get("skip_header", 8))
    elif fmt == "muscles":
        orig_lambda, orig_flux = read_muscles_file(
            star["source_file"], star["w_conversion_factor"],
            star["flux_conversion_factor"], star["distance_from_Earth"],
            star["R_star"])
    elif fmt == "btsettl":
        orig_lambda, orig_flux = read_btsettl_file(
            star["source_file"], star["w_conversion_factor"],
            star["flux_conversion_factor"])
    else:
        raise IOError(f"unknown data format {fmt!r}")

    order = np.argsort(orig_lambda)
    orig_lambda = np.asarray(orig_lambda)[order]
    orig_flux = np.asarray(orig_flux)[order]

    if BB_temp is None:
        BB_temp = star["temp"]

    converted = tls.convert_spectrum(orig_lambda, orig_flux, new_lambda,
                                     int_lambda=int_lambda,
                                     extrapolate_with_BB_T=BB_temp)

    if mode == "automatic":
        il = (int_lambda if int_lambda is not None
              else tls._edges_from_centers(new_lambda))
        BB_temp = fit_bb_extrapolation_temp(orig_lambda, converted, il,
                                            BB_temp)
        converted = tls.convert_spectrum(orig_lambda, orig_flux,
                                         new_lambda, int_lambda=int_lambda,
                                         extrapolate_with_BB_T=BB_temp)

    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with h5py.File(output_file, "a") as f:
        path = f"/{convert_to}/{fmt}/{star['name']}"
        if path in f:
            del f[path]
        f.create_dataset(path, data=converted)
        lpath = f"/{convert_to}/lambda"
        if lpath in f:
            del f[lpath]
        f.create_dataset(lpath, data=new_lambda)
        if fmt == "phoenix":
            opath = "/original/phoenix/lambda"
            if opath in f:
                del f[opath]
            f.create_dataset(opath, data=orig_lambda)

    return new_lambda, converted
