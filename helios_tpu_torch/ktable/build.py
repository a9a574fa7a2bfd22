"""ktable stage 1: build per-species opacity tables from HELIOS-K output.

Parity with reference ktable/source_ktable/build_individual_opacities.py:
scans a directory of HELIOS-K ``Out_*`` files (wavenumber range,
temperature, and pressure encoded in the file name), concatenates the
wavenumber chunks per (T, P), and produces either a **sampled** opacity
table (point-picking on a fixed-R wavelength grid) or a
**k-distribution** table (per-bin sort of kappa, cumulative weights,
interpolation onto Gauss-Legendre y-points).

The per-bin k-distribution construction -- the pipeline's hot loop -- has
a C++ implementation (helios_tpu_torch/ktable/native, built with g++ at
first use) and this module's numpy version, which ``use_native=False``
selects and which is its oracle; a native build that fails raises.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from helios_tpu_torch.io.opacity import gauss_legendre_ypoints

MIN_OPAC = 1e-15


# HELIOS-K filename pressure codes -> cgs pressure exponents: n800..n033
# and p000..p400 in thirds/halves of a decade, SI->cgs shift of 6 decades
# (build_individual_opacities.py:58-109)
_PRESS_CODES = []
for code, expo in [
        ("n800", -2), ("n766", -1.66666666), ("n750", -1.5),
        ("n733", -1.33333333), ("n700", -1), ("n666", -0.66666666),
        ("n650", -0.5), ("n633", -0.33333333), ("n600", 0),
        ("n566", 0.33333333), ("n550", 0.5), ("n533", 0.66666666),
        ("n500", 1), ("n466", 1.33333333), ("n450", 1.5),
        ("n433", 1.66666666), ("n400", 2), ("n366", 2.33333333),
        ("n350", 2.5), ("n333", 2.66666666), ("n300", 3),
        ("n266", 3.33333333), ("n250", 3.5), ("n233", 3.66666666),
        ("n200", 4), ("n166", 4.33333333), ("n150", 4.5),
        ("n133", 4.66666666), ("n100", 5), ("n066", 5.33333333),
        ("n050", 5.5), ("n033", 5.66666666), ("p000", 6),
        ("p033", 6.33333333), ("p050", 6.5), ("p066", 6.66666666),
        ("p100", 7), ("p133", 7.33333333), ("p150", 7.5),
        ("p166", 7.66666666), ("p200", 8), ("p233", 8.33333333),
        ("p250", 8.5), ("p266", 8.66666666), ("p300", 9),
        ("p333", 9.33333333), ("p350", 9.5), ("p366", 9.66666666),
        ("p400", 10)]:
    _PRESS_CODES.append((code, float(expo)))

PRESS_DICT = {c: 10.0 ** e for c, e in _PRESS_CODES}


def gen_fixed_res_grid(bot_limit, top_limit, resolution):
    """Constant-R wavelength grid (build_individual_opacities.py:127-140).
    """
    pts = []
    p = bot_limit
    fac = (resolution + 1.0) / resolution
    while p < top_limit:
        pts.append(p)
        p *= fac
    return np.asarray(pts)


@dataclass
class HeliosKFileSet:
    """Parsed directory of HELIOS-K output chunks."""
    directory: str
    file_name: Optional[str]          # optional species tag in the names
    numin: List[int]
    numax: List[int]
    temps: List[int]
    press_codes: List[str]            # ascending pressure order
    ending: str

    @property
    def pressures(self) -> np.ndarray:
        return np.asarray([PRESS_DICT[c] for c in self.press_codes])

    def path(self, n: int, t: int, p: int) -> str:
        if self.file_name is None:
            base = "Out_{:05d}_{:05d}_{:05d}_".format(
                self.numin[n], self.numax[n], self.temps[t])
        else:
            base = "Out_{}_{:05d}_{:05d}_{:05d}_".format(
                self.file_name, self.numin[n], self.numax[n], self.temps[t])
        return os.path.join(self.directory, base + self.press_codes[p]
                            + self.ending)


def scan_heliosk_directory(directory: str,
                           heliosk_format: str = "binary") -> HeliosKFileSet:
    """Recover the (nu, T, P) grid from the file names
    (build_individual_opacities.py:232-323)."""
    files = [f for f in os.listdir(directory)
             if f.startswith("Out_") and "_cbin" not in f]
    ending = ".bin" if heliosk_format in ("binary", "bin") else ".dat"
    files = [f for f in files if f.endswith(ending)]
    if not files:
        raise TypeError(
            "No files with the correct format found in the chosen "
            "directory.")

    example = files[0]
    stem = example[:-len(ending)]
    parts = stem.split("_")
    # layout: Out[_name..]_numin_numax_temp_press
    name = "_".join(parts[1:-4]) if len(parts) > 5 else None

    numin, numax, temps, codes = set(), set(), set(), set()
    for f in files:
        p = f[:-len(ending)].split("_")
        numin.add(int(p[-4]))
        numax.add(int(p[-3]))
        temps.add(int(p[-2]))
        codes.add(p[-1])

    codes = sorted(codes, key=lambda c: PRESS_DICT[c])
    return HeliosKFileSet(directory=directory, file_name=name,
                          numin=sorted(numin), numax=sorted(numax),
                          temps=sorted(temps), press_codes=codes,
                          ending=ending)


def read_chunk(path: str, heliosk_format: str) -> np.ndarray:
    if heliosk_format in ("binary", "bin"):
        return np.fromfile(path, np.float32, -1, "")
    vals = []
    with open(path) as f:
        for line in f:
            col = line.split()
            if col:
                vals.append(float(col[1]))
    return np.asarray(vals)


# --------------------------------------------------------------------------- #
# k-distribution construction (the hot loop)
# --------------------------------------------------------------------------- #

def kdistribution_bin(lamda_hk, opac_hk, lam_lo, lam_hi, delta_lam,
                      y_gauss):
    """k-distribution of one wavelength bin
    (build_individual_opacities.py:438-494).

    lamda_hk/opac_hk: ascending-wavelength points inside the bin.
    Returns [ny] opacities at the Gauss y-points.
    """
    n = len(lamda_hk)
    ny = len(y_gauss)
    if n == 0:
        return np.full(ny, MIN_OPAC)
    if n == 1:
        return np.full(ny, max(MIN_OPAC, opac_hk[0]))

    logk = np.log10(np.maximum(opac_hk, MIN_OPAC))
    w = np.empty(n)
    w[0] = (lamda_hk[0] - lam_lo) + (lamda_hk[1] - lamda_hk[0]) / 2
    w[1:-1] = (lamda_hk[2:] - lamda_hk[:-2]) / 2
    w[-1] = (lam_hi - lamda_hk[-1]) + (lamda_hk[-1] - lamda_hk[-2]) / 2
    w /= delta_lam

    order = np.argsort(logk, kind="stable")
    logk = logk[order]
    w = w[order]

    y = np.empty(n)
    y[0] = 0.5 * w[0]
    y[1:] = 0.5 * (w[:-1] + w[1:])
    y = np.cumsum(y)

    out = np.interp(y_gauss, y, logk)   # edge-clamped like the reference
    return 10.0 ** out


def kdistribution_for_one_TP(lamda_hk, opac_hk, lamda_int, delta_lamda,
                             y_gauss, use_native: bool = True):
    """All bins of one (T, P) point.  lamda_hk ascending; opac_hk aligned.

    Returns [nbin * ny] (bin-major, y-fastest -- the reference layout).
    """
    if use_native:
        from helios_tpu_torch.ktable.native import kdistr_native
        return kdistr_native(lamda_hk, opac_hk, lamda_int, delta_lamda,
                             y_gauss)

    nbin = len(lamda_int) - 1
    ny = len(y_gauss)
    out = np.empty(nbin * ny)
    starts = np.searchsorted(lamda_hk, lamda_int)
    for x in range(nbin):
        s, e = starts[x], starts[x + 1]
        out[x * ny:(x + 1) * ny] = kdistribution_bin(
            lamda_hk[s:e], opac_hk[s:e], lamda_int[x], lamda_int[x + 1],
            delta_lamda[x], y_gauss)
    return out


# --------------------------------------------------------------------------- #
# the per-species build
# --------------------------------------------------------------------------- #

@dataclass
class BuildConfig:
    format: str = "k-distribution"       # k-distribution | sampling
    heliosk_format: str = "binary"       # binary | text
    # fixed_resolution | file | native_helios-k
    grid_format: str = "fixed_resolution"
    grid_limits: Tuple[float, float] = (0.34, 30.0)   # micron
    resolution: float = 50.0
    grid_file_path: str = ""
    n_gauss: int = 20
    output_dir: str = "./output_ktable/"


def read_grid_file(path: str) -> np.ndarray:
    """Wavelength grid from a one-column ASCII file [cm]
    (build_individual_opacities.py:143-152)."""
    return np.asarray([float(line.split()[0]) for line in open(path)
                       if line.split()])


def build_wavelength_grid(cfg: BuildConfig):
    """(lamda centers, lamda_int, delta_lamda, y_gauss) for k-distribution;
    (lamda, None, None, None) for sampling
    (build_individual_opacities.py:154-223)."""
    if cfg.grid_format == "native_helios-k":
        # constant delta_nu = 0.01 cm^-1 raster, sampling only
        # (build_individual_opacities.py:181-194)
        if cfg.format == "k-distribution":
            raise IOError(
                "The native HELIOS-K resolution setting only works with "
                "the sampling method, not k-distribution.")
        nu = np.arange(0.01, 41000.0 + 0.01, 0.01)
        return np.sort(1.0 / nu), None, None, None

    if cfg.grid_format == "file":
        grid = read_grid_file(cfg.grid_file_path)
    else:
        bot = cfg.grid_limits[0] * 1e-4
        top = cfg.grid_limits[1] * 1e-4
        grid = gen_fixed_res_grid(bot, top, cfg.resolution)

    if cfg.format == "sampling":
        # snap to the HELIOS-K 0.01 cm^-1 wavenumber raster
        # (build_individual_opacities.py:199-210)
        nu = np.round(1.0 / grid[::-1], 2)
        return np.sort(1.0 / nu), None, None, None
    lam_int = grid
    lam = 0.5 * (lam_int[1:] + lam_int[:-1])
    dlam = np.diff(lam_int)
    y, _ = gauss_legendre_ypoints(cfg.n_gauss)
    return lam, lam_int, dlam, y


def build_species(cfg: BuildConfig, name: str, directory: str,
                  use_native: bool = True) -> str:
    """Build one species table; returns the written HDF5 path
    (build_individual_opacities.py:225-526)."""
    import h5py

    fs = scan_heliosk_directory(directory, cfg.heliosk_format)
    lam, lam_int, dlam, y_gauss = build_wavelength_grid(cfg)

    press = fs.pressures
    temps = np.asarray(fs.temps, float)

    # HK wavenumber grid from the first chunk
    first = read_chunk(fs.path(0, 0, 0), cfg.heliosk_format)
    hk_res = (fs.numax[0] - fs.numin[0]) / len(first)
    nu_hk = np.arange(fs.numin[0], fs.numax[-1], hk_res)

    if cfg.format == "k-distribution":
        lam_hk = np.where(nu_hk > 0, 1.0 / np.maximum(nu_hk, 1e-30), 1e4)
        lam_hk = lam_hk[::-1]

    all_out = []
    for t in range(len(fs.temps)):
        for p in range(len(fs.press_codes)):
            chunks = [read_chunk(fs.path(n, t, p), cfg.heliosk_format)
                      for n in range(len(fs.numin))]
            opac_nu = np.concatenate(chunks)

            if cfg.format == "sampling":
                nu = np.round(1.0 / (lam[::-1]), 2)[::-1]
                nu_grid = np.sort(nu)
                idx = np.round((nu_grid - fs.numin[0]) / hk_res).astype(int)
                inside = (nu_grid >= fs.numin[0]) & (nu_grid < fs.numax[-1])
                vals = np.full(len(nu_grid), MIN_OPAC)
                ii = np.clip(idx, 0, len(opac_nu) - 1)
                vals[inside] = opac_nu[ii[inside]]
                all_out.extend(vals[::-1])   # ascending wavelength
            else:
                opac_lam = opac_nu[::-1]
                all_out.extend(kdistribution_for_one_TP(
                    lam_hk[:len(opac_lam)], opac_lam, lam_int, dlam,
                    y_gauss, use_native=use_native))

    os.makedirs(cfg.output_dir, exist_ok=True)
    if cfg.format == "sampling":
        path = os.path.join(cfg.output_dir, f"{name}_opac_sampling.h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("pressures", data=press)
            f.create_dataset("temperatures", data=temps)
            f.create_dataset("wavelengths", data=lam)
            f.create_dataset("opacities", data=np.asarray(all_out))
    else:
        path = os.path.join(cfg.output_dir, f"{name}_opac_kdistr.h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("pressures", data=press)
            f.create_dataset("temperatures", data=temps)
            f.create_dataset("interface wavelengths", data=lam_int)
            f.create_dataset("center wavelengths", data=lam)
            f.create_dataset("wavelength width of bins", data=dlam)
            f.create_dataset("ypoints", data=y_gauss)
            f.create_dataset("kpoints", data=np.asarray(all_out))
    return path
