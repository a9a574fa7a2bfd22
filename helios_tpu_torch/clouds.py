"""Cloud decks: Mie-file preprocessing and vertical distribution (a copy of
:mod:`helios_tpu.clouds`, which imports only numpy; keep the two alike).

Rebuild of reference source/clouds.py: reads LX-Mie cross-section files,
weights them over a log-normal particle-size distribution, interpolates to
the model wavelength grid, builds cloud decks (parameterized bottom
pressure + cloud-to-gas scale-height ratio, or vertical mixing-ratio
file), and accumulates multiple decks into the total cloud absorption /
scattering cross-sections and asymmetry parameter consumed by the
transmission op.

One deliberate deviation: the reference's size-distribution weighting of
g_0 sums the *scattering cross-section* instead of g_0 (clouds.py:111 --
``g_0 = sum(scat_cross_per_r * pdf * delta_r)``, a clear typo that makes
the "asymmetry parameter" carry cm^2 units).  Here g_0 is
scattering-weighted over the size distribution, the standard Mie-averaging
choice the surrounding code expects.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from helios_tpu_torch import tools


# hardcoded LX-Mie particle-size grid: r = 1e-2..1e3 micron, 0.1 dex steps
# (reference clouds.py:89-91)
R_VALUES_MICRON = 10.0 ** np.arange(-2, 3.1, 0.1)
DELTA_R_MICRON = R_VALUES_MICRON * (10 ** 0.05 - 10 ** -0.05)


def read_mie_file(path: str):
    """Read one LX-Mie output file (clouds.py:52-70).

    Returns (lambda [cm], scat_cross [cm^2], abs_cross [cm^2], g_0).
    """
    lam, scat, absx, g0 = [], [], [], []
    with open(path) as f:
        next(f)
        for line in f:
            col = line.split()
            if not col:
                continue
            lam.append(float(col[0]) * 1e-4)
            scat.append(float(col[3]))
            absx.append(float(col[4]))
            g0.append(float(col[6]))
    return (np.asarray(lam), np.asarray(scat), np.asarray(absx),
            np.asarray(g0))


def lognorm_pdf(r, r_mode, sigma):
    """Log-normal size distribution parameterized by mode radius and
    geometric std deviation (clouds.py:72-80)."""
    r_median = r_mode / np.exp(-np.log(sigma) ** 2)
    norm = 1.0 / (r * np.log(sigma) * np.sqrt(2.0 * np.pi))
    return norm * np.exp(-0.5 * (np.log(r / r_median) / np.log(sigma)) ** 2)


def size_weighted_cross_sections(mie_dir: str, r_mode: float,
                                 r_std_dev: float, wave_centers,
                                 wave_edges):
    """Log-normal-weighted Mie cross-sections on the model wavelength grid
    (clouds.py:82-120).

    Returns (abs_cross [B], scat_cross [B], g_0 [B]).
    """
    pdf = lognorm_pdf(R_VALUES_MICRON, r_mode, r_std_dev)

    first = os.path.join(mie_dir, "r{:.6f}.dat".format(R_VALUES_MICRON[0]))
    lam_mie, _, _, _ = read_mie_file(first)
    n_r, n_l = len(R_VALUES_MICRON), len(lam_mie)

    scat_r = np.zeros((n_r, n_l))
    abs_r = np.zeros((n_r, n_l))
    g0_r = np.zeros((n_r, n_l))
    for i, r in enumerate(R_VALUES_MICRON):
        _, scat_r[i], abs_r[i], g0_r[i] = read_mie_file(
            os.path.join(mie_dir, "r{:.6f}.dat".format(r)))

    w = pdf * DELTA_R_MICRON
    abs_w = w @ abs_r
    scat_w = w @ scat_r
    # scattering-weighted g_0 (fixes the reference's clouds.py:111 typo)
    with np.errstate(invalid="ignore", divide="ignore"):
        g0_w = np.where(scat_w > 0, (w @ (g0_r * scat_r)) / scat_w, 0.0)

    abs_new = tools.convert_spectrum(lam_mie, abs_w, wave_centers,
                                     int_lambda=wave_edges, type="log")
    scat_new = tools.convert_spectrum(lam_mie, scat_w, wave_centers,
                                      int_lambda=wave_edges, type="log")
    g0_new = tools.convert_spectrum(lam_mie, g0_w, wave_centers,
                                    int_lambda=wave_edges, type="linear")
    return abs_new, scat_new, g0_new


def manual_cloud_deck(p_lay, p_int, p_cloud_bot, f_cloud_bot,
                      cloud_to_gas_scale_height, iso: int):
    """Parameterized cloud deck: mixing ratio f at the bottom layer,
    decaying upward as (p/p_bot)^(1/H_ratio - 1) (clouds.py:122-148).

    Returns (f_lay [L], f_int [L+1])."""
    L = len(p_lay)
    f_lay = np.zeros(L)
    f_int = np.zeros(L + 1)
    i_bot = 0
    found = False
    for i in range(L):
        if p_int[i] >= p_cloud_bot > p_int[i + 1]:
            f_lay[i] = f_cloud_bot
            i_bot = i
            found = True
            break
    if found:
        expo = 1.0 / cloud_to_gas_scale_height - 1.0
        for i in range(i_bot + 1, L):
            f_lay[i] = f_cloud_bot * (p_lay[i] / p_lay[i_bot]) ** expo
        if iso == 0:
            for i in range(i_bot + 1, L + 1):
                f_int[i] = f_cloud_bot * (p_int[i] / p_lay[i_bot]) ** expo
    return f_lay, f_int


def file_cloud_deck(cloud_table, species_col, file_press, p_lay, p_int,
                    iso: int):
    """Vertical cloud mixing ratio from file, interpolated in log-P
    (clouds.py:150-177)."""
    f = np.asarray(cloud_table[species_col], float)
    logf = np.log10(np.asarray(file_press, float))
    order = np.argsort(logf)
    logf, f = logf[order], f[order]
    f_lay = np.interp(np.log10(p_lay), logf, f)
    f_int = (np.interp(np.log10(p_int), logf, f) if iso == 0
             else np.zeros(len(p_int)))
    return f_lay, f_int


@dataclass
class CloudDeckResult:
    """Accumulated cloud fields consumed by the transmission op and the
    output writers (clouds.py:179-253)."""
    f_lay: np.ndarray                 # [L]
    f_int: np.ndarray                 # [L+1]
    abs_cross_lay: np.ndarray         # [L, B]
    abs_cross_int: np.ndarray         # [L+1, B]
    scat_cross_lay: np.ndarray        # [L, B]
    scat_cross_int: np.ndarray        # [L+1, B]
    g_0_lay: np.ndarray               # [L, B]
    g_0_int: np.ndarray               # [L+1, B]


def cloud_pre_processing(cfg, wave_centers, wave_edges, p_lay, p_int,
                         iso: int) -> CloudDeckResult:
    """Full multi-deck preprocessing (clouds.py:228-253).

    cfg provides: nr_cloud_decks, mie_dirs, cloud_radius_mode,
    cloud_radius_geo_std, cloud_mixing_ratio_source, cloud_bottom_pressure,
    cloud_bottom_mixing_ratio, cloud_to_gas_scale_height, cloud_file*,
    aerosol_names.
    """
    L, B = len(p_lay), len(wave_centers)
    out = CloudDeckResult(
        f_lay=np.zeros(L), f_int=np.zeros(L + 1),
        abs_cross_lay=np.zeros((L, B)), abs_cross_int=np.zeros((L + 1, B)),
        scat_cross_lay=np.zeros((L, B)),
        scat_cross_int=np.zeros((L + 1, B)),
        g_0_lay=np.zeros((L, B)), g_0_int=np.zeros((L + 1, B)))

    if cfg.nr_cloud_decks == 0:
        return out

    cloud_table = file_press = None
    if cfg.cloud_mixing_ratio_source == "file":
        cloud_table = np.genfromtxt(
            cfg.cloud_file, names=True, dtype=None,
            skip_header=cfg.cloud_file_header_lines)
        file_press = np.asarray(
            cloud_table[cfg.cloud_file_press_name], float)
        if cfg.cloud_file_press_unit == "Pa":
            file_press = file_press * 10.0
        elif cfg.cloud_file_press_unit == "bar":
            file_press = file_press * 1e6

    for nr in range(cfg.nr_cloud_decks):
        abs_c, scat_c, g0_c = size_weighted_cross_sections(
            cfg.mie_dirs[nr], cfg.cloud_radius_mode[nr],
            cfg.cloud_radius_geo_std[nr], wave_centers, wave_edges)

        if cfg.cloud_mixing_ratio_source == "manual":
            f_lay, f_int = manual_cloud_deck(
                p_lay, p_int, cfg.cloud_bottom_pressure[nr],
                cfg.cloud_bottom_mixing_ratio[nr],
                cfg.cloud_to_gas_scale_height[nr], iso)
        else:
            f_lay, f_int = file_cloud_deck(
                cloud_table, cfg.aerosol_names[nr], file_press, p_lay,
                p_int, iso)

        out.f_lay += f_lay
        out.f_int += f_int
        out.abs_cross_lay += f_lay[:, None] * abs_c[None, :]
        out.scat_cross_lay += f_lay[:, None] * scat_c[None, :]
        out.g_0_lay += (f_lay[:, None] * scat_c[None, :]) * g0_c[None, :]
        if iso == 0:
            out.abs_cross_int += f_int[:, None] * abs_c[None, :]
            out.scat_cross_int += f_int[:, None] * scat_c[None, :]
            out.g_0_int += ((f_int[:, None] * scat_c[None, :])
                            * g0_c[None, :])

    # normalize g_0 by the accumulated scattering (clouds.py:206-226)
    with np.errstate(invalid="ignore", divide="ignore"):
        out.g_0_lay = np.where(out.scat_cross_lay > 0,
                               out.g_0_lay / out.scat_cross_lay, 0.0)
        out.g_0_int = np.where(out.scat_cross_int > 0,
                               out.g_0_int / out.scat_cross_int, 0.0)
    return out
