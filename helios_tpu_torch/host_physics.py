"""Host-side physics helpers: Koll f-factor approximation, tau_lw/tau_sw
estimation, surface-albedo and additional-heating file loading, and the
final energy-balance report.

Parity with reference source/host_functions.py:51-161, :187-200, :1021-1042
and source/read.py:1238-1264, source/additional_heating.py.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from helios_tpu_torch import constants as pc


def planck_lambda_np(lamda, temp):
    """B_lambda (host numpy; host_functions.py:80-89)."""
    return (2 * pc.H * pc.C ** 2 / lamda ** 5
            / (np.exp(pc.H * pc.C / (lamda * pc.K_B * temp)) - 1.0))


def approx_f_from_formula(*, tau_lw: float, p_boa: float, R_star: float,
                          a: float, T_star: float) -> float:
    """Heat-redistribution factor f, Eq. (10) of Koll (2021)
    (host_functions.py:51-77)."""
    T_eq = (R_star / (2.0 * a)) ** 0.5 * T_star
    term = tau_lw * (p_boa / 1e6) ** (2.0 / 3.0) * (T_eq / 600.0) ** (-4.0 / 3.0)
    return 2.0 / 3.0 - 5.0 / 12.0 * term / (2.0 + term)


def read_tau_lw_from_file(output_dir: str, name: str) -> Optional[float]:
    """Read tau_lw from a previous run's output (host_functions.py:54-70).
    The '_post' suffix falls back to the base run's file."""
    if name.endswith("_post"):
        name = name[:-5]
    path = os.path.join(output_dir, name,
                        f"{name}_tau_lw_tau_sw_f_factor.dat")
    try:
        with open(path) as f:
            lines = f.read().splitlines()
        return float(lines[2].split()[0])
    except (IOError, IndexError, ValueError):
        return None


def calc_tau_lw_sw(delta_tau_band, wave_centers, delta_wave, T_surf,
                   T_star) -> Tuple[float, float]:
    """Band-averaged longwave/shortwave optical depth TOA->BOA, weighted by
    the surface / stellar Planck function (host_functions.py:92-156).

    delta_tau_band: [L, B].
    """
    tau_tot = np.sum(np.asarray(delta_tau_band), axis=0)      # [B]
    B_surf = planck_lambda_np(wave_centers, T_surf)

    num_lw = np.sum(B_surf * np.exp(-tau_tot) * delta_wave)
    denom_lw = np.sum(B_surf * delta_wave)
    tau_lw = -np.log(num_lw / denom_lw)

    if T_star > 10:
        B_star = planck_lambda_np(wave_centers, T_star)
        num_sw = np.sum(B_star * np.exp(-tau_tot) * delta_wave)
        tau_sw = -np.log(num_sw / np.sum(B_star * delta_wave))
    else:
        tau_sw = 0.0

    # overflow fallback: linear-in-tau average (host_functions.py:128-156;
    # the reference's second pass accumulates on top of the first --
    # including that quirk would double-count, we use the clean average)
    if np.isinf(tau_lw):
        tau_lw = float(np.sum(B_surf * tau_tot * delta_wave) / denom_lw)
        if T_star > 10:
            tau_sw = float(np.sum(B_star * tau_tot * delta_wave)
                           / np.sum(B_star * delta_wave))
    return float(tau_lw), float(tau_sw)


def write_tau_lw_sw_file(output_dir: str, name: str, tau_lw: float,
                         tau_sw: float, f_factor: float):
    """host_functions.py:158-161."""
    d = os.path.join(output_dir, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}_tau_lw_tau_sw_f_factor.dat"),
              "w") as f:
        f.write("This file contains the total longwave and shortwave "
                "optical depths at BOA (=surface), tau_lw and tau_sw, and "
                "the f factor as used in the model")
        f.write("\n{:<15}{:<15}{:<15}".format("tau_lw", "tau_sw",
                                              "f_factor"))
        f.write("\n{:<15g}{:<15g}{:<15g}".format(tau_lw, tau_sw, f_factor))


def load_surf_albedo(cfg, wave_centers) -> np.ndarray:
    """Surface albedo per wavelength: file interpolation or clamped
    constant (read.py:1238-1264)."""
    if cfg.surf_albedo == "file":
        tbl = np.genfromtxt(cfg.albedo_file, names=True, dtype=None,
                            skip_header=cfg.albedo_file_header_lines)
        lam = np.asarray(tbl[cfg.albedo_file_wavelength_name], float)
        if cfg.albedo_file_wavelength_unit == "micron":
            lam = lam * 1e-4
        elif cfg.albedo_file_wavelength_unit == "m":
            lam = lam * 1e2
        alb = np.asarray(tbl[cfg.albedo_surface_name], float)
        order = np.argsort(lam)
        return np.interp(wave_centers, lam[order], alb[order])
    val = max(1e-8, min(0.999, float(cfg.surf_albedo)))
    return np.full(len(wave_centers), val)


def load_additional_heating(cfg, p_lay) -> np.ndarray:
    """Volumetric heating density interpolated to layers in log-P
    (additional_heating.py:29-75).  Returns [L] [erg s^-1 cm^-3]."""
    if not cfg.add_heating:
        return np.zeros(len(p_lay))
    tbl = np.genfromtxt(cfg.add_heating_path, names=True, dtype=None,
                        skip_header=cfg.add_heating_file_header_lines)
    press = np.asarray(tbl[cfg.add_heating_file_press_name], float)
    if cfg.add_heating_file_press_unit == "bar":
        press = press * 1e6
    elif cfg.add_heating_file_press_unit == "Pa":
        press = press * 10.0
    elif cfg.add_heating_file_press_unit != "cgs":
        raise IOError("Unknown pressure unit in additional heating file.")
    names = [n for n in tbl.dtype.names
             if n != cfg.add_heating_file_press_name]
    heat = np.asarray(tbl[names[0]], float)
    order = np.argsort(press)
    return np.interp(np.log10(p_lay), np.log10(press[order]), heat[order])


def temp_calcs(*, R_star, a, T_star, f_factor, dir_beam, mu_star,
               F_down_tot_toa, F_up_tot_toa):
    """Effective/brightness temperatures (host_functions.py:187-200)."""
    rt = (R_star / a) ** 0.5 * T_star
    T_eff_global = 0.25 ** 0.25 * rt
    T_eff_dayside = 0.667 ** 0.25 * rt
    T_eff_model = ((1.0 - dir_beam) * f_factor ** 0.25 * rt
                   + dir_beam * abs(mu_star) ** 0.25 * rt)
    T_star_bright = (F_down_tot_toa / pc.SIGMA_SB) ** 0.25
    T_planet_bright = (F_up_tot_toa / pc.SIGMA_SB) ** 0.25
    return (T_eff_global, T_eff_dayside, T_eff_model, T_star_bright,
            T_planet_bright)


def global_energy_balance(F_net, F_add_heat_sum, F_smooth_sum, F_intern,
                          F_down_tot_boa_idx) -> float:
    """Relative global energy imbalance at TOA, the reference's final
    self-check printout (host_functions.py:1021-1042)."""
    L = len(F_net) - 1
    resid = abs(F_intern + F_add_heat_sum[L - 1] + F_smooth_sum[L - 1]
                - F_net[L])
    return float(resid / (F_down_tot_boa_idx + F_intern))
