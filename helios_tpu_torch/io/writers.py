"""Output writers: format-parity .dat files (a copy of
:mod:`helios_tpu.io.writers`, which imports only numpy; keep the two alike).

Reproduces the reference's output-file formats (source/write.py:34-776) so
downstream tooling (plotting scripts, coupling pipelines, Pandexo readers)
works unchanged.  The writers consume a :class:`RunResult` -- a plain
host-side numpy snapshot assembled once from the final device state (one
device->host transfer, vs. the reference's per-array copies).

Column layouts, headers, and number formats match write.py line-for-line
(citations per writer).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from helios_tpu_torch import constants as pc


def _yes_no(v) -> str:
    return "yes" if v == 1 else "no"


def _mean_werror(q) -> str:
    """write.py:54-60."""
    if q == -3:
        return "{:<20}".format("temp_too_low")
    return "{:<20g}".format(q)


@dataclass
class RunResult:
    """Host-side snapshot of a finished run (device->host once)."""
    # static
    name: str
    output_dir: str
    nlayer: int
    nbin: int
    iso: int
    convection: int
    singlewalk: int
    T_star: float
    R_planet: float
    R_star: float
    F_intern: float
    star_corr_factor: float = 1.0
    input_kappa_value: object = 0.0
    input_surf_albedo: object = 0.0
    albedo_file_surface_name: str = ""

    # vertical grid [nlayer] / [nlayer+1]
    p_lay: np.ndarray = None
    p_int: np.ndarray = None
    delta_colmass: np.ndarray = None
    T_lay: np.ndarray = None            # [nlayer+1] incl. surface ghost
    z_lay: np.ndarray = None
    delta_z_lay: np.ndarray = None
    meanmolmass_lay: np.ndarray = None
    c_p_lay: np.ndarray = None
    kappa_lay: np.ndarray = None
    entropy_lay: np.ndarray = None
    phase_number_lay: np.ndarray = None
    conv_unstable: np.ndarray = None    # [nlayer+1] int
    conv_layer: np.ndarray = None       # [nlayer+1] int

    # spectral grid [nbin]
    opac_wave: np.ndarray = None        # centers [cm]
    opac_interwave: np.ndarray = None   # lower edges [cm] ([nbin+1] ok)
    opac_deltawave: np.ndarray = None

    # fluxes
    F_down_tot: np.ndarray = None       # [ninterface]
    F_up_tot: np.ndarray = None
    F_net: np.ndarray = None
    F_dir_tot: np.ndarray = None
    F_net_diff: np.ndarray = None       # [nlayer]
    F_net_conv: np.ndarray = None       # [ninterface]
    F_add_heat_lay: np.ndarray = None   # [nlayer]
    F_add_heat_sum: np.ndarray = None
    F_smooth_sum: np.ndarray = None
    F_down_band: np.ndarray = None      # [ninterface, nbin]
    F_up_band: np.ndarray = None
    F_dir_band: np.ndarray = None

    # planck
    planckband_lay: np.ndarray = None   # [nlayer+2, nbin]
    planckband_int: np.ndarray = None   # [ninterface, nbin] (noniso)

    # per-band diagnostics [nlayer, nbin]
    opac_band_lay: np.ndarray = None
    scat_cross_lay: np.ndarray = None
    g_0_tot_lay: np.ndarray = None
    trans_band: np.ndarray = None
    delta_tau_band: np.ndarray = None
    contr_func_band: np.ndarray = None
    trans_weight_band: np.ndarray = None

    # mean opacities [nlayer]
    planck_opac_T_pl: np.ndarray = None
    ross_opac_T_pl: np.ndarray = None
    planck_opac_T_star: np.ndarray = None
    ross_opac_T_star: np.ndarray = None

    # clouds [nlayer] / [nlayer, nbin]
    f_all_clouds_lay: np.ndarray = None
    abs_cross_all_clouds_lay: np.ndarray = None
    scat_cross_all_clouds_lay: np.ndarray = None
    delta_tau_all_clouds: np.ndarray = None

    # surface
    surf_albedo: np.ndarray = None      # [nbin]

    # run metadata
    relaxed_criterion_trigger: int = 0
    rad_convergence_limit: float = 1e-8
    coupling_speed_up: int = 0
    coupling_iter_nr: int = 0
    coupling_full_output: int = 0

    @property
    def ninterface(self) -> int:
        return self.nlayer + 1

    @property
    def out(self) -> str:
        return os.path.join(self.output_dir, self.name)

    def path(self, suffix: str) -> str:
        return os.path.join(self.out, f"{self.name}{suffix}")

    def makedirs(self):
        os.makedirs(self.out, exist_ok=True)

    # quantities derived like host_functions.temp_calcs (:187-200)
    @property
    def T_planet_brightness(self) -> float:
        return float((self.F_up_tot[self.ninterface - 1] / pc.SIGMA_SB)
                     ** 0.25)


def _spectral_header(file, extra_cols=""):
    file.write(
        "\n{:<8}{:<18}{:21}{:19}".format(
            "bin", "cent_lambda[um]", "low_int_lambda[um]",
            "delta_lambda[um]") + extra_cols)


def _spectral_row_prefix(r: RunResult, x: int) -> str:
    return ("\n{:<8g}".format(x)
            + "{:<18.9g}".format(r.opac_wave[x] * 1e4)
            + "{:<21.9g}".format(r.opac_interwave[x] * 1e4)
            + "{:<19.9g}".format(r.opac_deltawave[x] * 1e4))


# --------------------------------------------------------------------------- #
# individual writers (formats: write.py citations)
# --------------------------------------------------------------------------- #

def write_abort_file(r: RunResult):
    """write.py:63-77."""
    r.makedirs()
    with open(r.path("_ABORT.dat"), "w") as f:
        f.write("The run exceeded the maximum number of iteration steps "
                "and was aborted. Sorry.")


def write_criterion_warning_file(r: RunResult):
    """write.py:80-95."""
    if r.relaxed_criterion_trigger == 1:
        r.makedirs()
        with open(r.path("_convergence_warning.dat"), "w") as f:
            f.write("WARNING: Due to exceeding runtime the convergence "
                    "criterion has been made more loose over time.\n")
            f.write("The final relative criterion used is: {:.1e} \n".format(
                r.rad_convergence_limit))
            f.write("Even with a looser (not loser) criterion, the model "
                    "results may still be accurate enough. "
                    "Use at your own discretion!")


def write_tp(r: RunResult):
    """write.py:113-151."""
    r.makedirs()
    with open(r.path("_tp.dat"), "w") as f:
        f.write("This file contains the corresponding layer temperatures "
                "and pressures, and the altitude and the height of each "
                "layer.")
        f.write("\n{:<8}{:<18}{:<24}{:<21}{:<23}{:<30}{:<32}{:<18}".format(
            "layer", "temp.[K]", "press.[10^-6bar]", "altitude[cm]",
            "height.of.layer[cm]", "conv.unstable?[1:yes,0:no]",
            "conv.lapse-rate?[1:yes,0:no]", "pl.eff.temp.[K]"))
        f.write("\n{:<8}{:<18g}{:<24g}{:<21g}{:<23}".format(
            "BOA", r.T_lay[r.nlayer], r.p_int[0],
            r.z_lay[0] - 0.5 * r.delta_z_lay[0], "not_avail."))
        if r.iso == 0 and r.convection == 1:
            f.write("{:<30g}{:<32g}".format(r.conv_unstable[r.nlayer],
                                            r.conv_layer[r.nlayer]))
        else:
            f.write("{:<30}{:<32}".format("not_calculated",
                                          "not_calculated"))
        f.write("{:<18g}".format(r.T_planet_brightness))
        for i in range(r.nlayer):
            f.write("\n{:<8g}".format(i)
                    + "{:<18g}".format(r.T_lay[i])
                    + "{:<24g}".format(r.p_lay[i])
                    + "{:<21g}".format(r.z_lay[i])
                    + "{:<23g}".format(r.delta_z_lay[i]))
            if r.iso == 0 and r.convection == 1:
                f.write("{:<30g}{:<32g}".format(r.conv_unstable[i],
                                                r.conv_layer[i]))
            else:
                f.write("{:<30}{:<32}".format("not_calculated",
                                              "not_calculated"))


def write_tp_cut(r: RunResult):
    """write.py:153-175."""
    r.makedirs()
    with open(r.path("_tp_cut.dat"), "w") as f:
        f.write("This file contains the corresponding layer temperatures "
                "and pressures.")
        f.write("\n{:<8}{:<18}{:<24}".format("layer", "temp.[K]",
                                             "press.[10^-6bar]"))
        f.write("\n{:<8}{:<18g}{:<24g}".format("BOA", r.T_lay[r.nlayer],
                                               r.p_int[0]))
        for i in range(r.nlayer):
            if r.p_lay[i] > 0.099:
                f.write("\n{:<8g}".format(i)
                        + "{:<18g}".format(r.T_lay[i])
                        + "{:<24g}".format(r.p_lay[i]))


def write_colmass_mu_cp_entropy(r: RunResult):
    """write.py:177-207."""
    r.makedirs()
    with open(r.path("_colmass_mu_cp_kappa_entropy.dat"), "w") as f:
        f.write("This file contains the total pressure and the column mass "
                "difference, mean molecular weight and specific heat "
                "capacity of each layer.")
        f.write("\n{:<8}{:<24}{:<26}{:<21}{:<32}{:<23}{:<30}".format(
            "layer", "cent.press.[10^-6bar]", "delta_col.mass[g cm^-2]",
            "mean mol. weight", "spec.heat cap.[erg mol^-1 K^-1]",
            "adiabatic coefficient", "entropy [erg g^-1 K^-1]"))
        for i in range(r.nlayer):
            f.write("\n{:<8g}".format(i)
                    + "{:<24g}".format(r.p_lay[i])
                    + "{:<26g}".format(r.delta_colmass[i])
                    + "{:<21g}".format(r.meanmolmass_lay[i] / pc.AMU))
            if r.c_p_lay is None or r.c_p_lay[i] == 0:
                f.write("{:<32s}".format("not_calculated"))
            else:
                f.write("{:<32g}".format(r.c_p_lay[i]))
            if r.kappa_lay is None or r.kappa_lay[i] == 0:
                f.write("{:<23s}".format("not_calculated"))
            else:
                f.write("{:<23g}".format(r.kappa_lay[i]))
            if r.entropy_lay is None or r.entropy_lay[i] == 0:
                f.write("{:<30s}".format("not_calculated"))
            else:
                f.write("{:<30g}".format(r.entropy_lay[i]))


def write_phase_state(r: RunResult):
    """write.py:209-232 (water_atmo kappa format only)."""
    if r.input_kappa_value != "water_atmo":
        return
    r.makedirs()
    with open(r.path("_state.dat"), "w") as f:
        f.write("Checks the phase state of the water atmosphere. If '1' the "
                "water in the atmosphere is vaporous or supercritical. "
                "If '<1' atmosphere might be unstable, i.e., water in liquid "
                "or solid form.")
        f.write("\n{:<8}{:<18}{:<24}{:<24}".format(
            "layer", "temp.[K]", "press.[10^-6bar]",
            "state_of_water (0: liquid or solid, 1: vapor or supercritical)"))
        for i in range(r.nlayer):
            if r.p_lay[i] > 0.99:
                f.write("\n{:<8g}".format(i)
                        + "{:<18g}".format(r.T_lay[i])
                        + "{:<24g}".format(r.p_lay[i])
                        + "{:<24g}".format(r.phase_number_lay[i]))


def write_integrated_flux(r: RunResult):
    """write.py:234-266."""
    r.makedirs()
    with open(r.path("_integrated_flux.dat"), "w") as f:
        f.write("This file contains the integrated total and net fluxes at "
                "each interface resp. layer. \nFluxes given in "
                "[erg s^-1 cm^-2].")
        f.write("\n{:<20}{:<24}{:<25}{:<25}{:<23}{:<25}{:<34}{:<24}{:<24}"
                "{:<12}".format(
                    "interface", "press.[10^-6bar]", "F_down", "F_up",
                    "F_net", "F_dir", "delta_F_net (layer quantity)",
                    "F_net_conv", "F_add_heat", "F_intern"))
        for i in range(r.ninterface):
            f.write("\n{:<20g}".format(i)
                    + "{:<24g}".format(r.p_int[i])
                    + "{:<25g}".format(r.F_down_tot[i])
                    + "{:<25g}".format(r.F_up_tot[i])
                    + "{:<23g}".format(r.F_net[i])
                    + "{:<25g}".format(r.F_dir_tot[i]))
            if r.singlewalk == 0 and i < r.nlayer:
                f.write("{:<34g}".format(r.F_net_diff[i]))
            else:
                f.write("{:<34}".format("not_avail."))
            f.write("{:<24g}".format(r.F_net_conv[i]))
            if i < r.nlayer:
                f.write("{:<24g}".format(r.F_add_heat_lay[i]))
            else:
                f.write("{:<24}".format("not_avail."))
            if i == 0:
                f.write("{:<12g}".format(r.F_intern))


def _write_spectral_interface_file(r: RunResult, suffix, description,
                                   col_label, data, fmt="{:<16.8e}"):
    """Shared layout of the per-interface spectral files
    (write.py:268-312, :376-396)."""
    r.makedirs()
    with open(r.path(suffix), "w") as f:
        f.write(description)
        _spectral_header(f)
        for i in range(r.ninterface):
            f.write("{:<{w}}{:g}{:<4}".format(col_label, i, "]",
                                              w=len(col_label)))
        for x in range(r.nbin):
            f.write(_spectral_row_prefix(r, x))
            for i in range(r.ninterface):
                f.write(fmt.format(data[i, x]))


def write_upward_spectral_flux(r: RunResult):
    """write.py:268-289."""
    _write_spectral_interface_file(
        r, "_spec_upflux.dat",
        "This file contains the upward spectral flux (per wavelength) at "
        "each interface. \nSpectral fluxes given in [erg s^-1 cm^-3].",
        "F_up[", r.F_up_band)


def write_downward_spectral_flux(r: RunResult):
    """write.py:291-312."""
    _write_spectral_interface_file(
        r, "_spec_downflux.dat",
        "This file contains the downward spectral flux (per wavelength) at "
        "each interface. \nSpectral fluxes given in [erg s^-1 cm^-3].",
        "F_down[", r.F_down_band)


def write_direct_spectral_beam_flux(r: RunResult):
    """write.py:375-396."""
    _write_spectral_interface_file(
        r, "_direct_beamflux.dat",
        "This file contains the direct irradiation flux (per wavelength) at "
        "each interface. \nSpectral fluxes given in [erg s^-1 cm^-3].",
        "F_dir[", r.F_dir_band)


def calc_F_ratio(r: RunResult) -> np.ndarray:
    """Planet/star flux ratio (host_functions.py:654-670)."""
    if r.T_star <= 10:
        return np.zeros(r.nbin)
    orbital_factor = (r.R_planet / r.R_star) ** 2
    star_BB = np.pi * r.planckband_lay[r.nlayer] / r.star_corr_factor
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(star_BB != 0,
                         orbital_factor * r.F_up_band[r.nlayer] / star_BB,
                         0.0)
    return ratio


def write_TOA_flux_eclipse_depth(r: RunResult):
    """write.py:314-339."""
    r.makedirs()
    F_ratio = calc_F_ratio(r)
    with open(r.path("_TOA_flux_eclipse.dat"), "w") as f:
        f.write("This file contains the downward and upward spectral flux "
                "(per wavelength) at TOA and the secondary eclipse depth "
                "(= planet to star flux ratio)."
                "\nSpectral fluxes given in [erg s^-1 cm^-3].")
        f.write("\n{:<8}{:<18}{:<21}{:<19}{:<16}{:<16}{:<24}".format(
            "bin", "cent_lambda[um]", "low_int_lambda[um]",
            "delta_lambda[um]", "F_down_at_TOA", "F_up_at_TOA",
            "planet/star flux ratio"))
        for x in range(r.nbin):
            f.write(_spectral_row_prefix(r, x))
            f.write("{:<16g}".format(r.F_down_band[r.nlayer, x])
                    + "{:<16g}".format(r.F_up_band[r.nlayer, x]))
            if r.T_star > 10:
                f.write("{:<24g}".format(F_ratio[x]))
            else:
                f.write("{:<24}".format("not_avail."))


def write_flux_ratio_only(r: RunResult):
    """write.py:341-353 (Pandexo-readable)."""
    r.makedirs()
    F_ratio = calc_F_ratio(r)
    with open(r.path("_flux_ratio.dat"), "w") as f:
        for x in range(r.nbin):
            f.write("{:<18.9g}".format(r.opac_wave[x] * 1e4))
            if r.T_star > 10:
                f.write("{:<12g}\n".format(F_ratio[x]))
            else:
                f.write("{:<12}\n".format("not_avail."))


def write_surface_albedo(r: RunResult):
    """write.py:355-373."""
    r.makedirs()
    with open(r.path("_surf_albedo.dat"), "w") as f:
        f.write("This file contains the surface albedo per wavelength.")
        if r.input_surf_albedo == "file":
            f.write("\nThe surface material used is: "
                    + r.albedo_file_surface_name)
        else:
            f.write("\nA value was chosen manually, hence all the values "
                    "below are constant.")
        f.write("\n{:<8}{:<18}{:<21}{:<19}{:<16}".format(
            "bin", "cent_lambda[um]", "low_int_lambda[um]",
            "delta_lambda[um]", "surface_albedo"))
        for x in range(r.nbin):
            f.write(_spectral_row_prefix(r, x)
                    + "{:<16g}".format(r.surf_albedo[x]))


def write_planck_interface(r: RunResult):
    """write.py:398-420 (noniso only)."""
    if r.iso != 0:
        return
    _write_spectral_interface_file(
        r, "_planck_int.dat",
        "This file contains the Planck (blackbody) function at each "
        "interface. \nPlanck function given in [erg s^-1 cm^-3 sr^-1].",
        "B_int[", r.planckband_int, fmt="{:<16g}")


def write_planck_center(r: RunResult):
    """write.py:422-446."""
    r.makedirs()
    with open(r.path("_planck_cent.dat"), "w") as f:
        f.write("This file contains the Planck (blackbody) function at each "
                "layer center and from the stellar (2nd last column) and "
                "internal (last column) temperatures. "
                "\nPlanck function given in [erg s^-1 cm^-3 sr^-1].")
        _spectral_header(f)
        for i in range(r.nlayer):
            f.write("{:<6}{:g}{:<4}".format("B_lay[", i, "]"))
        f.write("{:<16}{:<16}".format("Planck_T_star", "Planck_T_intern"))
        for x in range(r.nbin):
            f.write(_spectral_row_prefix(r, x))
            for i in range(r.nlayer + 2):
                f.write("{:<16g}".format(r.planckband_lay[i, x]))


def _write_spectral_layer_file(r: RunResult, suffix, description, col_label,
                               data, fmt="{:<16g}"):
    """Shared layout of the per-layer spectral diagnostic files
    (write.py:449-682)."""
    r.makedirs()
    with open(r.path(suffix), "w") as f:
        f.write(description)
        _spectral_header(f)
        for i in range(r.nlayer):
            f.write("{:<{w}}{:g}{:<4}".format(col_label, i, "]",
                                              w=len(col_label)))
        for x in range(r.nbin):
            f.write(_spectral_row_prefix(r, x))
            for i in range(r.nlayer):
                f.write(fmt.format(data[i, x]))


def write_opacities(r: RunResult):
    """write.py:448-467."""
    _write_spectral_layer_file(
        r, "_opacities.dat",
        "This file contains the bin integrated opacities at each layer "
        "center \nOpacity given in [cm^2 g^-1].",
        "opac_lay[", r.opac_band_lay, fmt="{:<15g}")


def write_Rayleigh_cross_sections(r: RunResult):
    """write.py:508-528."""
    _write_spectral_layer_file(
        r, "_Rayleigh_cross_sect.dat",
        "This file contains Rayleigh scattering cross sections per "
        "wavelength at each layer center. "
        "\nCross sections given in [cm^2].",
        "scat_cross_sect_lay[", r.scat_cross_lay, fmt="{:<24g}")


def write_g_0(r: RunResult):
    """write.py:552-573."""
    _write_spectral_layer_file(
        r, "_g_0.dat",
        "This file contains the scattering asymmetry parameter values per "
        "wavelength at each layer center.\nValues are between -1 and 1.",
        "g_0_lay[", r.g_0_tot_lay, fmt="{:<16g}")


def write_transmission(r: RunResult):
    """write.py:575-595."""
    _write_spectral_layer_file(
        r, "_transmission.dat",
        "This file contains the transmission function for each layer and "
        "waveband.",
        "transm_lay[", r.trans_band, fmt="{:<18g}")


def write_opt_depth(r: RunResult):
    """write.py:597-617."""
    _write_spectral_layer_file(
        r, "_optdepth.dat",
        "This file contains the optical depth for each layer and waveband.",
        "delta_tau_lay[", r.delta_tau_band, fmt="{:<20g}")


def write_cloud_opt_depth(r: RunResult):
    """write.py:619-637."""
    _write_spectral_layer_file(
        r, "_cloud_optdepth.dat",
        "This file contains the cloud optical depth for each layer and "
        "waveband.",
        "cloud_delta_tau[", r.delta_tau_all_clouds, fmt="{:<22g}")


def write_contribution_function(r: RunResult):
    """write.py:639-659."""
    _write_spectral_layer_file(
        r, "_contribution.dat",
        "This file contains the contribution function for each layer and "
        "waveband.",
        "contr_func_lay[", r.contr_func_band, fmt="{:<22g}")


def write_trans_weight_function(r: RunResult):
    """write.py:661-682."""
    _write_spectral_layer_file(
        r, "_transweight.dat",
        "This file contains the transmission weighting function for each "
        "layer and waveband. The units are [erg s^-1 cm^-3 sr^-1]",
        "transm_weight_lay[", r.trans_weight_band, fmt="{:<25g}")


def write_cloud_mixing_ratio(r: RunResult):
    """write.py:469-485."""
    r.makedirs()
    with open(r.path("_cloud_mixing_ratio.dat"), "w") as f:
        f.write("This file contains the cloud volume mixing ratio "
                "(= n_cloud/n_gas) at each vertical layer.")
        f.write("\n{:<8}{:<24}{:<18}".format("layer", "press.[10^-6bar]",
                                             "cloud_vmr"))
        for i in range(r.nlayer):
            f.write("\n{:<8g}".format(i)
                    + "{:<24g}".format(r.p_lay[i])
                    + "{:<18g}".format(r.f_all_clouds_lay[i]))


def write_cloud_opacities(r: RunResult):
    """write.py:487-506."""
    data = r.abs_cross_all_clouds_lay / r.meanmolmass_lay[:, None]
    _write_spectral_layer_file(
        r, "_cloud_opacities.dat",
        "This file contains the cloud opacities at each layer center "
        "\nOpacity given in [cm^2 g^-1].",
        "cloud_opac[", data, fmt="{:<17g}")


def write_cloud_scat_cross_sections(r: RunResult):
    """write.py:530-550."""
    _write_spectral_layer_file(
        r, "_cloud_scat_cross_sect.dat",
        "This file contains the cloud scattering cross sections per "
        "wavelength at each layer center. "
        "\nCross sections given in [cm^2].",
        "cloud_cross_sect_lay[", r.scat_cross_all_clouds_lay, fmt="{:<25g}")


def sum_mean_optdepth(r: RunResult, i: int, opac: np.ndarray) -> float:
    """Summed optical depth TOA->layer i from a mean opacity
    (host_functions.py:321-333)."""
    tau = 0.0
    for j in range(r.nlayer - 1, i - 1, -1):
        if opac[j] == -3:
            continue
        tau += r.delta_colmass[j] * opac[j]
    return tau if tau > 0 else -3


def write_mean_extinction(r: RunResult):
    """write.py:684-714."""
    r.makedirs()
    with open(r.path("_mean_extinct.dat"), "w") as f:
        f.write("This file contains the Rosseland and Planck mean opacities "
                "of layers & optical depths summed up to a certain layer, "
                "weighted either by the blackbody function with the stellar "
                "or the planetary atmospheric temperature."
                "\nMean opacity given in [cm^2 g^-1].")
        f.write("\n{:<10}{:<20}{:<20}{:<20}{:<20}{:<20}{:<20}{:<20}{:<20}"
                "{:<20}".format(
                    "layer", "press.[10^-6bar]",
                    "Planck_opac_T_lay", "Ross_opac_T_lay",
                    "Planck_opac_T_star", "Ross_opac_T_star",
                    "Planck_tau_T_lay", "Ross_tau_T_lay",
                    "Planck_tau_T_star", "Ross_tau_T_star"))
        for i in range(r.nlayer):
            f.write("\n{:<8g}".format(i)
                    + "{:<20g}".format(r.p_lay[i])
                    + _mean_werror(r.planck_opac_T_pl[i])
                    + _mean_werror(r.ross_opac_T_pl[i])
                    + _mean_werror(r.planck_opac_T_star[i])
                    + _mean_werror(r.ross_opac_T_star[i])
                    + _mean_werror(sum_mean_optdepth(r, i,
                                                     r.planck_opac_T_pl))
                    + _mean_werror(sum_mean_optdepth(r, i, r.ross_opac_T_pl))
                    + _mean_werror(sum_mean_optdepth(r, i,
                                                     r.planck_opac_T_star))
                    + _mean_werror(sum_mean_optdepth(r, i,
                                                     r.ross_opac_T_star)))


def write_tp_coupling_snapshot(path: str, nlayer: int, p_lay, p_int,
                               T_lay, *, speed_up: int = 0,
                               iter_nr: int = 0,
                               T_previous: Optional[np.ndarray] = None):
    """Core coupling TP writer (write.py:716-771 format): BOA row first,
    then layers; with the speed-up the profile is averaged 50/50 with the
    previous coupling iteration's."""
    T_lay = np.asarray(T_lay)
    T_current = np.concatenate([[T_lay[nlayer]], T_lay[:nlayer]])
    T_new = T_current
    if speed_up == 1 and iter_nr > 0 and T_previous is not None:
        T_new = 0.5 * T_current + 0.5 * np.asarray(T_previous)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("{:<24}{:<18}".format("press.[10^-6bar]", "temp.[K]"))
        f.write("\n{:<24g}{:<18g}".format(p_int[0], T_new[0]))
        for i in range(nlayer):
            f.write("\n{:<24g}".format(p_lay[i])
                    + "{:<18g}".format(T_new[i + 1]))


def write_tp_for_coupling(r: RunResult, T_previous: Optional[np.ndarray]
                          = None):
    """write.py:716-771.  T_previous (optional, [nlayer+1] BOA-first) is
    averaged 50/50 with the current profile (coupling speed-up)."""
    write_tp_coupling_snapshot(
        r.path(f"_tp_coupling_{r.coupling_iter_nr}.dat"), r.nlayer,
        r.p_lay, r.p_int, r.T_lay, speed_up=r.coupling_speed_up,
        iter_nr=r.coupling_iter_nr, T_previous=T_previous)


def calculate_conv_flux(r: RunResult) -> np.ndarray:
    """Convective net flux diagnostic (host_functions.py:638-651)."""
    F_net_conv = np.zeros(r.ninterface)
    for i in range(1, r.ninterface):
        if r.conv_layer is not None and r.conv_layer[i - 1] == 1:
            F_net_conv[i] = (r.F_intern + r.F_add_heat_sum[i - 1]
                             + r.F_smooth_sum[i - 1] - r.F_net[i])
    if r.conv_layer is not None and r.conv_layer[r.nlayer] == 1:
        F_net_conv[0] = r.F_intern - r.F_net[0]
    return F_net_conv


def write_all(r: RunResult):
    """The full output set of a standard run (helios.py:101-127)."""
    r.makedirs()
    write_criterion_warning_file(r)
    write_tp(r)
    write_tp_cut(r)
    write_colmass_mu_cp_entropy(r)
    write_integrated_flux(r)
    write_upward_spectral_flux(r)
    write_downward_spectral_flux(r)
    write_TOA_flux_eclipse_depth(r)
    write_flux_ratio_only(r)
    write_direct_spectral_beam_flux(r)
    write_planck_interface(r)
    write_planck_center(r)
    write_opacities(r)
    write_Rayleigh_cross_sections(r)
    write_g_0(r)
    write_transmission(r)
    write_opt_depth(r)
    write_contribution_function(r)
    write_trans_weight_function(r)
    write_mean_extinction(r)
    write_surface_albedo(r)
    if r.f_all_clouds_lay is not None:
        write_cloud_mixing_ratio(r)
        write_cloud_opacities(r)
        write_cloud_scat_cross_sections(r)
        write_cloud_opt_depth(r)
    if r.phase_number_lay is not None:
        write_phase_state(r)
