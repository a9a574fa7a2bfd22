"""Dataset-format documentation file for produced opacity tables
(reference ktable/source_ktable/information.py:35-143)."""

from __future__ import annotations

import os

_KDISTR_TEXT = """
K - T A B L E   I N F O R M A T I O N
====================================

Opacity k-table produced by the helios_tpu_torch ktable pipeline from HELIOS-K
standard output.

/// D A T A   S T R U C T U R E ///

Each H5 file stores the following datasets.

"pressures":                        pressure values used for calculation of the opacities

"temperatures":                     temperature values used for calculation of the opacities

"interface wavelengths":            wavelength at bin interfaces

"center wavelengths":               wavelength at bin centers

"wavelength width of bins":         width of the bins

"ypoints":                          abscissa points for the Gauss-Legendre quadrature rule
                                    applied to the interval [0,1]. At these points the
                                    k-distribution function is evaluated.

"meanmolmass":                      the mean molecular mass per temperature and pressure:
                                    meanmolmass[Press, Temp] = mu[p + n_p * t], where n_p is
                                    the length of the pressure list and Press = pressures[p],
                                    Temp = temperatures[t].

"kpoints":                          opacity values in the format:
                                    opacity[Y-point, Lambda, Press, Temp]
                                      = kpoints[y + n_y*l + n_y*n_l*p + n_y*n_l*n_p*t],
                                    where n_* is the length of the according list.

"weighted Rayleigh cross-sections": Rayleigh scattering cross sections weighted by volume
                                    mixing ratio:
                                    cross[Lambda, Press, Temp] = c[l + n_l*p + n_l*n_p*t].

"included molecules":               List of included opacity sources

"units":                            'CGS' or 'SI'. For 'CGS' the opacity unit is cm^2 g^-1,
                                    cross sections cm^2, wavelength cm, and pressure
                                    dyne cm^-2 = 1e-6 bar. For 'SI': m^2 kg^-1, m^2, m, Pa.
"""

_SAMPLING_TEXT = """
O P A C I T Y   I N F O R M A T I O N
====================================

Sampled opacity table produced by the helios_tpu_torch ktable pipeline from
HELIOS-K standard output.

/// D A T A   S T R U C T U R E ///

"pressures", "temperatures":        the (T, P) grid of the table

"wavelengths":                      wavelength grid

"meanmolmass":                      meanmolmass[Press, Temp] = mu[p + n_p * t]

"kpoints":                          opacity[Lambda, Press, Temp]
                                      = kpoints[l + n_l*p + n_l*n_p*t]

"weighted Rayleigh cross-sections": cross[Lambda, Press, Temp] = c[l + n_l*p + n_l*n_p*t]

"included molecules":               List of included opacity sources

"units":                            'CGS' or 'SI' (see k-distribution description).
"""


def write_info(final_dir: str, fmt: str = "k-distribution"):
    os.makedirs(final_dir, exist_ok=True)
    text = _KDISTR_TEXT if fmt == "k-distribution" else _SAMPLING_TEXT
    with open(os.path.join(final_dir, "opac_table_info.dat"), "w") as f:
        f.write(text)
