"""Rayleigh scattering cross-sections for the opacity-table pipeline.

Refractive indices, King factors, and reference densities per species
(parity with reference ktable/source_ktable/rayleigh.py:29-191; constants
from Cox 2000, Sneep & Ubachs 2005, Thalman et al. 2014, Lee & Kim 2004,
Schiebener et al. 1990).  All functions are vectorized over wavelength
[cm].
"""

from __future__ import annotations

import numpy as np

from helios_tpu_torch import constants as pc

KING_H2 = 1.0
KING_HE = 1.0
KING_CO = 1.0
KING_H2O = (6 + 3 * 3e-4) / (6 - 7 * 3e-4)
N_REF_H2 = 2.65163e19
N_REF_HE = 2.546899e19
N_REF_CO2 = 2.546899e19
N_REF_N2 = 2.546899e19
N_REF_O2 = 2.68678e19
N_REF_CO = 2.546899e19

H2O_WEIGHT = 18.0153


def index_h2(lam):
    return 13.58e-5 * (1 + 7.52e-11 * lam ** -2) + 1


def index_he(lam):
    return 1e-8 * (2283 + 1.8102e13 / (1.5342e10 - lam ** -2)) + 1


def index_n2(lam):
    lam = np.asarray(lam, float)
    low = 1e-8 * (6498.2 + 307.4335e12 / (14.4e9 - lam ** -2)) + 1
    high = 1e-8 * (5677.465 + 318.81874e12 / (14.4e9 - lam ** -2)) + 1
    return np.where(lam ** -1 <= 21360, low, high)


def index_o2(lam):
    return 1e-8 * (20564.8 + 2.480899e13 / (4.09e9 - lam ** -2)) + 1


def index_co(lam):
    return 1e-8 * (22851 + 0.456e14 / (71427 ** 2 - lam ** -2)) + 1


def index_co2(lam):
    bracket = (5799.25 / (128908.9 ** 2 - lam ** -2)
               + 120.05 / (89223.8 ** 2 - lam ** -2)
               + 5.3334 / (75037.5 ** 2 - lam ** -2)
               + 4.3244 / (67837.7 ** 2 - lam ** -2)
               + 0.1218145e-6 / (2418.136 ** 2 - lam ** -2))
    return bracket * 1.1427e3 + 1


def index_h2o(lam, press, temp, f_h2o):
    """Density-dependent H2O refractive index (complex-safe;
    rayleigh.py:88-116)."""
    dens = f_h2o * press * H2O_WEIGHT * pc.AMU / (pc.K_B * temp)
    Lam = lam / 0.589e-4
    delta = dens / 1.0
    theta = temp / 273.15
    a = [0.244257733, 0.974634476e-2, -0.373234996e-2, 0.268678472e-3,
         0.158920570e-2, 0.245934259e-2, 0.900704920, -0.166626219e-1]
    A = delta * (a[0] + a[1] * delta + a[2] * theta + a[3] * Lam ** 2 * theta
                 + a[4] * Lam ** -2 + a[5] / (Lam ** 2 - 0.229202 ** 2)
                 + a[6] / (Lam ** 2 - 5.432937 ** 2) + a[7] * delta ** 2)
    return np.sqrt((2 * A.astype(complex) + 1) / (1 - A))


def n_ref_h2o(press, temp, f_h2o):
    return f_h2o * press / (pc.K_B * temp)


def king_co2(lam):
    return 1.1364 + 25.3e-12 * lam ** -2


def king_n2(lam):
    return 1.034 + 3.17e-12 * lam ** -1


def king_o2(lam):
    return 1.09 + 1.385e-11 * lam ** -2 + 1.448e-20 * lam ** -4


def cross_sect(lamda, index, n_ref, king, lamda_limit):
    """sigma(lambda) for a given refractive index (rayleigh.py:163-173)."""
    lamda = np.asarray(lamda, float)
    index = np.asarray(index)
    val = (24.0 * np.pi ** 3 / (n_ref ** 2 * lamda ** 4)
           * np.real((index ** 2 - 1.0) / (index ** 2 + 2.0)) ** 2 * king)
    return np.where(lamda <= lamda_limit, val, 0.0)


def cross_sect_h(lamda):
    """Atomic hydrogen via the Lee & Kim (2004) series (rayleigh.py:175-191).
    """
    cp = [1.26563, 3.73828125, 8.813930935, 19.15379502, 39.92303232,
          81.10881152, 161.9089166, 319.0231631, 622.2679809, 1203.891509]
    sigma_T = 0.665e-24
    lamda_l = 91.2e-7
    lamda = np.asarray(lamda, float)
    r = (lamda_l / lamda)
    s = sum(cp[i] * r ** (2 * i) for i in range(10))
    return sigma_T * r ** 4 * s


def species_cross_section(name: str, lam, *, press=None, temp=None,
                          f_h2o=None):
    """Rayleigh cross-section of a named species on wavelength grid ``lam``
    (combination.py:514-649 dispatch).  H2O needs press/temp/f_h2o."""
    lam = np.asarray(lam, float)
    limit = lam[-1]
    if name == "H2":
        return cross_sect(lam, index_h2(lam), N_REF_H2, KING_H2, limit)
    if name == "He":
        return cross_sect(lam, index_he(lam), N_REF_HE, KING_HE, limit)
    if name == "CO2":
        return cross_sect(lam, index_co2(lam), N_REF_CO2, king_co2(lam),
                          limit)
    if name == "N2":
        return cross_sect(lam, index_n2(lam), N_REF_N2, king_n2(lam), limit)
    if name == "O2":
        return cross_sect(lam, index_o2(lam), N_REF_O2, king_o2(lam), limit)
    if name == "CO":
        return cross_sect(lam, index_co(lam), N_REF_CO, KING_CO, limit)
    if name == "H":
        return cross_sect_h(lam)
    if name == "e-":
        return np.full(lam.shape, pc.SIGMA_T)
    if name == "H2O":
        idx = index_h2o(lam, press, temp, f_h2o)
        nref = n_ref_h2o(press, temp, f_h2o)
        return cross_sect(lam, idx, nref, KING_H2O, 2.5e-4)
    raise KeyError(f"No Rayleigh data for species {name!r}")


IMPLEMENTED = ["H", "H2", "He", "H2O", "CO2", "CO", "O2", "N2", "e-"]
