"""Vertical pressure grid construction and initial temperature profile.

Math parity with reference source/host_functions.py:714-735 (grid) and
:164-184 (initial temperature).  All pressures are in cgs (dyn/cm^2, i.e.
"10^-6 bar" units: 1 bar = 1e6 cgs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Grid:
    """Static vertical grid: layer centers and interfaces (cgs pressures)."""
    p_lay: np.ndarray          # [nlayer]
    p_int: np.ndarray          # [nlayer+1]
    delta_colmass: np.ndarray  # [nlayer]  (p_int[i]-p_int[i+1])/g
    delta_col_upper: np.ndarray
    delta_col_lower: np.ndarray

    @property
    def nlayer(self) -> int:
        return len(self.p_lay)

    @property
    def ninterface(self) -> int:
        return len(self.p_int)


def build_grid(p_boa: float, p_toa: float, nlayer: int, g: float,
               dtype=np.float64) -> Grid:
    """Log-spaced interleaved layer/interface pressure grid.

    Follows reference host_functions.py:714-724: 2*nlayer log-spaced levels
    between BOA and TOA; odd indices are layer centers, even indices are
    interfaces, plus one extrapolated top interface.
    """
    i = np.arange(2 * nlayer, dtype=np.float64)
    press_levels = p_boa * (p_toa / p_boa) ** (i / (2 * nlayer - 1))
    p_lay = press_levels[1::2]
    p_int = np.concatenate([
        press_levels[0::2],
        [p_toa * (p_toa / p_boa) ** (1.0 / (2 * nlayer - 1))],
    ])
    delta_colmass = (p_int[:-1] - p_int[1:]) / g
    delta_col_upper = (p_lay - p_int[1:]) / g
    delta_col_lower = (p_int[:-1] - p_lay) / g
    return Grid(
        p_lay=p_lay.astype(dtype),
        p_int=p_int.astype(dtype),
        delta_colmass=delta_colmass.astype(dtype),
        delta_col_upper=delta_col_upper.astype(dtype),
        delta_col_lower=delta_col_lower.astype(dtype),
    )


def initial_temperature(nlayer: int, *, f_factor: float, dir_beam: int,
                        mu_star: float, R_star: float, a: float,
                        T_star: float, dtype=np.float64) -> np.ndarray:
    """Isothermal initial TP profile at max(T_eff, 500) K.

    Reference host_functions.py:164-176.  Returns [nlayer+1] including the
    surface/BOA ghost layer at index nlayer.
    """
    T_eff = ((1.0 - dir_beam) * f_factor ** 0.25 * (R_star / a) ** 0.5 * T_star
             + dir_beam * abs(mu_star) ** 0.25 * (R_star / a) ** 0.5 * T_star)
    return np.ones(nlayer + 1, dtype=dtype) * max(T_eff, 500.0)
