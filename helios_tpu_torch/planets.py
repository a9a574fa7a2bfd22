"""Planetary parameter database.

Parity with reference source/planet_database.py:41-61.  Units: radius in
R_Jup (after conversion), g in cm s^-2 (or log10 thereof), a in AU,
R_star in R_Sun, T_star in K.
"""

from dataclasses import dataclass

from helios_tpu_torch import constants as pc


@dataclass(frozen=True)
class Planet:
    R_p: float          # [R_Jup]
    g_p: float          # [cm s^-2] or log10
    a: float            # [AU]
    T_star: float       # [K]
    R_star: float       # [R_Sun]
    g_star: float = 0.0
    metal_star: float = 0.0


PLANETS = {
    # Harpsoe et al. (2013)
    "GJ_1214b": Planet(R_p=2.85 * pc.R_EARTH / pc.R_JUP, g_p=760, a=0.01411,
                       T_star=3026, R_star=0.216, g_star=4.944, metal_star=0.39),
    # Southworth (2010)
    "HD_209458b": Planet(R_p=1.380, g_p=930, a=0.04747,
                         T_star=6117, R_star=1.162, g_star=4.368, metal_star=0.02),
    # Addison et al. (2019); handy for the BASELINE HD 189733b configs
    "HD_189733b": Planet(R_p=1.119, g_p=2140, a=0.03106,
                         T_star=5052, R_star=0.752, g_star=4.49, metal_star=-0.02),
}


def lookup(name: str) -> Planet:
    try:
        return PLANETS[name]
    except KeyError:
        raise KeyError(
            f"No planet named {name!r} in the database. Add it to "
            "helios_tpu_torch/planets.py or use planet='manual'.") from None
