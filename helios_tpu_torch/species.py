"""Atmospheric species database: FastChem designations and molar weights.

Parity with reference source/species_database.py:32-137 (~90 species incl.
ions H-_bf/H-_ff/He- and the 8 CIA pairs).  Weights in AMU (g/mol).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class SpeciesInfo:
    name: str
    fc_name: str   # FastChem designation
    weight: float  # molar weight [g/mol]


def _s(name, fc_name, weight):
    return SpeciesInfo(name, fc_name, weight)


SPECIES = {}

_NEUTRAL_MOLECULES = [
    ("CO2", "C1O2", 44.01), ("H2O", "H2O1", 18.0153), ("CO", "C1O1", 28.01),
    ("O2", "O2", 31.9988), ("CH4", "C1H4", 16.04), ("HCN", "C1H1N1", 27.0253),
    ("NH3", "H3N1", 17.031), ("H2S", "H2S1", 34.081), ("PH3", "H3P1", 33.99758),
    ("O3", "O3", 47.9982), ("O3_IR", "O3", 47.9982), ("O3_UV", "O3", 47.9982),
    ("NO", "N1O1", 30.01), ("SO2", "O2S1", 64.066), ("SH", "H1S1", 33.073),
    ("H2", "H2", 2.01588), ("N2", "N2", 28.0134), ("SO", "O1S1", 48.0644),
    ("OH", "H1O1", 17.007), ("COS", "C1O1S1", 60.0751), ("CS", "C1S1", 44.0757),
    ("HCHO", "H2C1O1", 30.02598), ("C2H4", "C2H4", 28.05316), ("C2H2", "C2H2", 26.04),
    ("CH3", "C1H3", 37.04004), ("C3H", "C3H1", 37.04004), ("C2H", "C2H1", 25.02934),
    ("C2N2", "C2N2", 52.0348), ("C3O2", "C3O2", 68.0309), ("C4N2", "C4N2", 76.0562),
    ("C3", "C3", 36.0321), ("S2", "S2", 64.13), ("S3", "S3", 96.195),
    ("S2O", "O1S2", 80.1294), ("CS2", "C1S2", 76.1407), ("NO2", "N1O2", 46.0055),
    ("N2O", "N2O1", 44.013), ("HNO3", "H1N1O3", 63.01), ("SO3", "O3S1", 80.066),
    ("H2SO4", "H2O4S1", 98.0785), ("TiO", "O1Ti1", 63.866),
    ("TiH", "TiH is not included in FastChem...sorry!", 48.87),
    ("VO", "O1V1", 66.9409), ("SiO", "O1Si1", 44.08), ("AlO", "Al1O1", 42.98),
    ("CaO", "Ca1O1", 56.0774), ("PO", "O1P1", 46.97316), ("SiH", "H1Si1", 29.09344),
    ("CaH", "Ca1H1", 41.085899), ("AlH", "Al1H1", 27.9889), ("MgH", "H1Mg1", 25.3129),
    ("CrH", "Cr1H1", 53.0040), ("NaH", "H1Na1", 23.99771),
]

_NEUTRAL_ATOMS = [
    ("H", "H", 1.007825), ("He", "He", 4.0026), ("C", "C", 12.0096),
    ("N", "N", 14.007), ("O", "O", 15.999), ("F", "F", 18.9984),
    ("Na", "Na", 22.989769), ("Ne", "Ne", 20.1797), ("Ni", "Ni", 58.6934),
    ("Mg", "Mg", 24.305), ("Mn", "Mn", 54.938044), ("Al", "Al", 26.9815385),
    ("Ar", "Ar", 39.948), ("Si", "Si", 28.085), ("P", "P", 30.973761998),
    ("S", "S", 32.06), ("Cl", "Cl", 35.45), ("K", "K", 39.0983),
    ("Ca", "Ca", 40.078), ("Ti", "Ti", 47.867), ("V", "V", 50.9415),
    ("Co", "Co", 58.933194), ("Cr", "Cr", 51.9961), ("Cu", "Cu", 63.546),
    ("Fe", "Fe", 55.845), ("Zn", "Zn", 65.38),
]

for _n, _f, _w in _NEUTRAL_MOLECULES + _NEUTRAL_ATOMS:
    SPECIES[_n] = _s(_n, _f, _w)

# ions
SPECIES["H-_bf"] = _s("H-_bf", "H1-", SPECIES["H"].weight)
SPECIES["H-_ff"] = _s("H-_ff", "H&e-", SPECIES["H"].weight)
SPECIES["He-"] = _s("He-", "He&e-", SPECIES["He"].weight)
SPECIES["H3+"] = _s("H3+", "H3+ is not included in FastChem...sorry!", 3.02382)
SPECIES["HeH+"] = _s("HeH+", "HeH+ is not included in FastChem...sorry!", 5.01054)
SPECIES["Fe+"] = _s("Fe+", "Fe1+", 55.845)
SPECIES["Ti+"] = _s("Ti+", "Ti1+", 47.867)
SPECIES["e-"] = _s("e-", "e-", 5.4858e-4)

# CIA pairs: tabulated in cm^2/g already divided by the weight of the 2nd
# collision partner in writing order (reference species_database.py:129-137)
SPECIES["CIA_H2H2"] = _s("CIA_H2H2", "H2&H2", SPECIES["H2"].weight)
SPECIES["CIA_H2He"] = _s("CIA_H2He", "H2&He", SPECIES["He"].weight)
SPECIES["CIA_CO2CO2"] = _s("CIA_CO2CO2", "C1O2&C1O2", SPECIES["CO2"].weight)
SPECIES["CIA_O2CO2"] = _s("CIA_O2CO2", "O2&C1O2", SPECIES["CO2"].weight)
SPECIES["CIA_O2O2"] = _s("CIA_O2O2", "O2&O2", SPECIES["O2"].weight)
SPECIES["CIA_O2N2"] = _s("CIA_O2N2", "O2&N2", SPECIES["N2"].weight)
SPECIES["CIA_N2N2"] = _s("CIA_N2N2", "N2&N2", SPECIES["N2"].weight)
SPECIES["CIA_N2H2"] = _s("CIA_N2H2", "N2&H2", SPECIES["H2"].weight)


def is_mean_molmass_contributor(name: str) -> bool:
    """Species that count toward the mean molecular mass.

    CIA pairs and the continuum pseudo-species H-_ff / He- are excluded
    (reference host_functions.py:944).
    """
    return ("CIA" not in name) and (name not in ("H-_ff", "He-"))
