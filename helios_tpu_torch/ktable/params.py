"""param_ktable.dat parser + command-line overrides for the ktable CLI.

Rebuild of the reference's token-matching parameter parser
(ktable/source_ktable/param.py:46-199): the same keyword lines of a
reference user's ``param_ktable.dat`` parse identically, and the same
command-line flag names override the file values.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class KtableParams:
    """The full ktable parameter surface (param.py:21-44 defaults)."""
    building: str = "yes"
    format: str = "k-distribution"          # k-distribution | sampling
    heliosk_format: str = "binary"          # binary | text
    individual_species_file_path: str = "./input/individual_species.dat"
    grid_format: str = "fixed_resolution"   # fixed_resolution | file |
    #                                         native_helios-k
    resolution: float = 50.0
    grid_limits: List[float] = field(
        default_factory=lambda: [0.244, 500.0])
    grid_file_path: str = "./input/grid.dat"
    n_gauss: int = 20
    individual_calc_path: str = "./output_ktable/"
    mixing: str = "yes"
    final_species_file_path: str = "./input/final_species.dat"
    fastchem_path: str = "../input/chemistry/"
    final_path: str = "./output_ktable/final/"
    units: str = "CGS"                      # CGS | MKS


def parse_param_ktable_file(path: str,
                            p: KtableParams = None) -> KtableParams:
    """Parse a reference-format param_ktable.dat (param.py:91-144).

    Lines are matched by their leading keywords, exactly like the
    reference, so comment/format columns after the value are ignored.
    """
    p = p or KtableParams()
    with open(path, encoding="utf-8") as f:
        for line in f:
            c = line.split()
            if not c:
                continue
            try:
                if c[0] == "individual" and c[2] == "calculation":
                    p.building = c[4]
                elif c[0] == "format":
                    p.format = c[2]
                elif c[0] == "HELIOS-K" and c[2] == "format":
                    p.heliosk_format = c[4]
                elif c[0] == "path" and c[2] == "individual":
                    p.individual_species_file_path = c[6]
                elif c[0] == "grid" and c[1] == "format":
                    p.grid_format = c[3]
                elif len(c) > 3 and c[2] == "wavelength" and c[3] == "grid":
                    p.resolution = float(c[5])
                    p.grid_limits = [float(c[6]), float(c[7])]
                elif (len(c) > 5 and c[2] == "path" and c[4] == "grid"
                        and c[5] == "file"):
                    p.grid_file_path = c[7]
                elif len(c) > 4 and c[2] == "number" and c[4] == "Gaussian":
                    p.n_gauss = int(c[7])
                elif c[0] == "directory" and c[2] == "individual":
                    p.individual_calc_path = c[5]
                elif c[0] == "mixed" and c[2] == "production":
                    p.mixing = c[4]
                elif (c[0] == "path" and c[2] == "final"
                        and c[3] == "species"):
                    p.final_species_file_path = c[6]
                elif c[0] == "path" and c[2] == "FastChem":
                    p.fastchem_path = c[5]
                elif c[0] == "mixed" and c[2] == "output":
                    p.final_path = c[5]
                elif len(c) > 4 and c[0] == "units" and c[4] == "table":
                    p.units = c[6]
            except IndexError:
                continue
    return p


# (flag, attribute, converter) -- reference param.py:53-82 flag names
_CL_FLAGS: Tuple[Tuple[str, str, type], ...] = (
    ("-individual_species_calculation", "building", str),
    ("-format", "format", str),
    ("-helios_k_output_format", "heliosk_format", str),
    ("-path_to_individual_species_file", "individual_species_file_path",
     str),
    ("-grid_format", "grid_format", str),
    ("-path_to_grid_file", "grid_file_path", str),
    ("-number_of_gaussian_points", "n_gauss", int),
    ("-directory_with_individual_files", "individual_calc_path", str),
    ("-mixed_table_production", "mixing", str),
    ("-path_to_final_species_file", "final_species_file_path", str),
    ("-path_to_fastchem_output", "fastchem_path", str),
    ("-mixed_table_output_directory", "final_path", str),
    ("-units_of_mixed_opacity_table", "units", str),
)


def read_param_file_and_command_line(argv=None) -> KtableParams:
    """param file (if any) + CL overrides (param.py:46-199)."""
    ap = argparse.ArgumentParser(prog="python -m helios_tpu_torch.ktable")
    ap.add_argument("-parameter_file", required=False, default=None)
    ap.add_argument("-wavelength_grid", required=False, default=None,
                    help='"resolution lower upper" in micron')
    for flag, _attr, _conv in _CL_FLAGS:
        ap.add_argument(flag, required=False, default=None)
    args = ap.parse_args(argv)

    p = KtableParams()
    if args.parameter_file:
        p = parse_param_ktable_file(args.parameter_file, p)

    for flag, attr, conv in _CL_FLAGS:
        v = getattr(args, flag.lstrip("-"))
        if v is not None:
            setattr(p, attr, conv(v))
    if args.wavelength_grid is not None:
        vals = [float(x) for x in args.wavelength_grid.split()]
        p.resolution, p.grid_limits = vals[0], [vals[1], vals[2]]

    if p.units not in ("CGS", "MKS"):
        raise ValueError(
            "Chosen units for the opacity table unknown. Please "
            "double-check entry in the parameter file.")
    return p
