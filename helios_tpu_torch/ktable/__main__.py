"""ktable CLI: ``python -m helios_tpu_torch.ktable`` (reference
ktable/ktable.py).

Two stages: "building" per-species tables from HELIOS-K output (the
individual-species file lists name + directory per row), then "mixing"
them into the premixed table (the final-species file lists name,
absorbing, scattering, and mixing ratio per row).

Configuration comes from a reference-format ``param_ktable.dat``
(-parameter_file) overridden by the reference's command-line flag names
(source_ktable/param.py:46-199) -- a reference user's parameter files
and invocations work unchanged.
"""

from __future__ import annotations

import sys

from helios_tpu_torch.ktable.params import read_param_file_and_command_line


def main(argv=None):
    p = read_param_file_and_command_line(argv)

    from helios_tpu_torch.ktable import build as kb
    from helios_tpu_torch.ktable import combine as kc
    from helios_tpu_torch.ktable import information

    if p.building == "yes":
        cfg = kb.BuildConfig(
            format=p.format, heliosk_format=p.heliosk_format,
            grid_format=p.grid_format,
            grid_limits=(p.grid_limits[0], p.grid_limits[1]),
            resolution=p.resolution, grid_file_path=p.grid_file_path,
            n_gauss=p.n_gauss, output_dir=p.individual_calc_path)
        with open(p.individual_species_file_path) as f:
            next(f)
            for line in f:
                col = line.split()
                if col:
                    print(f"building {col[0]} from {col[1]}")
                    kb.build_species(cfg, col[0], col[1])

    if p.mixing == "yes":
        species = kc.parse_final_species_file(p.final_species_file_path)
        comb = kc.Combiner(individual_dir=p.individual_calc_path,
                           final_dir=p.final_path, format=p.format,
                           fastchem_dir=p.fastchem_path)
        comb.combine_all(species, units=p.units)
        information.write_info(p.final_path, p.format)
        print("--- Production of mixed opacity table successful! ---")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
