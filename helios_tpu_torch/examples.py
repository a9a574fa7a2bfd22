"""First-run example inputs: `python -m helios_tpu_torch.examples [dir]`
(port of :mod:`helios_tpu.examples`).

The reference ships its first-run inputs via `install_input_files.bash`
(a ~1 GB download of premixed opacity tables and stellar spectra).  Here
the quickstart is self-contained: this module writes a synthetic-but-
physical premixed opacity table (HDF5, in the reference file format, 385
bins x 20 Gauss points), an example `param.dat` (105 layers) and a planet
ensemble file into a directory, ready for

    python -m helios_tpu_torch.examples ./example
    python -m helios_tpu_torch -parameter_file ./example/param.dat

Real-science runs swap the synthetic table for a ktable-built one
(docs/tutorial.md section 5).
"""

from __future__ import annotations

import os

PARAM_TEMPLATE = """### ### ######################### ### ###
### ### PARAMETERS FOR HELIOS-TPU ### ###
### ### ######################### ### ###

This file uses the reference param.dat format; every key can be
overridden on the command line (python -m helios_tpu_torch --help).

=== === GENERAL === ===

name =                                                example
output directory =                                    {out_dir}
realtime plotting =                                   no
planet type =                                         gas

=== === GRID === ===

TOA pressure [10^-6 bar] =                            1e-1
BOA pressure [10^-6 bar] =                            1e9

=== === ITERATION === ===

run type =                                            iterative

=== === RADIATION === ===

scattering =                                          yes
direct irradiation beam =                             no
  no  --> f factor =                                  0.5
internal temperature [K] =                            300
surface albedo =                                      0.0

=== === OPACITY MIXING === ===

opacity mixing =                                      premixed
  premixed   --> path to opacity file =               {opacity_path}

=== === CONVECTIVE ADJUSTMENT === ===

convective adjustment =                               yes
kappa value =                                         0.285714

=== === STELLAR AND PLANETARY PARAMETERS === ===

stellar spectral model =                              blackbody
planet =                                              manual
  manual --> surface gravity [cm s^-2] =              2288
  manual --> orbital distance [AU] =                  0.0153
  manual --> radius planet [R_Jup] =                  1.0
  manual --> radius star [R_Sun] =                    0.216
  manual --> temperature star [K] =                   3250

=== === ADVANCED === ===

number of layers =                                    automatic
isothermal layers =                                   no
maximum number of iterations =                        100000
radiative equilibrium criterion =                     1e-8
"""

ENSEMBLE_TEMPLATE = """# Planet-ensemble override file: first line names HeliosConfig
# fields, one row per planet.  Ensemble members share the compile-time
# physics (grid sizes, stellar/internal temperatures, iteration knobs);
# per-planet variation flows through array-level inputs: surface
# albedo, stellar spectrum file, clouds, additional heating, opacity
# table, initial TP profile.  Run with
#   python -m helios_tpu -parameter_file param.dat \\
#          -planet_ensemble_file planets.dat
# (helios_tpu_torch does not run planet ensembles yet)
name        surf_albedo
dark        0.0
gray        0.25
bright      0.5
"""


def write_example_inputs(target_dir: str, nbin: int = 385,
                         ny: int = 20) -> dict:
    """Write param.dat + synthetic opacity table + ensemble file.

    Returns the paths written.
    """
    from helios_tpu_torch.io.opacity import (save_opacity_file,
                                             synthetic_premixed_table)

    os.makedirs(target_dir, exist_ok=True)
    opacity_path = os.path.join(target_dir, "opac_synthetic.h5")
    param_path = os.path.join(target_dir, "param.dat")
    ensemble_path = os.path.join(target_dir, "planets.dat")
    out_dir = os.path.join(target_dir, "output") + os.sep

    table = synthetic_premixed_table(nbin=nbin, ny=ny)
    save_opacity_file(opacity_path, table)
    with open(param_path, "w") as f:
        f.write(PARAM_TEMPLATE.format(opacity_path=opacity_path,
                                      out_dir=out_dir))
    with open(ensemble_path, "w") as f:
        f.write(ENSEMBLE_TEMPLATE)
    return {"param": param_path, "opacity": opacity_path,
            "ensemble": ensemble_path}


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else argv
    target = argv[0] if argv else "./example"
    paths = write_example_inputs(target)
    print(f"Example inputs written to {target}:")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    print("\nFirst run:")
    print(f"  python -m helios_tpu_torch -parameter_file {paths['param']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
