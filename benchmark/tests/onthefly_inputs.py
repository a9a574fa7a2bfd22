"""A test-only inputs module (``benchmark/inputs``' contract): on-the-fly
Random Overlap mixing of two absorbers, H2O and CO2, whose tables are the
synthetic table's generator under two seeds of their own, over a
background of H2 (Rayleigh scattering) and He, all at constant volume
mixing ratios.  The species set is built through the program's own
``chem.build_species_set`` from plain arrays; the reference gets the same
arrays.  The configuration that names it sets ``opacity_mixing`` to
``on-the-fly`` in its own ``helios``."""

import numpy as np

from benchmark.frozen.table import make_table

# name, absorbing, scattering, VMR, table seed; an absorber's table is
# scaled so that it alone would give a tenth of the premixed table's
# opacity in the geometric mean (the tables' lines lie elsewhere than the
# premixed table's, and at its full opacity the tiny planet's deep layers
# run far past the table's 6000 K)
SPECIES = (("H2O", True, False, 1e-3, 1), ("CO2", True, False, 1e-4, 2),
           ("H2", False, True, 0.85, None), ("He", False, False, 0.15, None))
WEIGHTS = dict(H2O=18.015, CO2=44.01, H2=2.016, He=4.0026)
MEANMOL = 2.3
SCALE = 0.1


def make(cfg, table_fields, tmpdir, device):
    from helios_tpu_torch import chem
    from benchmark.core.cell import reference

    dtype = np.float64 if cfg["helios"]["precision"] == "double" else (
        np.float32)
    nlayer = reference(cfg).deployment(cfg["helios"], {})["nlayer"]
    log_mean = np.log(table_fields["kpoints"]).mean()
    kpoints = {}
    for name, absorbing, _, vmr, seed in SPECIES:
        if absorbing:
            k = make_table(dict(cfg["table"], seed=seed))["kpoints"]
            kpoints[name] = k * (SCALE * np.exp(log_mean - np.log(k).mean())
                                 / (vmr * WEIGHTS[name] / MEANMOL))
    rayleigh = {"H2": 8.49e-45 / table_fields["wave_centers"] ** 4}
    specs = [chem.SpeciesSpec(name, absorbing, scattering, repr(vmr))
             for name, absorbing, scattering, vmr, _ in SPECIES]
    sset = chem.build_species_set(
        specs, ktemps=table_fields["temperatures"],
        kpress=table_fields["pressures"],
        nbin=len(table_fields["wave_centers"]),
        ny=len(table_fields["gauss_y"]), nlayer=nlayer,
        opacity_tables=kpoints, scat_tables=rayleigh, dtype=dtype,
        device=device)
    return dict(
        program=dict(sset=sset),
        reference=dict(species=[s[0] for s in SPECIES],
                       species_kpoints=kpoints, species_rayleigh=rayleigh,
                       species_vmr={s[0]: s[3] for s in SPECIES}))
