"""Self-contained REAL-data miniature: ktable -> star tool -> pipeline
(a copy of :mod:`helios_tpu.realdata`, which imports only numpy and h5py;
keep the two alike; :func:`run_miniature` runs the port's pipeline).

The reference's first-run inputs are a ~1 GB download
(install_input_files.bash); `examples.py` replaces that with a synthetic
table.  This module builds a miniature whose every physics input is REAL
published data, with no network access:

  * opacity: the H- continuum (John 1988 bound-free + free-free) and the
    He- continuum -- the dominant gas opacity of ultra-hot Jupiters --
    plus H2/He Rayleigh scattering.  The bound-free cross-section is
    sampled at high spectral resolution and pushed through the
    production k-distribution binning (`ktable.build`), then stage 2
    (`ktable.combine`) mixes it with the analytic free-free/He- terms
    into a reference-format ``mixed_opac_kdistr.h5`` -- the same chain a
    HELIOS-K line-list table takes (ktable parity:
    reference ktable/source_ktable/combination.py:676-788).
  * star: the measured Gueymard (2003) composite solar spectrum
    (reference star_tool/input/ascii/sun_gueymard_2003.txt), converted
    onto the opacity grid by the star tool exactly like the reference's
    ascii path (star_tool/run.py:25-31: nm -> cm, W m^-2 nm^-1 -> cgs,
    Earth distance -> stellar surface).

tests/test_torch_realdata.py drives the full chain and checks it
against EXTERNAL truths (the published 1366.1 W/m^2 solar constant, the
John 1988 closed form), against the JAX package's chain, and against the
committed drift pins of the resulting emission spectrum.  The tables are
HDF5 files, so building them needs h5py.
"""

from __future__ import annotations

import os

import numpy as np

from helios_tpu_torch import constants as pc
from helios_tpu_torch import species as sdb

# H- ion mass [g/mol]; the tabulated pseudo-species bypasses the DB
M_HMINUS = sdb.SPECIES["H-_bf"].weight

# solar composition for the miniature gas (H2-He by number)
VMR_H2, VMR_HE = 0.9, 0.1
# ultra-hot-Jupiter-like continuum abundances (per total gas)
VMR_HMINUS = "3e-9"          # n(H-)/n_tot
VMR_H_E = "4e-4&1e-6"        # n(H) * n(e-) for free-free
VMR_HE_E = "1e-1&1e-6"       # n(He) * n(e-) for He-


def build_hminus_individual(out_dir: str, *, resolution: float = 20.0,
                            lam_bot: float = 0.245e-4,
                            lam_top: float = 30e-4, ny: int = 8,
                            oversample: int = 40, use_native: bool = True):
    """Sample the real John (1988) H- bound-free cross-section at
    ``oversample`` points per output bin and bin it with the production
    k-distribution machinery; write the reference-format individual file
    ``H-_bf_tab_opac_kdistr.h5``.

    The cross-section per unit H- mass is temperature- and
    pressure-independent, so a 2x2 (T, P) grid carries it exactly.
    ``use_native=False``: the numpy k-distribution in place of the native
    library.  Returns the file path.
    """
    import h5py

    from helios_tpu_torch.io.opacity import gauss_legendre_ypoints
    from helios_tpu_torch.ktable import build as kb
    from helios_tpu_torch.ktable import continuous

    lam_int = kb.gen_fixed_res_grid(lam_bot, lam_top, resolution)
    lam_c = 0.5 * (lam_int[:-1] + lam_int[1:])
    dlam = np.diff(lam_int)
    nbin = len(lam_c)

    # high-resolution sampling grid (constant R, ``oversample`` x finer)
    lam_hi = kb.gen_fixed_res_grid(lam_bot, lam_top,
                                   resolution * oversample)
    sigma = continuous.h_min_bf_cross_sect(lam_hi)      # [cm^2 / ion]
    opac_hi = sigma / (M_HMINUS * pc.AMU)               # [cm^2 / g]

    y_gauss, _ = gauss_legendre_ypoints(ny)
    kdist = kb.kdistribution_for_one_TP(lam_hi, opac_hi, lam_int, dlam,
                                        y_gauss, use_native=use_native)

    temps = np.array([50.0, 6000.0])
    press = np.array([1.0, 1e10])
    kpoints = np.tile(kdist, len(temps) * len(press))

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "H-_bf_tab_opac_kdistr.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("pressures", data=press)
        f.create_dataset("temperatures", data=temps)
        f.create_dataset("interface wavelengths", data=lam_int)
        f.create_dataset("center wavelengths", data=lam_c)
        f.create_dataset("wavelength width of bins", data=dlam)
        f.create_dataset("ypoints", data=y_gauss)
        f.create_dataset("kpoints", data=kpoints)
    return path


def build_mixed_table(out_dir: str, *, use_native: bool = True,
                      **build_kwargs) -> str:
    """Stage 2: combine the tabulated H- bound-free with the analytic
    free-free / He- continua and H2/He Rayleigh scattering into a
    reference-format premixed table.  Returns the mixed file path."""
    from helios_tpu_torch.ktable.combine import Combiner, MixSpecies

    build_hminus_individual(out_dir, use_native=use_native, **build_kwargs)

    species = [
        MixSpecies("H-_bf_tab", True, False, VMR_HMINUS,
                   weight=M_HMINUS),
        MixSpecies("H-_ff", True, False, VMR_H_E),
        MixSpecies("He-", True, False, VMR_HE_E),
        MixSpecies("H2", False, True, str(VMR_H2)),
        MixSpecies("He", False, True, str(VMR_HE)),
    ]
    comb = Combiner(individual_dir=out_dir, final_dir=out_dir,
                    use_native=use_native)
    comb.combine_all(species)
    return os.path.join(out_dir, "mixed_opac_kdistr.h5")


def convert_sun(out_dir: str, sun_ascii_path: str, mixed_path: str) -> str:
    """Star-tool conversion of the measured Gueymard (2003) solar
    spectrum onto the miniature's opacity grid (the reference's own sun
    configuration, star_tool/run.py:25-31).  Returns the star HDF5 path
    (dataset ``/miniature/ascii/sun``)."""
    from helios_tpu_torch.startool.functions import convert_star

    sun = {
        "data_format": "ascii",
        "source_file": sun_ascii_path,
        "name": "sun",
        "w_conversion_factor": 1e-7,       # nm -> cm
        "flux_conversion_factor": 1e10,    # W m^-2 nm^-1 -> erg s^-1 cm^-3
        "temp": 5772.0,
    }
    star_path = os.path.join(out_dir, "star_sun.h5")
    convert_star(sun, "miniature", mixed_path, star_path,
                 mode="manual")
    return star_path


def build_miniature(out_dir: str, sun_ascii_path: str, **build_kwargs):
    """Build the full real-data miniature input set.

    Returns (mixed_opacity_path, star_path, star_dataset)."""
    mixed = build_mixed_table(out_dir, **build_kwargs)
    star = convert_sun(out_dir, sun_ascii_path, mixed)
    return mixed, star, "/miniature/ascii/sun"


# the miniature's atmosphere: a 25-layer isothermal-layer RCE run without
# convection, irradiated by the converted sun at 0.02 AU
MINIATURE_RUN = dict(
    name="mini", planet="manual", g=1000.0, a=0.02, R_planet=1.2,
    R_star=1.0, T_star=5772.0, T_intern=100.0, scattering="yes",
    direct_beam="no", convection="no", run_type="iterative",
    iso_input="yes", nlayer=25, p_boa=1e8, p_toa=1e2,
    rad_convergence_limit=1e-5)


def run_miniature(mixed: str, star: str, dataset: str, output_dir: str, *,
                  device="cuda", **overrides):
    """helios_tpu_torch.pipeline.run of MINIATURE_RUN from the files of
    :func:`build_miniature`, on ``device`` (CUDA unless the caller asks
    for the CPU), writing the output files under ``output_dir``.
    Returns (config, RunOutput)."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import HeliosConfig

    cfg = HeliosConfig(**dict(MINIATURE_RUN, **overrides),
                       output_dir=output_dir, opacity_path=mixed,
                       stellar_model="file", stellar_path=star,
                       stellar_dataset=dataset)
    return cfg, pipeline.run(cfg, device=device)
