"""Inputs of the configuration ``onthefly`` (``benchmark/inputs``'
contract): HELIOS's on-the-fly opacity mixing of the configuration's
species file.

- The volume mixing ratios: the species file's constants, and for the
  rows marked FastChem the analytic C-H-O equilibrium
  (``benchmark/frozen/chemistry.py``) tabulated on the opacity table's own
  (T, p) grid, T clamped to the chemistry's range, handed to the program
  as a FastChem table (``fastchem_data=``) so that its interpolation onto
  that grid is exact at the nodes.
- Each absorber's k-table: the synthetic table's generator
  (``benchmark/frozen/table.py``) under the seed of its place among the
  absorbers (1, 2, ...), scaled so that at its largest VMR along the start
  profile it gives its share of the premixed table's geometric mean
  (``opacity_shares`` times ``opacity_share_total``).
- Rayleigh cross-sections of H2 and He: the lambda^-4 terms below; H2O's
  the program computes from its refractive index.

The species set is built through the program's own
``chem.build_species_set`` (species weights from its database) in the
run's precision; the reference gets the same arrays in float64 and the
weights frozen here."""

from __future__ import annotations

import numpy as np

from benchmark.frozen import chemistry
from benchmark.frozen.table import make_table

# [g/mol], HELIOS's species database (species_database.py); a CIA pair's
# is that of its second partner
WEIGHT = {"H2O": 18.0153, "CO": 28.01, "CO2": 44.01, "CH4": 16.04,
          "C2H2": 26.04, "NH3": 17.031, "HCN": 27.0253, "Na": 22.989769,
          "K": 39.0983, "TiO": 63.866, "VO": 66.9409, "CIA_H2H2": 2.01588,
          "CIA_H2He": 4.0026, "H2": 2.01588, "He": 4.0026}
# the FastChem columns of a species (a CIA pair's two partners)
COLUMNS = {"H2O": ("H2O1",), "CO": ("C1O1",), "CO2": ("C1O2",),
           "CH4": ("C1H4",), "C2H2": ("C2H2",), "H2": ("H2",),
           "He": ("He",), "CIA_H2H2": ("H2", "H2"), "CIA_H2He": ("H2", "He")}
# Rayleigh cross-section times lambda^4 [cm^6]: H2 the lambda^-4 term of
# Dalgarno & Williams (1962), He that of Chan & Dalgarno (1965)
RAYLEIGH = {"H2": 8.14e-45, "He": 5.484e-46}


def species_rows(cfg):
    """(name, absorbing, scattering, VMR source) of the species file."""
    return [(n, a == "yes", s == "yes", src) for n, a, s, src in
            cfg["species"]]


def fastchem_table(cfg, ktemps, kpress):
    """The chemistry as a FastChem table on the opacity grid: (columns
    [nT * nP], P fastest; temperatures; pressures [dyn/cm^2])."""
    c = cfg["chemistry"]
    data, _, _ = chemistry.as_fastchem_table(
        np.clip(ktemps, c["T_min"], c["T_max"]), np.asarray(kpress) / 1e6,
        n_o=c["n_O"], n_c=c["n_C"], n_he=c["n_He"])
    return data, np.asarray(ktemps), np.asarray(kpress)


def vmr_of(name, source, columns):
    """A species' VMR: its constant (a CIA pair's "x&y" the product), or
    the product of its FastChem columns (``columns``: name -> values, any
    shape)."""
    if source != "FastChem":
        return float(np.prod([float(x) for x in source.split("&")]))
    out = 1.0
    for col in COLUMNS[name]:
        out = out * np.asarray(columns[col], float)
    return out


def start_profile_vmr(cfg, rows):
    """Each species' largest VMR and the median mean molecular weight over
    the start profile's layers, the chemistry taken at their clamped T and
    p."""
    from benchmark.core.cell import reference
    from benchmark.core.drive import start_profile
    ref = reference(cfg)
    p_lay, _ = ref.pressure_grid(ref.deployment(cfg["helios"], {}))
    T = start_profile(p_lay, cfg["start_profile"])
    c = cfg["chemistry"]
    fractions = chemistry.mole_fractions(
        chemistry.solve_cho(c["n_O"], c["n_C"],
                            np.clip(T, c["T_min"], c["T_max"]), p_lay / 1e6),
        n_he=c["n_He"])
    columns = {chemistry._FC_NAMES[k]: v for k, v in fractions.items()}
    vmr = {n: np.broadcast_to(vmr_of(n, src, columns), T.shape)
           for n, _, _, src in rows}
    counted = [n for n, _, _, _ in rows if "CIA" not in n]
    mu = (sum(vmr[n] * WEIGHT[n] for n in counted)
          / sum(vmr[n] for n in counted))
    return {n: float(np.max(v)) for n, v in vmr.items()}, float(
        np.median(mu))


def absorber_tables(cfg, table_fields, rows):
    """name -> k-table [ntemp, npress, B, ny] (cm^2 per gram of the
    species), float64."""
    largest, mu = start_profile_vmr(cfg, rows)
    log_mean = np.log(table_fields["kpoints"]).mean()
    total = float(cfg["opacity_share_total"])
    out = {}
    absorbers = [r for r in rows if r[1]]
    for seed, (name, _, _, _) in enumerate(absorbers, start=1):
        k = make_table(dict(cfg["table"], seed=seed))["kpoints"]
        share = total * cfg["opacity_shares"][name]
        k *= share * np.exp(log_mean - np.log(k).mean()) / (
            largest[name] * WEIGHT[name] / mu)
        out[name] = k
    return out


def make(cfg, table_fields, tmpdir, device):
    from helios_tpu_torch import chem

    from benchmark.core.cell import reference

    dtype = np.float64 if cfg["helios"]["precision"] == "double" else (
        np.float32)
    rows = species_rows(cfg)
    ktemps, kpress = table_fields["temperatures"], table_fields["pressures"]
    fastchem = fastchem_table(cfg, ktemps, kpress)
    columns = {k: v.reshape(len(ktemps), len(kpress))
               for k, v in fastchem[0].items()}
    kpoints = absorber_tables(cfg, table_fields, rows)
    waves = np.asarray(table_fields["wave_centers"], np.float64)
    rayleigh = {n: RAYLEIGH[n] / waves ** 4 for n, _, s, _ in rows
                if s and n != "H2O"}
    nlayer = reference(cfg).deployment(cfg["helios"], {})["nlayer"]
    sset = chem.build_species_set(
        [chem.SpeciesSpec(n, a, s, src) for n, a, s, src in rows],
        ktemps=ktemps, kpress=kpress, nbin=len(waves),
        ny=len(table_fields["gauss_y"]), nlayer=nlayer,
        opacity_tables=kpoints, scat_tables=rayleigh,
        fastchem_data=fastchem, dtype=dtype, device=device)
    return dict(
        program=dict(sset=sset),
        reference=dict(
            species=[(n, a, s) for n, a, s, _ in rows],
            species_weight={n: WEIGHT[n] for n, _, _, _ in rows},
            species_vmr={n: vmr_of(n, src, columns)
                         for n, _, _, src in rows},
            species_kpoints=kpoints, species_rayleigh=rayleigh))
