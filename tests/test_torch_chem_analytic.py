"""The analytic C-H-O chemistry of the PyTorch port
(helios_tpu_torch.chem_analytic) against the JAX package's
(helios_tpu.chem_analytic), on the committed Malik et al. (2017) Fig. 4
data (tests/data/malik2017_fig4/): the scenarios of
tests/test_malik2017_fig4.py:69-180.  The two modules are the same numpy
code, so every abundance is compared bit for bit, and the port's also
against the published script's output and TEA.  The analytic table feeds
the port's own chem.build_species_set, as it feeds the JAX package's.
"""

import numpy as np
import pytest

from helios_tpu import chem as jchem
from helios_tpu import chem_analytic as jca
from helios_tpu_torch import chem
from helios_tpu_torch import chem_analytic as ca

import torch_port_helpers  # noqa: F401  (one torch thread)
from test_malik2017_fig4 import (DATA, FIG4_TOL_DEX, TEA_COL,
                                 load_atm_inputs, load_tea)

SPECIES = ("CH4", "H2O", "CO", "CO2", "C2H2")


@pytest.fixture(scope="module")
def atm():
    return load_atm_inputs()


def same_abundances(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("T", [800.0, 3000.0])
@pytest.mark.parametrize("pbar", [1.0, 1e-3, 30.0])
def test_solve_cho_is_jax_bitwise(atm, T, pbar):
    _, _, n_o, n_c = atm
    got = ca.solve_cho(n_o / 2.0, n_c / 2.0, T, pbar)
    same_abundances(got, jca.solve_cho(n_o / 2.0, n_c / 2.0, T, pbar))
    same_abundances(ca.mole_fractions(got, n_he=0.19),
                    jca.mole_fractions(got, n_he=0.19))


def test_rate_constants_are_jax_bitwise():
    temps = np.linspace(300.0, 3500.0, 33)
    for p in (1e-4, 1.0, 100.0):
        np.testing.assert_array_equal(ca.k1(temps, p), jca.k1(temps, p))
        np.testing.assert_array_equal(ca.k3(temps, p), jca.k3(temps, p))
    np.testing.assert_array_equal(ca.k2(temps), jca.k2(temps))


def test_analytical_chemistry_matches_published_script_output(atm):
    _, _, n_o, n_c = atm
    d = np.load(f"{DATA}/CtoO_analytical.npz", allow_pickle=True,
                encoding="latin1")
    n_mix = d["n_mix"][0]
    for T in (800, 3000):
        nd = ca.solve_cho(n_o / 2.0, n_c / 2.0, float(T), float(d["pbar"]))
        for sp in SPECIES:
            np.testing.assert_allclose(nd[sp], n_mix[T][sp], rtol=1e-8,
                                       err_msg=f"{sp} at {T} K")


@pytest.mark.parametrize("T,tea_file", [(800, "CtoO_T800.tea"),
                                        (3000, "CtoO_T3000.tea")])
def test_analytical_chemistry_tracks_tea(atm, T, tea_file):
    _, _, n_o2, n_c2 = atm
    tea = load_tea(tea_file)
    nd = ca.solve_cho(n_o2 / 2.0, n_c2 / 2.0, float(T), 1.0)
    for sp, col in TEA_COL.items():
        dex = np.abs(np.log10(nd[sp]) - np.log10(tea[col] / tea["H2_ref"]))
        assert dex.max() <= FIG4_TOL_DEX[T][sp], (sp, T, dex.max())


def test_water_methane_crossover_at_unity_ctoo(atm):
    _, _, n_o2, n_c2 = atm
    ctoo = n_c2 / n_o2
    tea = load_tea("CtoO_T3000.tea")
    nd = ca.solve_cho(n_o2 / 2.0, n_c2 / 2.0, 3000.0, 1.0)

    def crossover(h2o, ch4):
        s = np.sign(np.log10(h2o) - np.log10(ch4))
        i = np.where(np.diff(s) != 0)[0][0]
        return 0.5 * (ctoo[i] + ctoo[i + 1])

    mine = crossover(nd["H2O"], nd["CH4"])
    assert abs(mine - crossover(tea["H2O_g"], tea["CH4_g"])) < 0.15
    assert 0.9 < mine < 1.2


def test_mole_fraction_normalization_matches_tea_h2(atm):
    tea = load_tea("CtoO_T800.tea")
    _, _, n_o2, n_c2 = atm
    frac = ca.mole_fractions(ca.solve_cho(n_o2 / 2.0, n_c2 / 2.0, 800.0,
                                          1.0), n_he=0.0)
    np.testing.assert_allclose(frac["H2"], tea["H2_ref"], rtol=2e-3)


def test_as_fastchem_table_feeds_the_port_species_set():
    """The analytic table, equal to the JAX package's, through the port's
    chem.build_species_set (CPU): the pretabulated VMRs equal the JAX
    package's species set's."""
    temps = np.linspace(600.0, 2900.0, 12)
    pbars = np.logspace(-4, 2, 7)
    fc = ca.as_fastchem_table(temps, pbars)
    jfc = jca.as_fastchem_table(temps, pbars)
    same_abundances(fc[0], jfc[0])
    np.testing.assert_array_equal(fc[1], jfc[1])
    np.testing.assert_array_equal(fc[2], jfc[2])
    assert set(fc[0]) >= {"C1H4", "H2O1", "C1O1", "C1O2", "C2H2", "H2",
                          "He"}
    assert all(v.shape == (12 * 7,) for v in fc[0].values())

    ktemps = np.linspace(700.0, 2800.0, 5)
    kpress = np.logspace(0, 7, 6)      # cgs
    tables = {"H2O": np.ones((5, 6, 3, 2)), "CO": np.ones((5, 6, 3, 2))}
    kw = dict(ktemps=ktemps, kpress=kpress, nbin=3, ny=2, nlayer=4,
              opacity_tables=tables)
    names = ("H2O", "CO")
    sset = chem.build_species_set(
        [chem.SpeciesSpec(n, True, False, "FastChem") for n in names],
        fastchem_data=fc, device="cpu", **kw)
    jsset = jchem.build_species_set(
        [jchem.SpeciesSpec(n, True, False, "FastChem") for n in names],
        fastchem_data=jfc, **kw)
    for d, jd in zip(sset.data, jsset.data):
        np.testing.assert_array_equal(d.vmr_pretab.numpy(),
                                      np.asarray(jd.vmr_pretab))
    vmr = sset.data[0].vmr_pretab.numpy()
    assert vmr.shape == (5, 6)
    assert np.all(vmr > 0) and np.all(vmr < 1e-2)
    assert 1e-4 < vmr[0, 0] < 1e-3
