"""The ktable pipeline of the PyTorch port (helios_tpu_torch.ktable)
against the JAX package's (helios_tpu.ktable): the scenarios of
tests/test_ktable.py, the committed HELIOS-K fixture among them, and the
param_ktable.dat parser of tests/test_tools_readers.py:116-160 on a file
written here.

The port's modules are copies of the JAX package's numpy code, so its
numpy path (``use_native=False``) is held bit for bit to the JAX
package's, and the HDF5 files of stage 1 and stage 2 dataset by dataset.
The JAX package falls back to numpy when its native library raises; the
port never does, so the JAX side is forced onto numpy by making its
native functions raise.  The port's native library (kdistr.cpp, built by
g++ at first use) is held to its numpy path at rtol 1e-12; without g++
those tests skip, and nothing else does.
"""

import os
import shutil
import subprocess
import sys
import unittest.mock as mock
from pathlib import Path

import h5py
import numpy as np
import pytest

from helios_tpu.io.opacity import gauss_legendre_ypoints
from helios_tpu.ktable import build as jkb
from helios_tpu.ktable import combine as jkc
from helios_tpu.ktable import continuous as jcont
from helios_tpu.ktable import native as jnative
from helios_tpu.ktable import params as jparams
from helios_tpu.ktable import rayleigh as jray
from helios_tpu_torch import constants as pc
from helios_tpu_torch import forward as tf
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.io.opacity import load_opacity_file
from helios_tpu_torch.ktable import build as kb
from helios_tpu_torch.ktable import combine as kc
from helios_tpu_torch.ktable import continuous, params, rayleigh

import torch
import torch_port_helpers  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "data" / "heliosk_fixture")


@pytest.fixture
def native():
    """The port's native library, built here; skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native ktable library cannot be "
                    "built")
    from helios_tpu_torch.ktable import native as kn
    return kn


@pytest.fixture
def jax_numpy():
    """The JAX package's ktable forced onto its numpy path."""
    with mock.patch.object(jnative, "kdistr_native",
                           side_effect=RuntimeError), \
            mock.patch.object(jnative, "bilinear_tp_native",
                              side_effect=RuntimeError):
        yield


def same_h5(got_path, want_path):
    """Two HDF5 files with the same datasets, each equal."""
    with h5py.File(got_path) as g, h5py.File(want_path) as w:
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k][()]),
                                          np.asarray(w[k][()]), err_msg=k)


def float64_chunks(module):
    """``module``'s HELIOS-K reader handing out float64: the files hold
    float32, on which the numpy k-distribution computes in float32 while
    the native library converts to float64 first."""
    read = module.read_chunk
    return mock.patch.object(module, "read_chunk", lambda *a: np.asarray(
        read(*a), np.float64))


def kdistr_inputs(seed=3):
    rng = np.random.default_rng(seed)
    lam_hk = np.sort(rng.uniform(1e-4, 1e-3, 5000))
    opac = 10.0 ** rng.uniform(-6, 1, 5000)
    edges = np.geomspace(1e-4, 1e-3, 25)
    y, _ = gauss_legendre_ypoints(20)
    return lam_hk, opac, edges, np.diff(edges), y


def bilinear_inputs():
    rng = np.random.default_rng(5)
    return (rng.uniform(0.1, 10.0, (6, 5, 4, 3)), np.linspace(100, 4000, 6),
            np.logspace(0, 8, 5), np.linspace(50, 4500, 13),
            np.logspace(-1, 9, 9))


# --------------------------------------------------------------------------- #
# k-distribution core
# --------------------------------------------------------------------------- #

def test_kdistribution_is_sorted_quantile_function():
    rng = np.random.default_rng(0)
    n = 4000
    lam = np.linspace(1.0e-4, 1.1e-4, n)
    opac = 10.0 ** rng.normal(-1.0, 1.0, n)
    y, _ = gauss_legendre_ypoints(20)
    args = (lam, opac, lam[0], lam[-1] + (lam[1] - lam[0]),
            lam[-1] - lam[0] + (lam[1] - lam[0]), y)
    k = kb.kdistribution_bin(*args)
    np.testing.assert_array_equal(k, jkb.kdistribution_bin(*args))
    assert np.all(np.diff(k) >= 0)
    assert np.interp(0.5, y, k) == pytest.approx(np.median(opac), rel=0.1)
    assert np.interp(0.9, y, k) == pytest.approx(np.quantile(opac, 0.9),
                                                 rel=0.15)


def test_kdistribution_numpy_is_jax_bitwise():
    args = kdistr_inputs()
    np.testing.assert_array_equal(
        kb.kdistribution_for_one_TP(*args, use_native=False),
        jkb.kdistribution_for_one_TP(*args, use_native=False))


def test_kdistribution_native_matches_numpy(native):
    args = kdistr_inputs()
    want = kb.kdistribution_for_one_TP(*args, use_native=False)
    np.testing.assert_allclose(native.kdistr_native(*args), want,
                               rtol=1e-12)
    np.testing.assert_array_equal(kb.kdistribution_for_one_TP(*args),
                                  native.kdistr_native(*args))


def test_bilinear_numpy_is_jax_bitwise(jax_numpy):
    args = bilinear_inputs()
    np.testing.assert_array_equal(
        kc.interpolate_tp_grid(*args, use_native=False),
        jkc.interpolate_tp_grid(*args))


def test_bilinear_native_matches_numpy(native):
    args = bilinear_inputs()
    got = native.bilinear_tp_native(*args)
    np.testing.assert_allclose(
        got, kc.interpolate_tp_grid(*args, use_native=False), rtol=1e-12)
    np.testing.assert_array_equal(kc.interpolate_tp_grid(*args), got)


def test_native_build_failure_raises(native, monkeypatch, tmp_path):
    """A source that does not compile raises with g++'s output; nothing
    falls back to numpy."""
    bad = tmp_path / "kdistr.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kb.kdistribution_for_one_TP(*kdistr_inputs())
    assert native.library_path().parent == tmp_path / "_build"
    assert "march" not in " ".join(native.GXX_FLAGS)


# --------------------------------------------------------------------------- #
# Rayleigh + continuum
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("species", rayleigh.IMPLEMENTED)
def test_rayleigh_cross_sections_are_jax_bitwise(species):
    lam = np.geomspace(0.2e-4, 30e-4, 64)
    kw = dict(press=1e6, temp=1200.0, f_h2o=1e-3) if species == "H2O" \
        else {}
    np.testing.assert_array_equal(
        rayleigh.species_cross_section(species, lam, **kw),
        jray.species_cross_section(species, lam, **kw))


def test_rayleigh_h2_magnitude_and_electron_thomson():
    sig = rayleigh.species_cross_section("H2", np.array([3.5e-5, 7e-5]))
    assert sig[0] / sig[1] == pytest.approx(16.0, rel=0.2)
    assert 1e-27 < sig[0] < 1e-25
    assert rayleigh.species_cross_section("e-", np.array([5e-5]))[0] \
        == pc.SIGMA_T


def test_continua_are_jax_bitwise():
    lam = np.geomspace(0.1e-4, 40e-4, 300)
    np.testing.assert_array_equal(continuous.h_min_bf_cross_sect(lam),
                                  jcont.h_min_bf_cross_sect(lam))
    sig = continuous.h_min_bf_cross_sect(
        np.array([0.1e-4, 0.8e-4, 1.6e-4, 1.7e-4]))
    assert sig[0] == 0.0 and sig[3] == 0.0 and sig[1] > 0 and sig[2] > 0
    for T in (2000.0, 5040.0, 9000.0):
        for loglam in (np.log10(0.5063), np.log10(3.0), np.log10(300.0)):
            assert continuous.he_min_log_k(T, loglam) \
                == jcont.he_min_log_k(T, loglam)
    assert continuous.he_min_log_k(5040.0, np.log10(0.5063)) \
        == pytest.approx(np.log10(0.072e-26), abs=0.3)
    assert continuous.he_min_log_k(3000.0, np.log10(300.0)) == -30.0


# --------------------------------------------------------------------------- #
# stage 1 and stage 2 on a synthetic HELIOS-K directory
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def heliosk_dir(tmp_path_factory):
    """Synthetic HELIOS-K output: 2 wavenumber chunks x 3 T x 4 P binary
    files (tests/test_ktable.py's)."""
    d = tmp_path_factory.mktemp("hk")
    rng = np.random.default_rng(9)
    for t in (500, 1000, 2000):
        for c in ("n600", "n300", "p000", "p300"):
            for n0, n1 in ((1000, 11000), (11000, 21000)):
                nu = np.arange(n0, n1, 1.0)
                base = 1e-3 * (1 + 10 * np.exp(-0.5 * ((nu - 5000) / 800)
                                               ** 2))
                opac = (base * (t / 1000.0) ** 0.3
                        * (kb.PRESS_DICT[c] / 1e6) ** 0.1
                        * 10.0 ** rng.uniform(-1, 1, len(nu)))
                opac.astype(np.float32).tofile(os.path.join(
                    str(d), f"Out_{n0:05d}_{n1:05d}_{t:05d}_{c}.bin"))
    return str(d)


def build_both(tmp_path, directory, names, **cfg_kw):
    """Stage 1 of the port (numpy) and of the JAX package (numpy) into
    two directories; returns (port dir, JAX dir, port files)."""
    mine, theirs = str(tmp_path / "port") + "/", str(tmp_path / "jax") + "/"
    files = []
    for name in names:
        files.append(kb.build_species(
            kb.BuildConfig(output_dir=mine, **cfg_kw), name, directory,
            use_native=False))
        want = jkb.build_species(jkb.BuildConfig(output_dir=theirs,
                                                 **cfg_kw),
                                 name, directory, use_native=False)
        same_h5(files[-1], want)
    return mine, theirs, files


STAGE1 = dict(grid_limits=(0.6, 8.0), resolution=20, n_gauss=20)


def test_stage1_build(heliosk_dir, tmp_path):
    _, _, (path,) = build_both(tmp_path, heliosk_dir, ["FAKE"], **STAGE1)
    with h5py.File(path) as f:
        k, y, lam = (np.asarray(f[n]) for n in
                     ("kpoints", "ypoints", "center wavelengths"))
        temps, press = np.asarray(f["temperatures"]), \
            np.asarray(f["pressures"])
    assert len(temps) == 3 and len(press) == 4
    k = k.reshape(len(temps), len(press), len(lam), len(y))
    assert np.all(k > 0) and np.all(np.diff(k, axis=-1) >= 0)
    assert np.median(k[2] / k[0]) == pytest.approx((2000 / 500) ** 0.3,
                                                   rel=0.1)


def test_stage1_native_matches_numpy(native, heliosk_dir, tmp_path):
    """The native build against the numpy build on the same float64
    opacities (see float64_chunks)."""
    cfg = kb.BuildConfig(output_dir=str(tmp_path / "n") + "/", **STAGE1)
    got = kb.build_species(cfg, "FAKE", heliosk_dir)
    cfg = kb.BuildConfig(output_dir=str(tmp_path / "p") + "/", **STAGE1)
    with float64_chunks(kb):
        want = kb.build_species(cfg, "FAKE", heliosk_dir, use_native=False)
    with h5py.File(got) as g, h5py.File(want) as w:
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose(np.asarray(g["kpoints"]),
                                   np.asarray(w["kpoints"]), rtol=1e-12)


MIX = [("H2O", True, True, "3e-4"), ("CO", True, False, "1e-4"),
       ("H2", False, True, "0.9"), ("He", False, True, "0.1")]


def test_stage2_combine_and_solve(heliosk_dir, tmp_path, jax_numpy):
    """Two species built, combined with constant VMRs: every file of
    stage 2 equal to the JAX package's; the mixed table loads into the
    port's solver, whose forward pass (CPU) is finite."""
    mine, theirs, _ = build_both(tmp_path, heliosk_dir, ["H2O", "CO"],
                                 **STAGE1)
    comb = kc.Combiner(individual_dir=mine, final_dir=mine,
                       use_native=False)
    comb.combine_all([kc.MixSpecies(*s) for s in MIX])
    jcomb = jkc.Combiner(individual_dir=theirs, final_dir=theirs)
    jcomb.combine_all([jkc.MixSpecies(*s) for s in MIX])
    for name in ("mixed_opac_kdistr.h5", "H2O_opac_ip_kdistr.h5",
                 "CO_opac_ip_kdistr.h5"):
        same_h5(os.path.join(mine, name), os.path.join(theirs, name))

    table = load_opacity_file(os.path.join(mine, "mixed_opac_kdistr.h5"))
    assert table.ny == 20 and table.nbin == comb.nx
    w = (3e-4 * 18.0153 + 1e-4 * 28.01 + 0.9 * 2.01588 + 0.1 * 4.0026) \
        / (3e-4 + 1e-4 + 0.9 + 0.1)
    np.testing.assert_allclose(table.meanmolmass[0, 0], w * pc.AMU,
                               rtol=1e-6)
    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=100.0,
                       scattering="yes", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=8,
                       p_boa=1e8, p_toa=1e3).finalize()
    phys, arrays = tf.build_model(cfg, table, device="cpu")
    T = torch.linspace(1500.0, 700.0, 9, dtype=torch.float64)
    totals = tf.forward_fluxes(phys, arrays, T)[1]
    assert bool(torch.all(torch.isfinite(totals.F_net)))
    assert float(totals.F_up_tot[-1]) > 0


def test_stage2_native_matches_numpy(native, heliosk_dir, tmp_path):
    mine, _, _ = build_both(tmp_path, heliosk_dir, ["H2O", "CO"], **STAGE1)
    out = {}
    for use_native in (True, False):
        d = str(tmp_path / f"final_{use_native}") + "/"
        kc.Combiner(individual_dir=mine, final_dir=d,
                    use_native=use_native).combine_all(
            [kc.MixSpecies(*s) for s in MIX])
        with h5py.File(os.path.join(d, "mixed_opac_kdistr.h5")) as f:
            out[use_native] = np.asarray(f["kpoints"])
    np.testing.assert_allclose(out[True], out[False], rtol=1e-12)


# --------------------------------------------------------------------------- #
# the committed HELIOS-K product-format fixture
# --------------------------------------------------------------------------- #

def test_heliosk_fixture_scan():
    fs = kb.scan_heliosk_directory(FIXTURE)
    jfs = jkb.scan_heliosk_directory(FIXTURE)
    assert fs.file_name == jfs.file_name == "01_HITEMP_H2O"
    assert fs.numin == [1000, 2000] and fs.numax == [2000, 3000]
    assert fs.temps == [300, 600] and fs.press_codes == ["n200", "p000"]
    np.testing.assert_array_equal(fs.pressures, jfs.pressures)
    assert np.allclose(fs.pressures, [1e4, 1e6])
    for n in range(2):
        for t in range(2):
            for p in range(2):
                assert fs.path(n, t, p) == jfs.path(n, t, p)
                assert os.path.exists(fs.path(n, t, p))


def test_heliosk_fixture_bin_payload_and_dat_twin():
    fs = kb.scan_heliosk_directory(FIXTURE)
    k_bin = kb.read_chunk(fs.path(0, 0, 0), "binary")
    np.testing.assert_array_equal(k_bin, jkb.read_chunk(fs.path(0, 0, 0),
                                                        "binary"))
    assert k_bin.dtype == np.float32 and len(k_bin) == 1000
    assert np.all(k_bin > 0) and 1e-7 < k_bin.min() < k_bin.max() < 1e4
    dat = os.path.join(FIXTURE, "dat",
                       "Out_01_HITEMP_H2O_01000_02000_00300_n200.dat")
    k_dat = kb.read_chunk(dat, "text")
    np.testing.assert_array_equal(k_dat, jkb.read_chunk(dat, "text"))
    np.testing.assert_allclose(k_dat, k_bin, rtol=1e-5)


FIXTURE_STAGE1 = dict(grid_limits=(3.5, 9.5), resolution=15, n_gauss=8)


def test_heliosk_fixture_stage1_build(tmp_path):
    _, _, (path,) = build_both(tmp_path, FIXTURE, ["H2O_fixture"],
                               **FIXTURE_STAGE1)
    with h5py.File(path) as f:
        k, y, lam = (np.asarray(f[n]) for n in
                     ("kpoints", "ypoints", "center wavelengths"))
        assert list(np.asarray(f["temperatures"])) == [300.0, 600.0]
        assert np.allclose(np.asarray(f["pressures"]), [1e4, 1e6])
    k = k.reshape(2, 2, len(lam), len(y))
    assert np.all(k > 0) and np.all(np.diff(k, axis=-1) >= 0)
    assert np.median(k[:, 1, :, 0] / k[:, 0, :, 0]) > 1.0


def test_heliosk_fixture_stage1_native_matches_numpy(native, tmp_path):
    paths = []
    for d, use_native in (("n", True), ("p", False)):
        with float64_chunks(kb):
            paths.append(kb.build_species(
                kb.BuildConfig(output_dir=str(tmp_path / d) + "/",
                               **FIXTURE_STAGE1),
                "H2O_fixture", FIXTURE, use_native=use_native))
    with h5py.File(paths[0]) as g, h5py.File(paths[1]) as w:
        np.testing.assert_allclose(np.asarray(g["kpoints"]),
                                   np.asarray(w["kpoints"]), rtol=1e-12)


# --------------------------------------------------------------------------- #
# param_ktable.dat and the command line
# --------------------------------------------------------------------------- #

def write_param_ktable(path, **values):
    """A param_ktable.dat in the reference layout (keyword lines, the
    value after "="), with ``values`` in place of the defaults."""
    v = dict(building="yes", format="k-distribution", hk="binary",
             species="./input/individual_species.dat",
             grid_format="fixed_resolution", grid="50 0.244 500",
             grid_file="./input/grid.dat", n_gauss="20",
             individual="./output/r50_kdistr/", mixing="yes",
             final_species="./input/final_species.dat",
             fastchem="../input/chemistry/lodders_m0/",
             final="./output/final/", units="CGS")
    v.update(values)
    Path(path).write_text(f"""\
### ktable parameter file ###
individual species calculation = {v['building']}
format = {v['format']}          [k-distribution, sampling]
HELIOS-K output format = {v['hk']}    [binary, text]
path to individual species file = {v['species']}
grid format = {v['grid_format']}   [fixed_resolution, file]
(fixed_resolution) -- wavelength grid = {v['grid']}  [R, micron, micron]
(file) -- path to grid file = {v['grid_file']}
(k-distribution) -- number of Gaussian points = {v['n_gauss']}
directory with individual files = {v['individual']}
mixed table production = {v['mixing']}
path to final species file = {v['final_species']}
path to FastChem output = {v['fastchem']}
mixed table output directory = {v['final']}
units of mixed opacity table = {v['units']}    [CGS, MKS]
""")
    return str(path)


def test_param_ktable_file_parses(tmp_path):
    path = write_param_ktable(tmp_path / "param_ktable.dat")
    p = params.parse_param_ktable_file(path)
    assert p == params.KtableParams(**vars(
        jparams.parse_param_ktable_file(path)))
    assert p.building == "yes" and p.mixing == "yes"
    assert p.format == "k-distribution" and p.heliosk_format == "binary"
    assert p.resolution == 50.0 and p.grid_limits == [0.244, 500.0]
    assert p.n_gauss == 20 and p.units == "CGS"
    assert p.individual_calc_path == "./output/r50_kdistr/"
    assert p.fastchem_path == "../input/chemistry/lodders_m0/"


def test_param_ktable_cli_overrides(tmp_path):
    argv = ["-parameter_file", write_param_ktable(tmp_path / "p.dat"),
            "-format", "sampling", "-number_of_gaussian_points", "31",
            "-units_of_mixed_opacity_table", "MKS",
            "-wavelength_grid", "100 0.5 20",
            "-mixed_table_output_directory", str(tmp_path)]
    p = params.read_param_file_and_command_line(argv)
    assert vars(p) == vars(jparams.read_param_file_and_command_line(argv))
    assert p.format == "sampling" and p.n_gauss == 31 and p.units == "MKS"
    assert p.resolution == 100.0 and p.grid_limits == [0.5, 20.0]
    assert p.final_path == str(tmp_path)


def test_param_ktable_bad_units():
    with pytest.raises(ValueError, match="units"):
        params.read_param_file_and_command_line(
            ["-units_of_mixed_opacity_table", "IMPERIAL"])


def test_grid_file_mode(tmp_path):
    grid = np.geomspace(1e-4, 1e-3, 21)
    gpath = str(tmp_path / "grid.dat")
    np.savetxt(gpath, grid)
    got = kb.build_wavelength_grid(kb.BuildConfig(grid_format="file",
                                                  grid_file_path=gpath))
    want = jkb.build_wavelength_grid(jkb.BuildConfig(grid_format="file",
                                                     grid_file_path=gpath))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[1], grid)
    with pytest.raises(IOError):
        kb.build_wavelength_grid(kb.BuildConfig(grid_format="native_helios-k"))


def run_module(module, *args, cwd):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_ktable_help_in_a_subprocess(tmp_path):
    proc = run_module("helios_tpu_torch.ktable", "-h", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "python -m helios_tpu_torch.ktable" in proc.stdout
    assert "-mixed_table_output_directory" in proc.stdout


def test_ktable_command_line_builds_and_mixes_the_fixture(tmp_path):
    """``python -m helios_tpu_torch.ktable`` with a param_ktable.dat:
    both stages on the committed fixture through the native library; the
    mixed table within 1e-12 of the JAX package's numpy chain on the same
    opacities in float64 (see float64_chunks), its other datasets
    equal."""
    (tmp_path / "individual.dat").write_text(
        f"name directory\nH2O {FIXTURE}\n")
    (tmp_path / "final.dat").write_text(
        "final species\nname absorbing scattering mixing_ratio\n"
        "H2O yes yes 1e-3\nH2 no yes 0.9\nHe no yes 0.1\n")
    param = write_param_ktable(
        tmp_path / "param_ktable.dat", species="individual.dat",
        grid="15 3.5 9.5", n_gauss="8", individual="./individual/",
        final_species="final.dat", final="./final/")
    use_native = shutil.which("g++") is not None
    extra = [] if use_native else ["-individual_species_calculation", "no"]
    if not use_native:         # stage 1 in this process, on numpy
        with float64_chunks(kb):
            kb.build_species(kb.BuildConfig(
                output_dir=str(tmp_path / "individual") + "/",
                **FIXTURE_STAGE1), "H2O", FIXTURE, use_native=False)
    proc = run_module("helios_tpu_torch.ktable", "-parameter_file", param,
                      *extra, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Production of mixed opacity table successful" in proc.stdout
    assert "helios_tpu_torch ktable pipeline" in (
        tmp_path / "final" / "opac_table_info.dat").read_text()

    theirs = tmp_path / "jax"
    with mock.patch.object(jnative, "kdistr_native",
                           side_effect=RuntimeError), \
            mock.patch.object(jnative, "bilinear_tp_native",
                              side_effect=RuntimeError), \
            float64_chunks(jkb):
        jkb.build_species(jkb.BuildConfig(output_dir=str(theirs) + "/",
                                          **FIXTURE_STAGE1),
                          "H2O", FIXTURE, use_native=False)
        jkc.Combiner(individual_dir=str(theirs) + "/",
                     final_dir=str(theirs) + "/").combine_all(
            jkc.parse_final_species_file(str(tmp_path / "final.dat")))
    got = tmp_path / "final" / "mixed_opac_kdistr.h5"
    with h5py.File(got) as g, \
            h5py.File(theirs / "mixed_opac_kdistr.h5") as w:
        assert sorted(g) == sorted(w)
        for k in w:
            a, b = np.asarray(g[k][()]), np.asarray(w[k][()])
            if k in ("kpoints", "weighted Rayleigh cross-sections"):
                np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
