"""The command line of the PyTorch port (``python -m helios_tpu_torch``,
helios_tpu_torch.__main__), its quickstart (helios_tpu_torch.examples), a
stellar spectrum from an HDF5 file and coupling, against helios_tpu on the
CPU.

Tolerances.  The runs are small isothermal scenarios to convergence (those
of tests/test_cli_tools.py and tests/test_surface_modes.py), compared with
the JAX run with native fp64 Planck lookups: the final T at rtol 1e-8
(ROADMAP C, iso runs), and the files, printed with "%g", number by number
at rtol 1e-5 plus 1e-9 of each column's largest value.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from helios_tpu import __main__ as jax_main
from helios_tpu import chem as jchem
from helios_tpu import examples as jexamples
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import save_opacity_file, synthetic_premixed_table
from helios_tpu_torch import __main__ as torch_main
from helios_tpu_torch import chem as tchem
from helios_tpu_torch import examples as texamples
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.config import parse_param_file

import torch_port_helpers as H

ROOT = Path(__file__).resolve().parent.parent

# the param file of tests/test_cli_tools.py:24
PARAM = """
name =                       clirun
output directory =           {out}/
realtime plotting =          no
planet type =                gas
TOA pressure [10^-6 bar] =   1e3
BOA pressure [10^-6 bar] =   1e8
run type =                   iterative
scattering =                 no
direct irradiation beam =    no
internal temperature [K] =   150
opacity mixing =             premixed
path to opacity file =       {opac}
convective adjustment =      no
plancktable dimension and stepsize = 8000 2
number of layers =           8
isothermal layers =          yes
radiative equilibrium criterion = 1e-5
planet =                     manual
surface gravity [cm s^-2] =  2288
orbital distance [au] =      0.0153
radius planet [r_jup] =      1.0
radius star [r_sun] =        1.0
temperature star [k] =       4000
"""


@pytest.fixture
def param_file(tmp_path):
    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=8, npress=6)
    opac = tmp_path / "table.h5"
    save_opacity_file(str(opac), table)
    param = tmp_path / "param.dat"
    param.write_text(PARAM.format(out=tmp_path / "out", opac=opac))
    return param


def test_cli_writes_the_files_of_jax(param_file, tmp_path, monkeypatch,
                                     capsys):
    """main(argv, device="cpu") on the param file of tests/test_cli_tools.py
    against helios_tpu's main() on the same file: the "Done!" line, the
    same output files, and _tp.dat by the "%g" rule."""
    argv = ["-parameter_file", str(param_file)]
    assert torch_main.main(argv, device="cpu") == 0
    printed = capsys.readouterr().out
    assert "Done!" in printed and "Global energy imbalance" in printed
    got = tmp_path / "out" / "clirun"
    os.rename(got, tmp_path / "torch_out")

    H.native_build(monkeypatch)
    assert jax_main.main(argv) == 0
    want = tmp_path / "out" / "clirun"
    assert sorted(os.listdir(tmp_path / "torch_out")) == sorted(
        os.listdir(want))
    assert "clirun_TOA_flux_eclipse.dat" in os.listdir(want)
    H.assert_same_files(str(tmp_path / "torch_out"), str(want),
                        names=["clirun_tp.dat"])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_cli_without_cuda_exits_nonzero_with_the_message(no_cuda,
                                                         param_file):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "helios_tpu_torch", "-parameter_file",
         str(param_file)], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Done!" not in proc.stdout


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_examples_write_the_files_of_jax(tmp_path):
    """write_example_inputs (at a small width) writes the files of
    helios_tpu's: the same names, the same opacity table, and a param.dat
    that parses to the same config; it names the port's command."""
    got = texamples.write_example_inputs(str(tmp_path / "t"), nbin=12, ny=4)
    want = jexamples.write_example_inputs(str(tmp_path / "j"), nbin=12, ny=4)
    assert sorted(got) == sorted(want)
    for k in got:
        assert os.path.basename(got[k]) == os.path.basename(want[k])
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    with h5py.File(got["opacity"], "r") as g, \
            h5py.File(want["opacity"], "r") as w:
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k][()], w[k][()], err_msg=k)
    tcfg = _fields(parse_param_file(got["param"]))
    jcfg = _fields(parse_param_file(want["param"]))
    for k in ("opacity_path", "output_dir"):
        assert tcfg.pop(k).replace("/t/", "/j/") == jcfg.pop(k)
    assert tcfg == jcfg
    text = Path(got["param"]).read_text()
    assert "python -m helios_tpu_torch --help" in text
    assert Path(got["ensemble"]).read_text().startswith(
        jexamples.ENSEMBLE_TEMPLATE.split("\n")[0])


def test_examples_cli_prints_the_first_run_command(tmp_path, capsys):
    assert texamples.main([str(tmp_path / "ex")]) == 0
    out = capsys.readouterr().out
    assert "python -m helios_tpu_torch -parameter_file" in out
    cfg = parse_param_file(str(tmp_path / "ex" / "param.dat")).finalize()
    assert cfg.nlayer == 105
    with h5py.File(str(tmp_path / "ex" / "opac_synthetic.h5"), "r") as f:
        assert len(f["center wavelengths"]) == 385
        assert len(f["ypoints"]) == 20


def write_spectrum(path, nbin, seed=11):
    """A synthetic stellar spectrum (not a blackbody) in HDF5, in the
    layout of the star tool's files: one dataset per star."""
    rng = np.random.default_rng(seed)
    flux = 1e12 * (1.0 + rng.random(nbin)) * np.linspace(2.0, 0.5, nbin)
    with h5py.File(path, "w") as f:
        f.create_dataset("/r50_kdistr/synthetic/star", data=flux)
    return flux


def test_stellar_spectrum_file_run_matches_jax(tmp_path, monkeypatch):
    """stellar_model="file" with the direct beam on the iso scenario of
    tests/test_cli_tools.py: the spectrum read as helios_tpu reads it, the
    run's final T at rtol 1e-8 and its spectral output by the "%g" rule;
    a spectrum of the wrong length is refused as in helios_tpu."""
    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=8, npress=6)
    star = tmp_path / "star.h5"
    flux = write_spectrum(str(star), table.nbin)
    kw = dict(name="star", planet="manual", g=2288.0, a=0.0153,
              R_planet=1.0, R_star=1.0, T_star=4000.0, T_intern=150.0,
              scattering="no", direct_beam="yes", convection="no",
              run_type="iterative", iso_input="yes", nlayer=8, p_boa=1e8,
              p_toa=1e3, rad_convergence_limit=1e-5, stellar_model="file",
              stellar_path=str(star),
              stellar_dataset="/r50_kdistr/synthetic/star")
    tcfg = TorchConfig(**kw, output_dir=str(tmp_path / "t") + "/").finalize()
    np.testing.assert_array_equal(
        torch_pipeline.load_starflux(tcfg, table.nbin),
        jax_pipeline.load_starflux(JaxConfig(**kw).finalize(), table.nbin))
    np.testing.assert_array_equal(
        torch_pipeline.load_starflux(tcfg, table.nbin), flux)
    with pytest.raises(OverflowError, match="different lengths"):
        torch_pipeline.load_starflux(tcfg, table.nbin + 1)

    got = torch_pipeline.run(tcfg, table, device="cpu")
    assert got.phys.real_star == 1
    assert not bool(got.rad.keep_running) and not got.rad.aborted
    H.native_build(monkeypatch)
    want = jax_pipeline.run(JaxConfig(
        **kw, output_dir=str(tmp_path / "j") + "/"), table=table)
    np.testing.assert_allclose(got.result.T_lay, want.result.T_lay,
                               rtol=1e-8)
    np.testing.assert_allclose(got.result.star_corr_factor,
                               want.result.star_corr_factor, rtol=1e-12)
    H.assert_same_files(str(tmp_path / "t" / "star"),
                        str(tmp_path / "j" / "star"),
                        names=["star_tp.dat", "star_direct_beamflux.dat",
                               "star_planck_cent.dat"])


def test_coupling_round_trip_matches_jax(tmp_path, monkeypatch):
    """The coupling round trip of tests/test_surface_modes.py:140 in both
    packages: coupling iterations 0 and 1 write the same coupling TP files
    (by the "%g" rule) and the same convergence file, "1" for identical
    physics."""
    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=10, npress=8,
                                     seed=6)
    kw = dict(name="cpl", planet="manual", g=981.0, a=0.05, R_planet=0.09,
              R_star=0.5, T_star=3500.0, T_intern=100.0, scattering="no",
              direct_beam="no", convection="no", run_type="iterative",
              iso_input="yes", nlayer=10, p_boa=1e6, p_toa=1e2,
              rad_convergence_limit=1e-5, coupling="yes",
              opacity_mixing="on-the-fly")

    def sset(chem):
        specs = [chem.SpeciesSpec("H2O", True, False, "1e-3"),
                 chem.SpeciesSpec("H2", False, False, "0.9")]
        extra = {"device": "cpu"} if chem is tchem else {}
        return chem.build_species_set(
            specs, ktemps=table.temperatures, kpress=table.pressures,
            nbin=table.nbin, ny=table.ny, nlayer=10,
            opacity_tables={"H2O": table.kpoints}, **extra)

    for n in (0, 1):
        torch_pipeline.run(TorchConfig(**kw, coupling_iter_nr=n,
                                       output_dir=str(tmp_path / "t") + "/"),
                           table, sset=sset(tchem), device="cpu")
    H.native_build(monkeypatch)
    for n in (0, 1):
        jax_pipeline.run(JaxConfig(**kw, coupling_iter_nr=n,
                                   output_dir=str(tmp_path / "j") + "/"),
                         table=table, sset=sset(jchem))
    got, want = tmp_path / "t" / "cpl", tmp_path / "j" / "cpl"
    names = ["cpl_tp_coupling_0.dat", "cpl_tp_coupling_1.dat",
             "cpl_coupling_convergence.dat"]
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    H.assert_same_files(str(got), str(want), names=names)
    assert (got / "cpl_coupling_convergence.dat").read_text() == "1"
