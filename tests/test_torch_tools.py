"""The output readers and spectrum tools of the PyTorch port
(helios_tpu_torch.tools) against the JAX package's (helios_tpu.tools):
the scenarios of tests/test_tools_readers.py:33-113, on output files that
the port's own pipeline.run writes (CPU, 8 layers x 12 bins x 4).  The
two modules are the same numpy code, so every result is compared bit for
bit; the readers are also held against the run they read.
"""

import os

import numpy as np
import pytest

from helios_tpu import tools as jtools
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch import tools
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.io.opacity import synthetic_premixed_table

import torch_port_helpers  # noqa: F401  (one torch thread)


@pytest.fixture(scope="module")
def run_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=8, npress=6)
    cfg = HeliosConfig(name="rd", output_dir=str(tmp) + "/",
                       planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=150.0,
                       scattering="no", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=8,
                       p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-5)
    out = torch_pipeline.run(cfg, table=table, device="cpu")
    return out, os.path.join(str(tmp), "rd")


def same(got, want):
    """Equal results of the two readers: tuples of arrays or lists."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kind,fudge", [("emission", 1.0), ("star", 2.0),
                                        ("eclipse", 2.0), ("star", 1.0)])
def test_read_helios_spectrum(run_outputs, kind, fudge):
    out, d = run_outputs
    path = os.path.join(d, "rd_TOA_flux_eclipse.dat")
    got = tools.read_helios_spectrum(path, type=kind,
                                     star_fudge_factor=fudge)
    same(got, jtools.read_helios_spectrum(path, type=kind,
                                          star_fudge_factor=fudge))
    lam, values = got
    assert len(lam) == out.result.nbin
    np.testing.assert_allclose(lam, out.result.opac_wave * 1e4, rtol=1e-5)
    if kind == "emission":
        np.testing.assert_allclose(
            values, out.result.F_up_band[out.result.nlayer], rtol=1e-4)
    if kind == "star" and fudge == 2.0:
        _, star1 = tools.read_helios_spectrum(path, type="star")
        np.testing.assert_allclose(values, 2.0 * star1)


def test_read_helios_spectrum_refuses_an_unknown_type(run_outputs):
    _, d = run_outputs
    with pytest.raises(ValueError):
        tools.read_helios_spectrum(os.path.join(d, "rd_TOA_flux_eclipse.dat"),
                                   type="bogus")


def test_read_helios_tp(run_outputs):
    out, d = run_outputs
    path = os.path.join(d, "rd_tp.dat")
    got = tools.read_helios_tp(path)
    same(got, jtools.read_helios_tp(path))
    press, temp, *zones = got
    assert len(press) == out.result.nlayer + 1
    np.testing.assert_allclose(press[0], out.result.p_int[0] * 1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(temp[1:], out.result.T_lay[:out.result.nlayer],
                               rtol=1e-5)
    assert all(len(z) == 0 for z in zones)


def test_read_helios_tp_convective_zones(tmp_path):
    path = str(tmp_path / "tp.dat")
    conv = [0, 1, 1, 0, 0, 1, 1, 1, 0, 0]
    with open(path, "w") as f:
        f.write("header\ncolumns\n")
        for i, c in enumerate(conv):
            f.write(f"{i} {1000 + i} {10 ** (8 - 0.5 * i):.6e} 0 0 0 {c}\n")
    got = tools.read_helios_tp(path)
    same(got, jtools.read_helios_tp(path))
    press, temp, p0, t0, p1, t1, p2, t2, p3, t3 = got
    assert t0 == [1001.0, 1002.0]
    assert t1 == [1005.0, 1006.0, 1007.0]
    assert p2 == [] and p3 == []


def test_read_helios_tp_coupling_format(tmp_path):
    path = str(tmp_path / "tpc.dat")
    with open(path, "w") as f:
        f.write("header\n")
        for i in range(5):
            f.write(f"{10 ** (8 - i):.6e} {900 + i}\n")
    got = tools.read_helios_tp(path, coupling_format=1)
    same(got, jtools.read_helios_tp(path, coupling_format=1))
    press, temp, *zones = got
    assert temp == [900.0, 901.0, 902.0, 903.0, 904.0]
    np.testing.assert_allclose(press[0], 100.0)


@pytest.mark.parametrize("kind", ["linear", "gaussian"])
def test_rebin_spectrum_to_resolution(kind):
    lam = np.geomspace(1e-5, 1e-3, 5000)
    flux = np.full_like(lam, 7.5) * (1.0 + 0.1 * np.sin(lam * 1e4))
    got = tools.rebin_spectrum_to_resolution(lam, flux, 50.0, type=kind)
    same(got, jtools.rebin_spectrum_to_resolution(lam, flux, 50.0,
                                                  type=kind))
    new_lam, _ = got
    assert new_lam[0] == lam[0] and new_lam[-1] < lam[-1]
    np.testing.assert_allclose(new_lam[1:] / new_lam[:-1], 51.0 / 50.0,
                               rtol=1e-12)
    flat = np.full_like(lam, 7.5)
    _, new_flat = tools.rebin_spectrum_to_resolution(lam, flat, 50.0,
                                                     type=kind)
    interior = slice(1, -1) if kind == "linear" else slice(5, -5)
    np.testing.assert_allclose(new_flat[interior], 7.5,
                               rtol=1e-9 if kind == "linear" else 1e-6)
    new_um, _ = tools.rebin_spectrum_to_resolution(lam * 1e4, flux, 50.0,
                                                   w_unit="micron")
    np.testing.assert_allclose(new_um, new_lam * 1e4, rtol=1e-12)


def test_gauss_pdf_and_convolution():
    x = np.linspace(-3.0, 3.0, 61)
    np.testing.assert_array_equal(tools.gauss_pdf(x, 0.2, 0.7),
                                  jtools.gauss_pdf(x, 0.2, 0.7))
    lam = np.geomspace(1e-4, 1e-3, 400)
    flux = 1.0 + np.exp(-((lam - 3e-4) / 2e-6) ** 2)
    for new in (None, np.geomspace(1.2e-4, 9e-4, 50)):
        got = tools.convolve_with_gaussian(lam, flux, 100.0, new_lamda=new)
        want = jtools.convolve_with_gaussian(lam, flux, 100.0, new_lamda=new)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
