"""The real-data chain of the PyTorch port (helios_tpu_torch.realdata):
the committed Gueymard (2003) solar spectrum and the John (1988) H-
continuum through the port's ktable (stage 1 and 2) and star tool, then
the port's pipeline.run on the CPU from the files.

Against the JAX package's chain (helios_tpu.realdata) on the same inputs:
the mixed table and the star file equal dataset by dataset (both chains
on their numpy paths; the port's native library within 1e-12 of its
numpy path), and the port's converged 25-layer run within ROADMAP C's
bound for stellar-file runs of the JAX package's run from the same files
(its native Planck lookups, the default criterion): final T at 1e-8.
Against external truths and the drift pins of
tests/test_realdata_endtoend.py:60-162: the solar constant, the incident
flux by geometry, the John (1988) cross-section through the chain, and
the emission spectrum's pins at rel 1e-4.
"""

import os
import shutil
import unittest.mock as mock

import h5py
import numpy as np
import pytest

from helios_tpu import pipeline as jax_pipeline
from helios_tpu import realdata as jrealdata
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.ktable import native as jnative
from helios_tpu_torch import constants as pc
from helios_tpu_torch import realdata

import torch_port_helpers as H
from test_realdata_endtoend import AU, R_SUN, SOLAR_CONSTANT_CGS, SUN_TXT


def datasets(path):
    out = {}
    with h5py.File(path) as f:
        f.visititems(lambda n, o: out.__setitem__(n, np.asarray(o[()]))
                     if isinstance(o, h5py.Dataset) else None)
    return out


@pytest.fixture(scope="module")
def miniature(tmp_path_factory):
    """The port's chain on numpy (use_native=False), and the JAX
    package's with its native functions raising (its numpy path)."""
    d = str(tmp_path_factory.mktemp("port"))
    mine = realdata.build_miniature(d, SUN_TXT, use_native=False)
    j = str(tmp_path_factory.mktemp("jax"))
    with mock.patch.object(jnative, "kdistr_native",
                           side_effect=RuntimeError), \
            mock.patch.object(jnative, "bilinear_tp_native",
                              side_effect=RuntimeError):
        theirs = jrealdata.build_miniature(j, SUN_TXT)
    return mine, theirs


@pytest.mark.parametrize("which", ["mixed table", "star file",
                                   "individual table"])
def test_chain_files_are_jax_bitwise(miniature, which):
    (mixed, star, dataset), (jmixed, jstar, jdataset) = miniature
    assert dataset == jdataset
    got, want = {"mixed table": (mixed, jmixed),
                 "star file": (star, jstar),
                 "individual table": (
                     os.path.join(os.path.dirname(mixed),
                                  "H-_bf_tab_opac_kdistr.h5"),
                     os.path.join(os.path.dirname(jmixed),
                                  "H-_bf_tab_opac_kdistr.h5"))}[which]
    g, w = datasets(got), datasets(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_native_chain_matches_numpy(miniature, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native ktable library cannot be "
                    "built")
    (mixed, _, _), _ = miniature
    nat = realdata.build_mixed_table(str(tmp_path))
    g, w = datasets(nat), datasets(mixed)
    assert sorted(g) == sorted(w)
    for k in w:
        if w[k].dtype.kind == "f":
            np.testing.assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_star_integral_reproduces_solar_constant(miniature):
    (mixed, star, dataset), _ = miniature
    dlam = datasets(mixed)["wavelength width of bins"]
    flux = datasets(star)[dataset.lstrip("/")]
    at_1au = float(np.sum(flux * dlam)) * (R_SUN / AU) ** 2
    assert at_1au == pytest.approx(SOLAR_CONSTANT_CGS, rel=5e-3)


def test_hminus_bf_survives_ktable_chain(miniature):
    (mixed, _, _), _ = miniature
    d = datasets(mixed)
    lam, temps, press, ypts = (d[k] for k in (
        "center wavelengths", "temperatures", "pressures", "ypoints"))
    k = d["kpoints"].reshape(len(temps), len(press), len(lam), len(ypts))
    mu = d["meanmolmass"].reshape(len(temps), len(press))
    x = int(np.argmin(np.abs(lam - 0.85e-4)))
    t, p = 29, 0
    expected = (3.9935e-17 / (realdata.M_HMINUS * pc.AMU)
                * float(realdata.VMR_HMINUS) * realdata.M_HMINUS / mu[t, p])
    assert k[t, p, x, len(ypts) // 2] == pytest.approx(expected, rel=0.02)


@pytest.fixture(scope="module")
def runs(miniature, tmp_path_factory):
    """The port's run of the miniature (CPU) from the port's files."""
    (mixed, star, dataset), _ = miniature
    out_dir = str(tmp_path_factory.mktemp("run")) + "/"
    cfg, out = realdata.run_miniature(mixed, star, dataset, out_dir,
                                      device="cpu")
    return cfg, out, out_dir


def test_run_converges_from_real_files(runs):
    cfg, out, out_dir = runs
    assert not bool(out.rad.keep_running) and not out.rad.aborted
    files = sorted(os.listdir(os.path.join(out_dir, "mini")))
    for want in ("mini_TOA_flux_eclipse.dat", "mini_spec_upflux.dat",
                 "mini_tp.dat", "mini_transmission.dat"):
        assert want in files


def test_run_matches_jax_run(miniature, tmp_path):
    """The port's run and the JAX package's with its native fp64 Planck
    lookups, from the port's files, at the packages' default radiative
    criterion (1e-8): final T at 1e-8 (7.7e-9 measured).  An iso run is
    compared against that branch (ROADMAP C: under jit the two-float32
    Planck pairs move the iso totals by 2.2e-8; with them the JAX run at
    1e-8 does not converge, it stops at its 10001-iteration cap 1.4e-4
    off).  The miniature's own criterion, 1e-5, lets two runs stop
    4.8e-6 apart in T (2.9e-6 against the pairs)."""
    (mixed, star, dataset), _ = miniature
    _, out = realdata.run_miniature(mixed, star, dataset,
                                    str(tmp_path / "port") + "/",
                                    device="cpu", rad_convergence_limit=1e-8)
    jcfg = JaxConfig(**dict(realdata.MINIATURE_RUN,
                            rad_convergence_limit=1e-8),
                     output_dir=str(tmp_path / "jax") + "/",
                     opacity_path=mixed, stellar_model="file",
                     stellar_path=star, stellar_dataset=dataset)
    build = jax_pipeline.build_model
    with mock.patch.object(jax_pipeline, "build_model", lambda *a, **k: (
            lambda pa: (pa[0], H.native_planck(pa[1])))(build(*a, **k))):
        jout = jax_pipeline.run(jcfg)
    assert not bool(out.rad.keep_running) and not out.rad.aborted
    assert bool(np.all(np.asarray(jout.rad.abort)))
    H.assert_close(out.T_lay.numpy(), np.asarray(jout.rad.T_lay), rtol=1e-8,
                   err_msg="final T against the JAX package's run")


def test_incident_flux_matches_solar_constant_geometry(runs):
    _, out, _ = runs
    F_dn_toa = float(np.asarray(out.result.F_down_tot)[-1])
    surface_flux = SOLAR_CONSTANT_CGS * (AU / R_SUN) ** 2
    expected = 0.5 * (R_SUN / (0.02 * AU)) ** 2 * surface_flux
    assert F_dn_toa == pytest.approx(expected, rel=0.01)


def test_realdata_emission_spectrum_drift_pin(runs):
    """The pins of tests/test_realdata_endtoend.py, from the port's run."""
    _, out, _ = runs
    assert float(out.T_lay[0]) == pytest.approx(1728.769, rel=1e-4)
    fup_toa = np.asarray(out.result.F_up_band)[-1]
    pins = {5: 392944038556.3241, 20: 7021063481499.33,
            40: 2180712600879.6511, 60: 403286289435.7345,
            80: 17430515010.32885, 95: 1189551862.6760116}
    for i, want in pins.items():
        assert fup_toa[i] == pytest.approx(want, rel=1e-4), f"bin {i}"


def test_realdata_spectrum_is_physical(runs):
    cfg, out, _ = runs
    lam = datasets(cfg.opacity_path)["center wavelengths"]
    fup = np.asarray(out.result.F_up_band)[-1]
    ir = (lam > 2e-4) & (lam < 25e-4)
    C1 = 2.0 * np.pi * pc.H * pc.C ** 2
    C2 = pc.H * pc.C / pc.K_B
    with np.errstate(divide="ignore"):
        Tb = C2 / (lam * np.log1p(C1 / (np.maximum(fup, 1e-30) * lam ** 5)))
    assert np.all(Tb[ir] > 500.0) and np.all(Tb[ir] < 3500.0)
