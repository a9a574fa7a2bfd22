"""Tabulated thermodynamics in the PyTorch port (helios_tpu_torch.thermo,
the table interpolations of .ops.interp, the table branches of
.rce.radiative and the entropy / water-phase diagnostics of .pipeline)
against the JAX package on the CPU.

Tolerances.  The loader is numpy in both packages: equal arrays.  The
interpolations are the same bilinear expressions on the same tables:
rtol 1e-12 (the log10 of XLA and PyTorch may differ in the last bit).  The
runs are the isothermal scenarios of tests/test_thermo.py (10 layers, 16
bins x 4), to convergence, against the JAX run with native fp64 Planck
lookups (ROADMAP C, iso runs): the final T at rtol 1e-8, where each run
stops inside its flux criterion; entropy and phase are interpolated at
that T, so they carry its difference times the table's slope: rtol 1e-7
(entropy: log-log, phase: linear in T).  The files print "%g": compared
number by number at rtol 1e-5 plus 1e-9 of each column's largest value.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helios_tpu import pipeline as jax_pipeline
from helios_tpu import thermo as jthermo
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import synthetic_premixed_table
from helios_tpu.ops import interp as jinterp
from helios_tpu.rce import radiative as jrad
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch import thermo as tthermo
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.ops import interp as tinterp
from helios_tpu_torch.rce import radiative as trad

import torch_port_helpers as H
from test_thermo import _grids, write_standard_table, write_water_table

# query points inside and outside both table axes (the clamps)
T_Q = np.asarray([150.0, 500.0, 1234.5, 2999.0, 50.0, 4000.0, 100.0])
P_Q = np.geomspace(5e1, 5e9, 7)


@pytest.fixture
def tables(tmp_path, rng):
    kappa, cp, logS, phase = _grids(rng)
    std = str(tmp_path / "delad.dat")
    water = str(tmp_path / "water.dat")
    noent = str(tmp_path / "noent.dat")
    write_standard_table(std, kappa, cp, logS,
                         shuffle=np.random.default_rng(7))
    write_water_table(water, kappa, cp, logS, phase)
    write_standard_table(noent, kappa, cp, logS, with_entropy=False)
    return {"file": std, "water_atmo": water, "noent": noent}


@pytest.mark.parametrize("which", ["file", "water_atmo", "noent"])
def test_loader_gives_the_arrays_of_jax(tables, which):
    fmt = "water_atmo" if which == "water_atmo" else "file"
    got = tthermo.load_entropy_table(tables[which], fmt)
    want = jthermo.load_entropy_table(tables[which], fmt)
    assert got._fields == want._fields
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_loader_refuses_an_incomplete_grid(tables, tmp_path):
    with open(tables["file"]) as f:
        lines = f.read().splitlines()
    bad = tmp_path / "bad.dat"
    bad.write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="do not fill"):
        tthermo.load_entropy_table(str(bad), "file")


def test_interpolations_and_table_branches_match_jax(tables):
    """The four interpolations and kappa_cp_lay / kappa_int of a table
    ThermoProps, at points inside and outside the table: rtol 1e-12."""
    tbl = jthermo.load_entropy_table(tables["water_atmo"], "water_atmo")
    jth = jrad.make_table_thermo(tbl)
    tth = trad.make_table_thermo(tthermo.load_entropy_table(
        tables["water_atmo"], "water_atmo"), device="cpu")
    assert tth.from_table == 1 and tth.has_phase == 1
    jT, jp = jnp.asarray(T_Q), jnp.asarray(P_Q)
    tT, tp = torch.tensor(T_Q), torch.tensor(P_Q)
    for name, table in (("kappa", "kappa_table"), ("cp", "cp_table"),
                        ("entropy", "entropy_table"),
                        ("phase_number", "phase_table")):
        fn = f"interpolate_{name}"
        want = getattr(jinterp, fn)(getattr(jth, table), jth.temps,
                                    jth.press, jT, jp)
        got = getattr(tinterp, fn)(getattr(tth, table), tth.temps,
                                   tth.press, tT, tp)
        H.assert_close(got.numpy(), want, rtol=1e-12, err_msg=name)

    L = len(T_Q) - 1       # kappa_cp_lay reads T_lay[:L] (ghost layer)
    want_k, want_cp = jrad.kappa_cp_lay(jth, jT, jp[:L])
    got_k, got_cp = trad.kappa_cp_lay(tth, tT, tp[:L])
    H.assert_close(got_k.numpy(), want_k, rtol=1e-12)
    H.assert_close(got_cp.numpy(), want_cp, rtol=1e-12)
    H.assert_close(trad.kappa_int(tth, tT, tp).numpy(),
                   jrad.kappa_int(jth, jT, jp), rtol=1e-12)


def test_cp_and_entropy_interpolate_in_log_temperature():
    """c_p and entropy take their T step in log10 T (kernels.cu:777-779),
    kappa in linear T: on a grid uniform in log10 T, a quantity linear in
    log10 T is interpolated exactly in log T and not in linear T."""
    temps = torch.logspace(2.0, 3.5, 6, dtype=torch.float64)
    press = torch.logspace(2.0, 9.0, 5, dtype=torch.float64)
    lin_in_logT = torch.log10(temps)[:, None].expand(6, 5).contiguous()
    T = torch.tensor([333.0, 2100.0], dtype=torch.float64)
    p = torch.tensor([1e4, 1e7], dtype=torch.float64)
    exact = torch.log10(T).numpy()
    for fn in (tinterp.interpolate_cp, tinterp.interpolate_entropy):
        np.testing.assert_allclose(
            fn(lin_in_logT, temps, press, T, p).numpy(), exact, rtol=1e-13)
    for fn in (tinterp.interpolate_kappa, tinterp.interpolate_phase_number):
        assert not np.allclose(fn(lin_in_logT, temps, press, T, p).numpy(),
                               exact, rtol=1e-4)


@pytest.fixture(scope="module")
def table():
    return synthetic_premixed_table(nbin=16, ny=4, ntemp=12, npress=10,
                                    seed=3)


def _cfg(tmp_path, **over):
    """The iso scenario of tests/test_thermo.py."""
    kw = dict(name="wat", output_dir=str(tmp_path) + "/",
              planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
              R_star=1.0, T_star=4000.0, T_intern=200.0,
              scattering="no", direct_beam="no", convection="no",
              run_type="iterative", iso_input="yes", nlayer=10,
              p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6)
    kw.update(over)
    return kw


@pytest.mark.parametrize("fmt", ["water_atmo", "file"])
def test_table_run_matches_jax(tmp_path, rng, table, monkeypatch, fmt):
    """The scenarios of tests/test_thermo.py (test_pipeline_water_atmo_
    outputs and test_pipeline_standard_file_no_phase) in both packages:
    final T at rtol 1e-8, entropy and phase at rtol 1e-7, the same file
    set, the entropy column of _colmass_mu_cp_kappa_entropy.dat and the
    phase file by the "%g" rule; entropy positive and phase inside the
    table's range."""
    kappa, cp, logS, phase = _grids(rng)
    path = str(tmp_path / "thermo.dat")
    if fmt == "water_atmo":
        write_water_table(path, kappa, cp, logS, phase)
    else:
        write_standard_table(path, kappa, cp, logS)
    kw = _cfg(tmp_path / "torch", kappa_value=fmt, kappa_file_path=path)
    got = torch_pipeline.run(TorchConfig(**kw), table, device="cpu")
    H.native_build(monkeypatch)
    want = jax_pipeline.run(JaxConfig(**dict(
        kw, output_dir=str(tmp_path / "jax") + "/")), table=table)

    r, w = got.result, want.result
    assert not bool(got.rad.keep_running) and not got.rad.aborted
    np.testing.assert_allclose(r.T_lay, w.T_lay, rtol=1e-8)
    assert np.all(r.entropy_lay > 0.0)
    np.testing.assert_allclose(r.entropy_lay, w.entropy_lay, rtol=1e-7)
    if fmt == "water_atmo":
        assert np.all((r.phase_number_lay >= phase.min())
                      & (r.phase_number_lay <= phase.max()))
        np.testing.assert_allclose(r.phase_number_lay, w.phase_number_lay,
                                   rtol=1e-7)
    else:
        assert r.phase_number_lay is None and w.phase_number_lay is None

    gd, wd = str(tmp_path / "torch" / "wat"), str(tmp_path / "jax" / "wat")
    assert sorted(os.listdir(gd)) == sorted(os.listdir(wd))
    assert os.path.exists(os.path.join(gd, "wat_state.dat")) == (
        fmt == "water_atmo")
    names = ["wat_colmass_mu_cp_kappa_entropy.dat"]
    if fmt == "water_atmo":
        names.append("wat_state.dat")
    H.assert_same_files(gd, wd, names=names)


def test_convection_with_a_table_matches_jax(tmp_path, rng):
    """The convection loop with kappa and c_p from a water_atmo table
    (kappa 0.07-0.1, so that the small scenario convects as with its
    constant 0.1; kappa feeds the instability check, the adjustment and
    the marks, c_p the adjustment), 20 steps from JAX's radiation state
    after 30 iterations of the small non-iso scenario, carried across: T
    at rtol 1e-10 (as the constant-kappa run of tests/test_torch_rce.py),
    the same convective layers."""
    import jax
    from helios_tpu import forward as jf
    from helios_tpu.rce import loop as jloop
    from helios_tpu_torch import convert
    from helios_tpu_torch import forward as tf
    from helios_tpu_torch.rce.loop import convection_loop

    kappa, cp, logS, phase = _grids(rng)
    path = str(tmp_path / "water.dat")
    write_water_table(path, 0.35 * kappa, cp, logS, phase)
    cfg = dict(H.SMALL_RUN, kappa_value="water_atmo", kappa_file_path=path)
    jphys, jarr = jf.build_model(JaxConfig(**cfg).finalize(),
                                 H.small_table())
    jarr = H.native_planck(jarr)
    tphys = tf.Phys.from_config(TorchConfig(**cfg).finalize(), nbin=65, ny=4)
    tarr = convert.model_arrays_from_numpy(
        {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}, device="cpu")
    tbl = jthermo.load_entropy_table(path, "water_atmo")
    jth = jrad.make_table_thermo(tbl)
    tth = trad.make_table_thermo(tbl, device="cpu")
    rad = jax.jit(lambda t: jrad.radiation_loop(
        jphys, jarr, jth, t, max_steps=30))(
            jnp.asarray(H.start_profile(jphys.nlayer)))
    want = jax.jit(lambda r: jloop.convection_loop(
        jphys, jarr, jth, r, max_steps=20))(rad)
    got = convection_loop(
        tphys, tarr, tth,
        convert.rad_state_from_numpy(H.nested_numpy(rad), device="cpu"),
        max_steps=20)
    assert got.it == int(want.it) == 20
    assert bool(got.conv_layer.any())
    H.assert_close(got.T_lay.numpy(), want.T_lay, rtol=1e-10)
    np.testing.assert_array_equal(got.conv_layer.numpy(),
                                  np.asarray(want.conv_layer))
