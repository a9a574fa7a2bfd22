"""Solid surfaces and physical timestepping in the port (BASELINE config 5:
the surface albedo from a file, the Koll f-factor of a rocky planet, the
bare rock of planet_type="no_atmosphere", additional heating and the
physical timestep; helios_tpu_torch.pipeline.prepare_model,
forward.build_model, rce.radiative and rce.loop) against the JAX package
on the CPU, in the scenarios of tests/test_surface_modes.py.

Tolerances.  Host inputs (albedo, heating density, f-factor) are numpy in
both packages and are held bit for bit or to 1e-14.  A step from identical
model arrays and a non-isothermal profile is held to 1e-14, a fixed count
of physical timesteps to 1e-10 and runs to convergence, which stop inside
their criterion, to 1e-8 (ROADMAP C), all against the JAX package's native
fp64 Planck lookup (tests/test_torch_forward.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import host_physics as jhp
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import synthetic_premixed_table
from helios_tpu.ops import interp as jinterp
from helios_tpu.rce import radiative as jrad
from helios_tpu_torch import convert
from helios_tpu_torch import forward as tf
from helios_tpu_torch import grid as grid_mod
from helios_tpu_torch import host_physics as thp
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.ops import interp as tinterp
from helios_tpu_torch.rce import radiative as trad

import torch_port_helpers as H

# tests/test_surface_modes.py:19-33
BASE = dict(name="surf", planet="manual", g=981.0, a=0.05, R_planet=0.09,
            R_star=0.5, T_star=3500.0, T_intern=30.0, scattering="no",
            direct_beam="no", convection="no", run_type="iterative",
            iso_input="yes", nlayer=10, p_boa=1e6, p_toa=1e2,
            rad_convergence_limit=1e-5)


@pytest.fixture(scope="module")
def table():
    return synthetic_premixed_table(nbin=12, ny=4, ntemp=10, npress=8,
                                    seed=6)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The albedo and heating files of tests/test_surface_modes.py:66-80
    and :117-126, and a super-adiabatic start profile of 10 layers."""
    d = tmp_path_factory.mktemp("surface_inputs")
    albedo = str(d / "albedo.dat")
    lam_um = np.geomspace(0.3, 400.0, 30)
    alb = 0.2 + 0.5 * np.exp(-((np.log10(lam_um) - 0.5) / 0.3) ** 2)
    with open(albedo, "w") as f:
        f.write("# header\n# header2\n")
        f.write("Wavelength Feldspathic\n")
        for lam, a in zip(lam_um, alb):
            f.write(f"{lam:.6e} {a:.6e}\n")
    heating = str(d / "heat.dat")
    p = np.geomspace(1e2, 1e6, 20)
    heat = np.where((p > 1e3) & (p < 1e5), 2e-2, 0.0)
    with open(heating, "w") as f:
        f.write("# header\n# header2\n")
        f.write("Pressure heating\n")
        for pi, hi in zip(p, heat):
            f.write(f"{pi:.6e} {hi:.6e}\n")
    start = d / "start_tp.dat"
    p_lay = grid_mod.build_grid(BASE["p_boa"], BASE["p_toa"],
                                BASE["nlayer"], BASE["g"]).p_lay
    T = 2500.0 * (p_lay / p_lay[0]) ** 0.35     # dlnT/dlnp above kappa
    H.write_tp_file(start, np.append(T, T[0]))
    return dict(
        albedo=dict(surf_albedo="file", albedo_file=albedo,
                    albedo_file_header_lines=2),
        heating=dict(add_heating="yes", add_heating_path=heating,
                     add_heating_file_header_lines=2),
        start=dict(force_start_tp_from_file="yes", temp_format="helios",
                   temp_path=str(start)))


def _run_pair(tmp_path, monkeypatch, table, kw, write_output=False):
    """The port's run and the native-fp64-Planck JAX run of one config,
    each writing into its own directory."""
    got = torch_pipeline.run(
        TorchConfig(**kw, output_dir=str(tmp_path / "torch") + "/"),
        table, write_output=write_output, device="cpu")
    H.native_build(monkeypatch)
    want = jax_pipeline.run(
        JaxConfig(**kw, output_dir=str(tmp_path / "jax") + "/"),
        table=table, write_output=write_output)
    return got, want


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #

def test_albedo_file_matches_jax(table, inputs):
    """The albedo file gives the JAX loader's array bit for bit, and the
    model stores it."""
    kw = dict(BASE, planet_type="rocky", **inputs["albedo"])
    want = jhp.load_surf_albedo(JaxConfig(**kw).finalize(),
                                table.wave_centers)
    cfg = TorchConfig(**kw).finalize()
    got = thp.load_surf_albedo(cfg, table.wave_centers)
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0.15 and got.max() < 0.75
    _, arrays, _ = torch_pipeline.prepare_model(cfg, table, device="cpu")
    np.testing.assert_array_equal(arrays.surf_albedo.numpy(), want)


def test_heating_density_and_flux_match_jax(table, inputs):
    """The heating density from the file equals JAX's bit for bit, and the
    cell refresh turns it into F_add_heat_lay / F_add_heat_sum at 1e-12 on
    the same profile."""
    kw = dict(BASE, **inputs["heating"])
    jphys, jarr, _ = jax_pipeline.prepare_model(JaxConfig(**kw).finalize(),
                                                table)
    tphys, tarr, _ = torch_pipeline.prepare_model(
        TorchConfig(**kw).finalize(), table, device="cpu")
    np.testing.assert_array_equal(tarr.add_heat_dens.numpy(),
                                  np.asarray(jarr.add_heat_dens))
    assert np.asarray(jarr.add_heat_dens).max() > 0
    T = H.start_profile(jphys.nlayer)
    want = jax.jit(lambda t: jax_pipeline.compute_cells(
        jphys, H.native_planck(jarr), t,
        jinterp.interface_temperatures(t)))(jnp.asarray(T))
    Tt = torch.tensor(T)
    got = tf.compute_cells(tphys, tarr, Tt,
                           tinterp.interface_temperatures(Tt))
    for name in ("F_add_heat_lay", "F_add_heat_sum"):
        H.assert_close(getattr(got, name).numpy(), getattr(want, name),
                       rtol=1e-12, err_msg=name)


# --------------------------------------------------------------------------- #
# runs
# --------------------------------------------------------------------------- #

def test_additional_heating_run_matches_jax(tmp_path, monkeypatch, table,
                                            inputs):
    """tests/test_surface_modes.py:117-137 against JAX: the heated layers
    warm by more than 5 K, and the converged T is within 1e-8 of JAX's."""
    got, want = _run_pair(tmp_path, monkeypatch, table,
                          dict(BASE, name="heat", **inputs["heating"]))
    assert not got.rad.aborted
    np.testing.assert_allclose(got.result.T_lay, want.result.T_lay,
                               rtol=1e-8)
    H.assert_close(got.result.F_add_heat_sum, want.result.F_add_heat_sum,
                   rtol=1e-8)
    cold = torch_pipeline.run(TorchConfig(**BASE), table, write_output=False,
                              device="cpu")
    heated = (got.result.p_lay > 1e3) & (got.result.p_lay < 1e5)
    assert (got.result.T_lay[:-1] - cold.result.T_lay[:-1])[heated].max() > 5


def test_rocky_approx_f_run_matches_jax(tmp_path, monkeypatch, table,
                                        inputs):
    """A rocky planet with the Koll f-factor and the albedo file, run
    twice (the second run reads tau_lw from the first one's file): the
    f-factors equal JAX's to 1e-14, and the tau_lw / tau_sw / f-factor
    files hold the same numbers."""
    kw = dict(BASE, planet_type="rocky", approx_f="yes", **inputs["albedo"])
    tau_file = "surf_tau_lw_tau_sw_f_factor.dat"
    for _ in range(2):
        got, want = _run_pair(tmp_path, monkeypatch, table, kw,
                              write_output=True)
        assert 0.25 < got.phys.f_factor < 2.0 / 3.0
        assert got.phys.f_factor == pytest.approx(want.phys.f_factor,
                                                  rel=1e-14, abs=0)
        np.testing.assert_allclose(got.result.T_lay, want.result.T_lay,
                                   rtol=1e-8)
        H.assert_same_files(tmp_path / "torch" / "surf",
                            tmp_path / "jax" / "surf", names=[tau_file])
        monkeypatch.undo()
    tau_lw = thp.read_tau_lw_from_file(str(tmp_path / "torch") + "/", "surf")
    assert tau_lw == pytest.approx(jhp.read_tau_lw_from_file(
        str(tmp_path / "jax") + "/", "surf"), rel=1e-5)


def test_bare_rock_matches_jax(tmp_path, monkeypatch, table):
    """tests/test_surface_modes.py:87-100: two layers at 1.001 K above a
    surface within 1e-10 of JAX's and within 0.5% of the analytic
    f^(1/4) (R*/a)^(1/2) T*."""
    kw = dict(BASE, name="rock", planet_type="no_atmosphere",
              surf_albedo=0.1, T_intern=0.0, f_factor=0.6667,
              rad_convergence_limit=1e-6)
    got, want = _run_pair(tmp_path, monkeypatch, table, kw)
    assert got.phys.no_atmo == 1 and got.phys.nlayer == 2
    T = got.result.T_lay
    assert np.all(T[:2] == 1.001)
    assert got.rad.it == int(want.rad.it)
    np.testing.assert_allclose(T[2], want.result.T_lay[2], rtol=1e-10)
    T_eq = 0.6667 ** 0.25 * (got.phys.R_star / got.phys.a) ** 0.5 * 3500.0
    assert T[2] == pytest.approx(T_eq, rel=0.005)


def test_physical_timestep_runs_the_fixed_steps_as_jax(tmp_path,
                                                       monkeypatch, table):
    """tests/test_surface_modes.py:103-114: runtime_limit / physical_tstep
    = 20 radiation iterations, and the final T within 1e-10 of JAX's (the
    count is fixed, so nothing chaotic)."""
    kw = dict(BASE, name="tstep", convection="yes", iso_input="automatic",
              physical_tstep=1000.0, runtime_limit=20000.0, T_intern=100.0)
    got, want = _run_pair(tmp_path, monkeypatch, table, kw)
    assert got.rad.it == int(want.rad.it) == 20
    assert np.all(np.isfinite(got.result.T_lay))
    np.testing.assert_allclose(got.result.T_lay, want.result.T_lay,
                               rtol=1e-10)


def test_one_physical_timestep_matches_jax(table, inputs):
    """One physical timestep (c_p from kappa, heating on, non-isothermal
    layers) from identical model arrays and a non-isothermal profile: T at
    1e-14 (3.6e-16 measured)."""
    kw = dict(BASE, convection="yes", iso_input="no", physical_tstep=500.0,
              runtime_limit=1e5, **inputs["heating"])
    jphys, jarr, _ = jax_pipeline.prepare_model(JaxConfig(**kw).finalize(),
                                                table)
    jarr = H.native_planck(jarr)
    tphys = tf.Phys.from_config(TorchConfig(**kw).finalize(), nbin=12, ny=4)
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    tarr = convert.model_arrays_from_numpy(d, device="cpu")
    T0 = H.start_profile(jphys.nlayer)
    want = jax.jit(lambda t: jrad.radiation_loop(
        jphys, jarr, jrad.make_const_thermo(0.25), t, max_steps=1))(
            jnp.asarray(T0))
    got = trad.radiation_loop(tphys, tarr, trad.make_const_thermo(0.25),
                              torch.tensor(T0), max_steps=1)
    assert got.it == int(want.it) == 1
    assert np.any(got.T_lay.numpy() != T0)
    H.assert_close(got.T_lay.numpy(), want.T_lay, rtol=1e-14)


def test_rocky_config5_run_matches_jax(tmp_path, monkeypatch, table,
                                       inputs):
    """BASELINE config 5 at the small size: a rocky planet with the albedo
    file, the Koll f-factor, additional heating and a physical timestep,
    non-isothermal layers from a super-adiabatic start, convection on:
    exactly runtime_limit / physical_tstep radiation iterations, then one
    convective adjustment and flux solve (computation.py:1109-1111); the
    final T within 1e-10 of JAX's, and the tau file the same."""
    kw = dict(BASE, name="c5", planet_type="rocky", approx_f="yes",
              convection="yes", iso_input="no", physical_tstep=100.0,
              runtime_limit=1500.0, T_intern=100.0, **inputs["albedo"],
              **inputs["heating"], **inputs["start"])
    got, want = _run_pair(tmp_path, monkeypatch, table, kw,
                          write_output=True)
    assert got.rad.it == int(want.rad.it) == 15
    assert got.conv is not None and got.conv.steps == 1
    assert got.n_flux_solves == 16
    assert np.all(np.isfinite(got.result.T_lay))
    np.testing.assert_allclose(got.result.T_lay, want.result.T_lay,
                               rtol=1e-10)
    assert got.phys.f_factor == pytest.approx(want.phys.f_factor,
                                              rel=1e-14, abs=0)
    H.assert_same_files(tmp_path / "torch" / "c5", tmp_path / "jax" / "c5",
                        names=["c5_tau_lw_tau_sw_f_factor.dat"])
