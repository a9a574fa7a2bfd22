"""Cloud decks and the geometric zenith-angle correction of the port
(helios_tpu_torch.clouds and .tools, ops.twostream.g0_total, the cloud and
mu_weights branches of .forward and .fastpath, the cloud fields of
.pipeline.collect_result) against the JAX package on the CPU.

The Mie inputs are synthesized: two LX-Mie directories over the 51 radii
of R_VALUES_MICRON, as tests/test_clouds.py:74-90 builds one, and a cloud
mixing-ratio file.  Two decks are stacked, so the accumulation over decks
is exercised.

Tolerances.  The cloud preprocessing is numpy in both packages and is held
bit for bit.  Cells, the direct beam and the flux solves are held as in
tests/test_torch_forward.py (rtol 1e-12 against the JAX package's native
fp64 Planck lookup, plus stated multiples of eps of an array's scale where
last-bit differences of exp/pow are amplified).  The zenith-corrected beam
sums its exponent in another order (one matrix product here, XLA's
broadcast-multiply reduction there); it is held at rtol 1e-12 as well.
The isothermal run to convergence stops inside its criterion, so its final
T is held to 1e-8 (ROADMAP C, iso bounds); files print "%g" and are
compared number by number (tests/torch_port_helpers.assert_same_files).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import clouds as jclouds
from helios_tpu import forward as jf
from helios_tpu import grid as jgrid
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.ops import interp as jinterp
from helios_tpu.ops import twostream as jts
from helios_tpu_torch import clouds as tclouds
from helios_tpu_torch import convert
from helios_tpu_torch import fastpath as tfp
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.ops import interp as tinterp
from helios_tpu_torch.ops import twostream as tts

import torch_port_helpers as H

# the small run's grid with the flagship's star and orbit, the beam on
HOT = dict(H.SMALL_RUN, R_star=0.805, T_star=5040.0, a=0.03142,
           direct_beam="yes", surf_albedo=0.3)
ZENITH = {"plain": 45.0, "geometric": 80.0}   # geom_zenith_corr off / on


def write_mie_dir(path, scale, g_max):
    """A synthetic LX-Mie directory: cross sections ~ r^2 with a
    Rayleigh-like fall-off, one file per radius of R_VALUES_MICRON."""
    os.makedirs(path, exist_ok=True)
    lam_um = np.geomspace(0.3, 30.0, 50)
    for r in tclouds.R_VALUES_MICRON:
        x = 2 * np.pi * r / lam_um
        scat = scale * r ** 2 * np.minimum(x ** 4, 2.0)
        absx = scale * r ** 2 * np.minimum(x, 1.0)
        g0 = np.clip(g_max * np.minimum(x, 1.0), 0, 1)
        with open(os.path.join(path, "r{:.6f}.dat".format(r)), "w") as f:
            f.write("# lam c2 c3 scat abs c5 g0\n")
            for i in range(len(lam_um)):
                f.write(f"{lam_um[i]:.6e} 0 0 {scat[i]:.6e} {absx[i]:.6e} "
                        f"0 {g0[i]:.6e}\n")
    return path


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """Config fields of two cloud decks, per mixing-ratio source."""
    d = tmp_path_factory.mktemp("clouds")
    mie = [write_mie_dir(str(d / "deckA"), 1e-8, 0.9),
           write_mie_dir(str(d / "deckB"), 3e-9, 0.6)]
    p = np.geomspace(1e2, 1e10, 30)
    cloud_file = str(d / "cloud_file.txt")
    with open(cloud_file, "w") as f:
        f.write("# cloud mixing ratios\n")
        f.write("Pressure deckA deckB\n")
        for pi in p:
            f.write(f"{pi:.6e} {2e-19 * (pi / 1e7) ** 0.5:.6e} "
                    f"{5e-20 * np.exp(-(np.log10(pi) - 5.0) ** 2):.6e}\n")
    common = dict(nr_cloud_decks=2, mie_dirs=mie,
                  cloud_radius_mode=[1.0, 5.0],
                  cloud_radius_geo_std=[1.5, 2.0])
    return {
        "manual": dict(common, cloud_mixing_ratio_source="manual",
                       cloud_bottom_pressure=[1e7, 1e6],
                       cloud_bottom_mixing_ratio=[2e-19, 5e-20],
                       cloud_to_gas_scale_height=[0.8, 1.5]),
        "file": dict(common, cloud_mixing_ratio_source="file",
                     cloud_file=cloud_file, aerosol_names=["deckA",
                                                           "deckB"]),
    }


# --------------------------------------------------------------------------- #
# host preprocessing
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("iso", [0, 1])
@pytest.mark.parametrize("source", ["manual", "file"])
def test_cloud_pre_processing_matches_jax_bitwise(decks, source, iso):
    """Every field of the accumulated decks equals the JAX package's bit
    for bit (numpy in both, the port's copies of clouds.py and tools.py)."""
    kw = dict(H.SMALL_RUN, **decks[source])
    table = H.small_table()
    jc, tc = JaxConfig(**kw).finalize(), TorchConfig(**kw).finalize()
    g = jgrid.build_grid(jc.p_boa, jc.p_toa, jc.nlayer, jc.g)
    want = jclouds.cloud_pre_processing(jc, table.wave_centers,
                                        table.wave_edges, g.p_lay, g.p_int,
                                        iso)
    got = tclouds.cloud_pre_processing(tc, table.wave_centers,
                                       table.wave_edges, g.p_lay, g.p_int,
                                       iso)
    for name in want.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert np.any(got.abs_cross_lay > 0) and np.any(got.g_0_lay > 0)
    assert np.any(got.scat_cross_int > 0) == (iso == 0)


def test_g0_total_matches():
    rng = np.random.default_rng(8)
    scat = rng.uniform(1e-30, 1e-26, (13, 65))
    g0c = rng.uniform(0.0, 0.95, (13, 65))
    scatc = rng.uniform(0.0, 1e-24, (13, 65))
    want = jts.g0_total(jnp.asarray(scat), jnp.asarray(g0c),
                        jnp.asarray(scatc), 0.1)
    got = tts.g0_total(torch.tensor(scat), torch.tensor(g0c),
                       torch.tensor(scatc), 0.1)
    H.assert_close(got.numpy(), want, rtol=1e-15)


# --------------------------------------------------------------------------- #
# cells, beam and flux solves
# --------------------------------------------------------------------------- #

def _models(kw, table=None):
    """(jphys, JAX arrays with native fp64 Planck lookups, tphys, the same
    arrays converted to the port's, the port's own arrays)."""
    table = H.small_table() if table is None else table
    jphys, jarr, _ = jax_pipeline.prepare_model(JaxConfig(**kw).finalize(),
                                                table)
    tphys, tarr, _ = torch_pipeline.prepare_model(
        TorchConfig(**kw).finalize(), table, device="cpu")
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    conv = convert.model_arrays_from_numpy(d, device="cpu")
    return jphys, H.native_planck(jax.block_until_ready(jarr)), tphys, conv, \
        tarr


@pytest.fixture(scope="module", params=[(iso, z) for iso in ("yes", "no")
                                        for z in sorted(ZENITH)],
                ids=lambda p: f"iso_{p[0]}-{p[1]}")
def cloudy(request, decks):
    iso, zenith = request.param
    return _models(dict(HOT, **decks["manual"], iso_input=iso,
                        zenith_angle_deg=ZENITH[zenith]))


def test_prepare_model_matches(cloudy):
    """The port's own model of a cloudy config equals JAX's: the cloud
    arrays bit for bit, the Planck table to 1e-13 of each row's largest
    value, every other field at 1e-12."""
    jphys, jarr, tphys, _, tarr = cloudy
    assert (tphys.clouds, tphys.geom_zenith_corr) == (
        jphys.clouds, jphys.geom_zenith_corr)
    for name in tf.ModelArrays._fields:
        want = np.asarray(getattr(jarr, name))
        got = getattr(tarr, name).numpy()
        if "cloud" in name:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name == "planck_grid":
            row = np.abs(want).max(axis=1, keepdims=True)
            assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want)
                          + 1e-13 * row + H.TINY), name
        else:
            H.assert_close(got, want, rtol=1e-12, err_msg=name)


def test_compute_cells_with_clouds_match(cloudy):
    """Cells (g0 from g0_total), the direct beam with and without the
    zenith correction, and the coefficient cache from identical arrays."""
    jphys, jarr, tphys, tarr, _ = cloudy
    T = H.start_profile(jphys.nlayer)
    Tj = jnp.asarray(T)
    want = jax.jit(lambda t: jf.compute_cells(
        jphys, jarr, t, jinterp.interface_temperatures(t)))(Tj)
    Tt = torch.tensor(T)
    got = tf.compute_cells(tphys, tarr, Tt,
                           tinterp.interface_temperatures(Tt))
    for name in ("opac_lay", "meanmolmass_lay", "scat_cross_lay", "z_lay",
                 "scat_trigger"):
        H.assert_close(getattr(got, name).numpy(), getattr(want, name),
                       rtol=1e-12, err_msg=name)
    halves = ("cells_or_upper",) if jphys.iso else ("cells_or_upper",
                                                     "lower")
    for half in halves:
        for f in tfp.FlatCells._fields:
            H.assert_close(getattr(getattr(got, half), f).numpy(),
                           getattr(getattr(want, half), f), rtol=1e-12,
                           scale_atol=1e-14, err_msg=f"{half}.{f}")
    g0 = got.cells_or_upper.g0.numpy()
    assert np.any(g0 != jphys.g_0), "the clouds did not change g0"
    # XLA's exp returns 0 for some results near 1e-302 that PyTorch's
    # keeps: 1e-14 of the array's scale covers those elements
    for name in ("F_dir", "Fc_dir"):
        H.assert_close(getattr(got, name).numpy(), getattr(want, name),
                       rtol=1e-12, scale_atol=1e-14, err_msg=name)
    assert np.any(np.asarray(want.F_dir) != 0)
    G = max(np.abs(np.asarray(getattr(want, h).G_pl)).max()
            + np.abs(np.asarray(getattr(want, h).G_min)).max()
            for h in halves)
    beam_term = float(np.abs(np.asarray(want.F_dir)).max()) * G / abs(
        jphys.mu_star)
    fields = (tfp.IsoCoeffCache if jphys.iso else tfp.NonIsoCoeffCache
              )._fields
    for f in fields:
        w = np.asarray(getattr(want.coeff, f))
        atol = (1e-14 * beam_term if f.startswith(("D_", "dir_"))
                else 1e-11 * float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got.coeff, f).numpy(), w,
                                   rtol=1e-12, atol=atol + H.TINY,
                                   err_msg=f"coeff.{f}")


# a translucent atmosphere (0.1 bar at the bottom, the gas opacity 1e-6
# of the small table's, denser decks): every layer transmits, so the
# matrix method's unpivoted elimination is well conditioned (see
# test_cloudy_matrix_in_opaque_columns_within_the_reference_sensitivity)
TRANSLUCENT = dict(p_boa=1e5, cloud_bottom_pressure=[5e4, 1e4],
                   cloud_bottom_mixing_ratio=[2e-17, 5e-18])


def translucent_table():
    table = H.small_table()
    table.kpoints *= 1e-6
    return table


@pytest.mark.parametrize("iso", ["yes", "no"])
@pytest.mark.parametrize("method", ["iteration", "matrix"])
def test_cloudy_forward_solve_matches(decks, method, iso):
    """One forward solve with two cloud decks, scattering and the
    zenith-corrected beam, by the iterative and by the matrix method
    (albedo 0.3, ROADMAP C): the totals at 1e-12, the net flux at 1e-12
    of the flux scale."""
    jphys, jarr, tphys, tarr, _ = _models(dict(
        HOT, **dict(decks["manual"], **TRANSLUCENT), iso_input=iso,
        zenith_angle_deg=ZENITH["geometric"], flux_calc_method=method),
        translucent_table())
    assert jphys.geom_zenith_corr == 1 and jphys.clouds == 1
    T = H.start_profile(jphys.nlayer)
    want = jax.jit(lambda t: jf.forward_fluxes(jphys, jarr, t)[1:])(
        jnp.asarray(T))
    got = tf.forward_fluxes(tphys, tarr, torch.tensor(T))[1:]
    (totals, cache), (wtotals, wcache) = got, want
    assert np.any(np.asarray(wcache.cells_or_upper.g0) != jphys.g_0)
    for f in ("F_up_tot", "F_down_tot"):
        H.assert_close(getattr(totals, f).numpy(), getattr(wtotals, f),
                       rtol=1e-12, err_msg=f)
    scale = float(np.abs(np.asarray(wtotals.F_up_tot)).max())
    np.testing.assert_allclose(totals.F_net.numpy(),
                               np.asarray(wtotals.F_net), rtol=1e-12,
                               atol=1e-12 * scale)


def test_cloudy_matrix_in_opaque_columns_within_the_reference_sensitivity(
        decks):
    """The matrix method at the small run's full depth (10 kbar), where
    columns opaque from top to bottom (transmission 0 in every layer, w0
    ~1e-6) have cloud layers that switch the matrix on: the unpivoted
    elimination divides by pivots ~ zeta_-/zeta_+, and the JAX package's
    own F_down moves by ~6e-5 of the column's scale when M of the upper
    half layers changes by one ulp.  The port, from the same cells, is held
    to 10 times that sensitivity (ROADMAP C); F_up, which the elimination
    does not divide, to 1e-12 of the column's scale."""
    jphys, jarr, tphys, tarr, _ = _models(dict(
        HOT, **decks["manual"], zenith_angle_deg=ZENITH["geometric"],
        flux_calc_method="matrix"))
    T = H.start_profile(jphys.nlayer)
    Tj = jnp.asarray(T)
    solve = jax.jit(lambda c, t: jf.solve_fluxes(
        jphys, jarr, c, t, jf.init_flux_state(jphys, jnp.float64)))
    cells = jax.jit(lambda t: jf.compute_cells(
        jphys, jarr, t, jinterp.interface_temperatures(t)))(Tj)
    want = solve(cells, Tj)
    up = cells.cells_or_upper
    nudged = solve(cells._replace(cells_or_upper=up._replace(
        M=up.M * (1.0 + 2.0 ** -52))), Tj)

    Tt = torch.tensor(T)
    mine = tf.compute_cells(tphys, tarr, Tt,
                            tinterp.interface_temperatures(Tt))
    flat = lambda c: tfp.FlatCells(*(torch.tensor(np.asarray(x)) for x in c))
    same = mine._replace(
        cells_or_upper=flat(cells.cells_or_upper), lower=flat(cells.lower),
        F_dir=torch.tensor(np.asarray(cells.F_dir)),
        Fc_dir=torch.tensor(np.asarray(cells.Fc_dir)),
        scat_trigger=torch.tensor(np.asarray(cells.scat_trigger)))
    got = tf.solve_fluxes(tphys, tarr, same, Tt,
                          tf.init_flux_state(tphys, torch.float64, "cpu"))

    def of_column(a, b):
        b = np.asarray(b)
        return float((np.abs(np.asarray(a) - b)
                      / np.abs(b).max(axis=0)).max())
    sensitivity = of_column(nudged.F_down, want.F_down)
    assert sensitivity > 1e-8, "no opaque column switched to the matrix"
    assert of_column(got.F_down.numpy(), want.F_down) <= 10 * sensitivity
    assert of_column(got.F_up.numpy(), want.F_up) <= 1e-12


# --------------------------------------------------------------------------- #
# runs
# --------------------------------------------------------------------------- #

CLOUD_FILES = ("cloud_mixing_ratio", "cloud_opacities", "cloud_optdepth",
               "cloud_scat_cross_sect")


def _start_file(tmp_path, nlayer):
    """A non-isothermal start profile as a "helios" TP file: from an
    isothermal one, F_net is rounding residue in the opaque deep layers,
    and the step's |F_net|^0.1 amplifies it."""
    path = tmp_path / "start_tp.dat"
    H.write_tp_file(path, H.start_profile(nlayer))
    return dict(force_start_tp_from_file="yes", temp_format="helios",
                temp_path=str(path))


def test_cloudy_rce_run_matches_jax(tmp_path, monkeypatch, decks):
    """A small isothermal cloudy RCE run with the zenith-corrected beam to
    convergence, with the output files: the final T within 1e-8 of the
    native-fp64-Planck JAX run (each stops inside its criterion; 3.6e-9
    measured), every RunResult field within 1e-6 (a Planck value in the
    Wien tail moves by hc/(lambda k T) ~ 40 times T's relative change:
    1.3e-7 measured; the net fluxes 4e-8 of the flux scale), the same
    file set, and the four cloud files number by number."""
    kw = dict(HOT, **decks["file"], **_start_file(tmp_path, 12), name="cl",
              iso_input="yes", convection="no",
              zenith_angle_deg=ZENITH["geometric"])
    table = H.small_table()
    got = torch_pipeline.run(
        TorchConfig(**kw, output_dir=str(tmp_path / "torch") + "/"),
        table, write_output=True, device="cpu")
    assert got.phys.clouds == 1 and got.phys.geom_zenith_corr == 1
    assert not bool(got.rad.keep_running) and not got.rad.aborted
    H.native_build(monkeypatch)
    native = jax_pipeline.run(
        JaxConfig(**kw, output_dir=str(tmp_path / "jax") + "/"),
        table=table, write_output=True)
    assert not bool(native.rad.aborted)
    np.testing.assert_allclose(got.result.T_lay, native.result.T_lay,
                               rtol=1e-8)
    H.assert_same_results(got.result, native.result, rtol=1e-6,
                          scale_atol=1e-10, net_atol=4e-8)
    files = sorted(os.listdir(tmp_path / "torch" / "cl"))
    assert files == sorted(os.listdir(tmp_path / "jax" / "cl"))
    for name in CLOUD_FILES:
        assert f"cl_{name}.dat" in files, name
    H.assert_same_files(tmp_path / "torch" / "cl", tmp_path / "jax" / "cl",
                        names=[f"cl_{name}.dat" for name in CLOUD_FILES])


def test_cloudy_noniso_steps_match_jax(tmp_path, monkeypatch, decks):
    """Thirty radiation iterations of the small non-isothermal run with
    two cloud decks and the zenith-corrected beam (the iteration cap stops
    both runs there): T at 1e-10, and every RunResult field, the cloud
    fields and g_0_tot_lay of the upper half layers among them, at 1e-10
    plus 1e-12 of each array's scale."""
    kw = dict(HOT, **decks["manual"], **_start_file(tmp_path, 12),
              convection="no",
              zenith_angle_deg=ZENITH["geometric"], max_nr_iterations=30)
    table = H.small_table()
    got = torch_pipeline.run(TorchConfig(**kw), table, write_output=False,
                             device="cpu")
    assert got.rad.it == 31 and got.rad.aborted
    H.native_build(monkeypatch)
    native = jax_pipeline.run(JaxConfig(**kw), table=table,
                              write_output=False)
    assert int(native.rad.it) == 31
    assert got.result.g_0_tot_lay.shape == (12, 65)
    assert np.any(got.result.g_0_tot_lay != got.phys.g_0)
    H.assert_same_results(got.result, native.result, rtol=1e-10,
                          scale_atol=1e-12, net_atol=1e-10)
