"""The port's post-processing run, final-state diagnostics and output files
(helios_tpu_torch.pipeline, .ops.integrate, .io.writers) against the JAX
package on the CPU.

Tolerances.  Arrays are held to rtol 1e-12 against the JAX package's native
fp64 Planck lookup (see tests/test_torch_forward.py), with an absolute term
of a stated multiple of the array's scale where values cancel (net fluxes).
The output files print most numbers with "%g", six significant digits: a
difference of 1e-12 can still flip the last printed digit, which is up to
1e-5 of the value.  Files are therefore compared number by number at rtol
1e-5, plus 1e-9 of the largest value of the same column for values that
are residues of a cancellation; every non-numeric token must be equal.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import forward as jf
from helios_tpu import pipeline as jax_pipeline
from helios_tpu import planck as jplanck
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.ops import integrate as jint
from helios_tpu_torch import convert
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch import planck as tplanck
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.kernels.sweep import iso_sweep
from helios_tpu_torch.ops import integrate as tint

import torch_port_helpers as H

# a hot Jupiter around a real star (the flagship's star and orbit), so that
# the direct beam and the stellar mean opacities are exercised
HOT = dict(H.SMALL_RUN, R_star=0.805, T_star=5040.0, a=0.03142,
           direct_beam="yes")


def _pt_file(path, fmt):
    """The TP profile of tests/test_parity_configs.py:84-102, in the
    "PT" (pressure, temperature) or "TP" column order."""
    p = np.geomspace(1e3, 1e8, 40)
    T = 1400.0 * (p / 1e8) ** 0.12
    cols = [p, T] if fmt == "PT" else [T, p]
    np.savetxt(path, np.column_stack(cols))


# --------------------------------------------------------------------------- #
# inputs and reductions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fmt", ["PT", "TP"])
def test_load_tp_file_matches(tmp_path, fmt):
    """The "PT"/"TP" formats interpolate in log-P onto the grid exactly as
    helios_tpu does (both are numpy)."""
    path = tmp_path / "profile.dat"
    _pt_file(path, fmt)
    g = tf.grid_mod.build_grid(1e9, 1e3, 12, 2288.0)
    want = jax_pipeline.load_tp_file(str(path), fmt, 12, g.p_lay, g.p_int)
    got = torch_pipeline.load_tp_file(str(path), fmt, 12, g.p_lay, g.p_int)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (13,)


def test_dB_dT_matches():
    rng = np.random.default_rng(7)
    lam = rng.uniform(1e-5, 1e-2, 300)
    T = rng.uniform(80.0, 4000.0, 300)
    H.assert_close(tplanck.dB_dT(torch.tensor(lam), torch.tensor(T)).numpy(),
                   jplanck.dB_dT(jnp.asarray(lam), jnp.asarray(T)),
                   rtol=1e-12)


def test_band_reductions_match():
    """gauss_band and the iso / non-iso optical depth and transmission."""
    rng = np.random.default_rng(8)
    L, B, Y = 7, 9, 4
    w = rng.uniform(0.1, 1.0, Y)
    x = [rng.uniform(0.0, 3.0, (L, B, Y)) for _ in range(4)]
    t = lambda a: torch.tensor(a)
    H.assert_close(tint.gauss_band(t(x[0]), t(w)).numpy(),
                   jint.gauss_band(x[0], w), rtol=1e-12)
    for g, j in zip(tint.integrate_optdepth_transmission_iso(
            t(x[0]), t(x[1]), t(w)),
            jint.integrate_optdepth_transmission_iso(x[0], x[1], w)):
        H.assert_close(g.numpy(), j, rtol=1e-12)
    for g, j in zip(tint.integrate_optdepth_transmission_noniso(
            *(t(a) for a in x), t(w)),
            jint.integrate_optdepth_transmission_noniso(*x, w)):
        H.assert_close(g.numpy(), j, rtol=1e-12)


def test_contribution_function_matches():
    rng = np.random.default_rng(9)
    L, B, Y = 10, 6, 4
    trans = rng.uniform(0.0, 1.0, (L, B, Y))
    trans[0, 0, 0] = 0.0                     # the 1e-30 floor of the log
    planck = rng.uniform(1e3, 1e9, (L + 2, B))
    w = rng.uniform(0.1, 1.0, Y)
    got = tint.contribution_function(torch.tensor(trans),
                                     torch.tensor(planck), torch.tensor(w),
                                     0.5)
    want = jint.contribution_function(trans, planck, w, 0.5)
    for g, j in zip(got, want):
        H.assert_close(g.numpy(), j, rtol=1e-12, scale_atol=1e-15)


@pytest.mark.parametrize("T_star", [5040.0, 30.0])
def test_mean_opacities_match(T_star):
    """Planck and Rosseland means, with layers below and above 70 K, and a
    star above 70 K and below (its means are then -3)."""
    rng = np.random.default_rng(10)
    L, B, Y = 8, 12, 4
    edges = np.geomspace(3e-5, 3e-2, B + 1)
    args = dict(
        opac_wg_lay=rng.uniform(0.0, 1e2, (L, B, Y)),
        cloud_abs_cross_lay=rng.uniform(0.0, 1e-24, (L, B)),
        meanmolmass_lay=np.full(L, 2.3 * 1.66e-24),
        planckband_lay=rng.uniform(1e2, 1e9, (L + 2, B)),
        lambda_edge=edges, delta_lambda=np.diff(edges),
        T_lay=np.concatenate([[50.0], rng.uniform(200.0, 3000.0, L)]),
        gauss_weight=rng.uniform(0.1, 1.0, Y),
        gauss_y=np.sort(rng.uniform(0.0, 1.0, Y)))
    want = jint.mean_opacities(**{k: jnp.asarray(v) for k, v in
                                  args.items()}, T_star=T_star)
    got = tint.mean_opacities(**{k: torch.tensor(v) for k, v in
                                 args.items()}, T_star=T_star)
    assert sorted(got) == sorted(want)
    for k in want:
        H.assert_close(got[k].numpy(), want[k], rtol=1e-12, err_msg=k)


# --------------------------------------------------------------------------- #
# post_process from one state
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("iso", ["yes", "no"])
def test_post_process_matches(iso):
    """Every array of post_process (cell cache, totals, optical depth,
    transmission, contribution function, mean opacities, Planck rows) from
    identical model arrays, T and flux state."""
    cfg = dict(HOT, iso_input=iso)
    jphys, jarr = jf.build_model(JaxConfig(**cfg).finalize(),
                                 H.small_table())
    jarr = H.native_planck(jarr)
    tphys = tf.Phys.from_config(TorchConfig(**cfg).finalize(), nbin=65,
                                ny=4)
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    tarr = convert.model_arrays_from_numpy(d, device="cpu")
    T = H.start_profile(jphys.nlayer)
    jflux = jax.jit(lambda t: jf.forward_fluxes(jphys, jarr, t)[0])(
        jnp.asarray(T))
    want = jax.jit(lambda t, f: jax_pipeline.post_process(
        jphys, jarr, t, f, None))(jnp.asarray(T), jflux)
    got = torch_pipeline.post_process(
        tphys, tarr, torch.tensor(T),
        convert.flux_state_from_numpy(H.nested_numpy(jflux), device="cpu"))

    flat = lambda x: ({f"{k}.{kk}": vv for k, v in x.items()
                       for kk, vv in flat(v).items()}
                      if isinstance(x, dict) else
                      flat(x._asdict()) if hasattr(x, "_asdict")
                      else {"": x})
    gw, gg = flat(want), flat(got)
    assert sorted(gg) == sorted(gw)
    for k in gw:
        if k.startswith("cache.coeff."):
            # the sweep coefficient cache is held, at the tolerances its
            # cancellations need, by tests/test_torch_{forward,iso}.py
            continue
        H.assert_close(gg[k].numpy(), np.asarray(gw[k]), rtol=1e-12,
                       scale_atol=1e-14, err_msg=k)


# --------------------------------------------------------------------------- #
# whole runs and their files
# --------------------------------------------------------------------------- #

def test_postprocessing_run_matches_jax(tmp_path, monkeypatch):
    """BASELINE config 1 at the small size: a "PT" profile, post-processing
    (one solve of 1000*scat+1 = 1001 sweep passes, isothermal layers),
    direct beam on, with output files.  Against helios_tpu.pipeline.run
    with native fp64 Planck lookups: every RunResult field at 1e-12 (net
    fluxes at 1e-12 of the flux scale), the TOA spectrum at 1e-12, and
    every file write_all writes.  Against the unmodified JAX run
    (two-float32 Planck pairs, see tests/test_torch_iso.py): the TOA
    spectrum within 1e-7."""
    _pt_file(tmp_path / "profile.dat", "PT")
    kw = dict(HOT, name="c1", run_type="post-processing", temp_format="PT",
              temp_path=str(tmp_path / "profile.dat"), convection="no")
    table = H.small_table()

    before = iso_sweep.launches
    got = torch_pipeline.run(
        TorchConfig(**kw, output_dir=str(tmp_path / "torch") + "/"),
        table, write_output=True, device="cpu")
    assert iso_sweep.launches == before         # the CPU runs no kernel
    assert got.phys.singlewalk == 1 and got.phys.iso == 1
    assert got.phys.n_sweep_passes == 1001 and got.n_flux_solves == 1
    assert got.conv is None and got.rad.it == 0
    L = got.phys.nlayer
    toa = got.result.F_up_band[L]
    assert np.all(np.isfinite(toa)) and np.all(toa > 0)

    pairs = jax_pipeline.run(
        JaxConfig(**kw, output_dir=str(tmp_path / "pairs") + "/"),
        table=table, write_output=False)
    np.testing.assert_allclose(toa, pairs.result.F_up_band[L], rtol=1e-7)

    H.native_build(monkeypatch)
    native = jax_pipeline.run(
        JaxConfig(**kw, output_dir=str(tmp_path / "jax") + "/"),
        table=table, write_output=True)
    H.assert_close(toa, native.result.F_up_band[L], rtol=1e-12,
                   scale_atol=1e-14)
    H.assert_same_results(got.result, native.result, rtol=1e-12,
                        scale_atol=1e-14, net_atol=1e-12)
    H.assert_same_files(tmp_path / "torch" / "c1", tmp_path / "jax" / "c1")
    assert "c1_TOA_flux_eclipse.dat" in os.listdir(tmp_path / "torch" / "c1")


def test_small_rce_run_writes_the_files_of_jax(tmp_path, monkeypatch):
    """The small default (non-isothermal, convective) RCE run with
    write_output=True: every file against the native-fp64-Planck JAX run's
    (the final T agrees to 1e-10, tests/test_torch_rce.py)."""
    tp = tmp_path / "start_tp.dat"
    H.write_tp_file(tp, H.start_profile(12))
    kw = dict(H.SMALL_RUN, name="rce", force_start_tp_from_file="yes",
              temp_format="helios", temp_path=str(tp))
    table = H.small_table()
    got = torch_pipeline.run(
        TorchConfig(**kw, output_dir=str(tmp_path / "torch") + "/"),
        table, write_output=True, device="cpu")
    assert got.conv is not None and got.conv.steps > 0
    H.native_build(monkeypatch)
    native = jax_pipeline.run(
        JaxConfig(**kw, output_dir=str(tmp_path / "jax") + "/"),
        table=table, write_output=True)
    assert got.conv.it == int(native.conv.it)
    H.assert_same_results(got.result, native.result, rtol=1e-10,
                        scale_atol=1e-12, net_atol=1e-10)
    H.assert_same_files(tmp_path / "torch" / "rce", tmp_path / "jax" / "rce")
    assert "rce_tp.dat" in os.listdir(tmp_path / "torch" / "rce")


def test_run_writes_output_by_default_as_jax():
    """Both packages' run() default to write_output=True."""
    def default(fn):
        return inspect.signature(fn).parameters["write_output"].default
    assert default(torch_pipeline.run) is default(jax_pipeline.run) is True


def test_approx_f_gas_planet_writes_the_tau_file_of_jax(tmp_path,
                                                        monkeypatch):
    """approx_f on a gas planet with write_output=True (the post-processing
    run of test_postprocessing_run_matches_jax): the port writes the file
    set of the native-fp64-Planck JAX run, the tau_lw / tau_sw / f-factor
    file included, and every file's numbers agree within their printed
    digits."""
    _pt_file(tmp_path / "profile.dat", "PT")
    kw = dict(HOT, name="kf", run_type="post-processing", temp_format="PT",
              temp_path=str(tmp_path / "profile.dat"), convection="no",
              approx_f="yes")
    table = H.small_table()
    table.kpoints *= 1e-8   # thin enough that tau = -log(mean transmission)
    torch_pipeline.run(
        TorchConfig(**kw, output_dir=str(tmp_path / "torch") + "/"),
        table, write_output=True, device="cpu")
    H.native_build(monkeypatch)
    jax_pipeline.run(JaxConfig(**kw, output_dir=str(tmp_path / "jax") + "/"),
                     table=table, write_output=True)
    tau_file = "kf_tau_lw_tau_sw_f_factor.dat"
    assert tau_file in os.listdir(tmp_path / "torch" / "kf")
    rows = H.file_rows(os.path.join(tmp_path, "torch", "kf", tau_file))
    assert all(np.isfinite(H.file_number(t)) for t in rows[-1])
    H.assert_same_files(tmp_path / "torch" / "kf", tmp_path / "jax" / "kf")
