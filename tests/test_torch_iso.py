"""The port's isothermal path (helios_tpu_torch.kernels.sweep.iso_sweep,
the iso branches of .fastpath, .forward and .rce.radiative) against the
JAX package on the CPU.

The iso sweep's plain version is held to fastpath.fband_iso_flat: the
lax.scan oracle (use_pallas=False) up to the post-processing run's 1001
passes, and the Pallas kernels in interpret mode (use_pallas=True, as
tests/test_df64.py runs them).  fp64 at rtol 1e-12; fp32 at rtol 2e-5, the
bound of tests/test_df64.py for the fp32 Pallas kernel against the oracle.
The CUDA kernel itself runs only on the card (tests/test_torch_package.py).

The forward-model tolerances follow tests/test_torch_forward.py: 1e-12
against the JAX package's native fp64 Planck lookup, an absolute term of
1e-14 of the array's scale where XLA and PyTorch differ in the last bit of
exp (denormal flushes, the direct-beam terms), and a stated bound against
its two-float32 Planck pairs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import fastpath as jfp
from helios_tpu import forward as jf
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.ops import interp as jinterp
from helios_tpu.rce import radiative as jrad
from helios_tpu_torch import constants as pc
from helios_tpu_torch import convert
from helios_tpu_torch import fastpath as tfp
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.kernels import _build
from helios_tpu_torch.kernels.sweep import iso_sweep, iso_sweep_reference
from helios_tpu_torch.ops import interp as tinterp
from helios_tpu_torch.rce import radiative as trad

import torch_port_helpers as H

NAMES = ("a", "b_nm", "src_down", "src_up", "toa", "boa_refl", "boa_emis")
ISO_RUN = dict(H.SMALL_RUN, iso_input="yes")
RTOL = {np.float64: 1e-12, np.float32: 2e-5}


def _inputs(seed, L, S, dtype):
    """Physically shaped random sweep inputs (as tests/test_df64.py)."""
    rng = np.random.default_rng(seed)
    mk = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(dtype)
    C = dict(a=mk(0.8, 1.0, L, S), b_nm=mk(0.0, 0.02, L, S),
             src_down=mk(1e2, 1e4, L, S), src_up=mk(1e2, 1e4, L, S),
             toa=mk(0.0, 1e3, S), boa_refl=mk(0.0, 0.4, S),
             boa_emis=mk(1e2, 1e4, S))
    return C, mk(0.0, 1e3, S), mk(0.0, 1e3, L + 1, S)


def _jax(C, F_dir0, F_up0, n_passes, use_pallas):
    JC = jfp.FlatIsoCoeffs(**{k: jnp.asarray(v) for k, v in C.items()})
    out = jfp.fband_iso_flat(JC, jnp.asarray(F_dir0), jnp.asarray(F_up0),
                             n_passes=n_passes, use_pallas=use_pallas)
    return [np.asarray(x) for x in out]


def _port(C, F_dir0, F_up0, n_passes, fn=iso_sweep):
    t = torch.from_numpy
    out = fn(*(t(C[k]) for k in NAMES), t(F_dir0), t(F_up0),
             n_passes=n_passes)
    return [x.numpy() for x in out]


# --------------------------------------------------------------------------- #
# the sweep
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_passes", [1, 4, 1001])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["fp64", "fp32"])
def test_iso_sweep_matches_jax_oracle(dtype, n_passes):
    """Against the lax.scan oracle, up to the 1000*scat+1 passes of the
    post-processing run."""
    args = _inputs(0, 10, 40, dtype)
    want = _jax(*args, n_passes, use_pallas=False)
    got = _port(*args, n_passes)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g, w, rtol=RTOL[dtype])


@pytest.mark.parametrize("n_passes", [1, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["fp64", "fp32"])
def test_iso_sweep_matches_jax_pallas(dtype, n_passes):
    """Against the Pallas kernels in interpret mode: the df64 kernel for
    fp64 (itself within 1e-12 of the oracle), the fp32 kernel for fp32."""
    args = _inputs(1, 12, 40, dtype)
    want = _jax(*args, n_passes, use_pallas=True)
    got = _port(*args, n_passes)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g, w, rtol=RTOL[dtype])


def test_iso_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors the wrapper returns exactly the plain version's
    result and launches nothing."""
    args = _inputs(2, 6, 24, np.float64)
    before = iso_sweep.launches
    got = _port(*args, 4)
    want = _port(*args, 4, fn=iso_sweep_reference)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert iso_sweep.launches == before


def _tensors(dtype=torch.float64, L=5, S=16):
    C, F_dir0, F_up0 = _inputs(3, L, S, np.float64)
    ts = [torch.from_numpy(C[k]) for k in NAMES]
    ts += [torch.from_numpy(F_dir0), torch.from_numpy(F_up0)]
    return [t.to(dtype) for t in ts]


def _wrong_shape(ts):
    ts[8] = ts[8][:-1].contiguous()       # F_up_prev [L, S], not [L+1, S]


def _mixed_dtypes(ts):
    ts[3] = ts[3].float()


def _non_contiguous(ts):
    ts[0] = ts[0].t().contiguous().t()    # same shape, column-major


def _other_device(ts):
    ts[:] = [t.to("meta") for t in ts]


BAD_ARGUMENTS = [
    ("shape", _wrong_shape, {}, ValueError, "shape"),
    ("dtypes", _mixed_dtypes, {}, TypeError, "dtype"),
    ("contiguous", _non_contiguous, {}, ValueError, "contiguous"),
    ("float16", lambda ts: ts.__setitem__(slice(None),
                                          [t.half() for t in ts]),
     {}, TypeError, "unsupported dtype"),
    ("device", _other_device, {}, ValueError, "cuda or cpu"),
    ("zero_passes", lambda ts: None, dict(n_passes=0), ValueError,
     "n_passes"),
    ("float_passes", lambda ts: None, dict(n_passes=2.0), TypeError,
     "integer"),
    ("huge_passes", lambda ts: None, dict(n_passes=2**31), ValueError,
     "n_passes"),
]


@pytest.mark.parametrize("spoil,kw,exc,match",
                         [b[1:] for b in BAD_ARGUMENTS],
                         ids=[b[0] for b in BAD_ARGUMENTS])
def test_iso_wrapper_rejects_bad_arguments(spoil, kw, exc, match):
    """Wrong shapes, dtypes, devices, layouts and pass counts raise; the
    wrapper adjusts nothing."""
    ts = _tensors()
    spoil(ts)
    with pytest.raises(exc, match=match):
        iso_sweep(*ts, **{"n_passes": 1, **kw})


def test_build_knows_the_iso_source():
    assert "iso_sweep" in _build.kernel_names()
    p = _build.library_path("iso_sweep")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("iso_sweep-")
    assert p != _build.library_path("noniso_sweep")


# --------------------------------------------------------------------------- #
# the forward model
# --------------------------------------------------------------------------- #

def _models(direct_beam):
    kw = dict(ISO_RUN, direct_beam=direct_beam)
    table = H.small_table()
    tphys, tarr = tf.build_model(TorchConfig(**kw).finalize(), table,
                                 device="cpu")
    jphys, jarr = jf.build_model(JaxConfig(**kw).finalize(), table)
    assert tphys.iso == jphys.iso == 1
    return jphys, jax.block_until_ready(jarr), tphys, tarr


@pytest.fixture(scope="module", params=["no", "yes"], ids=["nobeam",
                                                           "beam"])
def models(request):
    return _models(request.param)


def _converted(jarr):
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    return convert.model_arrays_from_numpy(d, device="cpu")


def test_iso_compute_cells_pieces_match(models):
    """The layer cells, the direct beam and the IsoCoeffCache from
    identical model arrays; the iso cache has one cell per layer and no
    half-layer beam."""
    jphys, jarr, tphys, _ = models
    T = H.start_profile(jphys.nlayer)
    Tj = jnp.asarray(T)
    want = jax.jit(lambda t: jf.compute_cells(
        jphys, H.native_planck(jarr), t,
        jinterp.interface_temperatures(t)))(Tj)
    Tt = torch.tensor(T)
    got = tf.compute_cells(tphys, _converted(jarr), Tt,
                           tinterp.interface_temperatures(Tt))

    assert isinstance(got.coeff, tfp.IsoCoeffCache)
    assert got.cells_or_upper is got.lower
    assert not got.Fc_dir.any()
    for name in ("opac_lay", "meanmolmass_lay", "scat_cross_lay", "z_lay",
                 "scat_trigger"):
        H.assert_close(getattr(got, name).numpy(), getattr(want, name),
                       rtol=1e-12, err_msg=name)
    for f in tfp.FlatCells._fields:
        H.assert_close(getattr(got.cells_or_upper, f).numpy(),
                       getattr(want.cells_or_upper, f), rtol=1e-12,
                       scale_atol=1e-14, err_msg=f)
    H.assert_close(got.F_dir.numpy(), want.F_dir, rtol=1e-12,
                   scale_atol=1e-14, err_msg="F_dir")
    if jphys.dir_beam:
        assert np.abs(np.asarray(want.F_dir)).max() > 0
    # the direct-beam sources dir_down/dir_up are differences of two terms
    # of size |F_dir * G / mu*| that nearly cancel (as the non-iso D_* of
    # tests/test_torch_forward.py): 1e-14 of that size
    cells = want.cells_or_upper
    beam_term = (float(np.abs(np.asarray(want.F_dir)).max())
                 * (np.abs(np.asarray(cells.G_pl)).max()
                    + np.abs(np.asarray(cells.G_min)).max())
                 / abs(jphys.mu_star))
    for f in tfp.IsoCoeffCache._fields:
        w = np.asarray(getattr(want.coeff, f))
        atol = (1e-14 * beam_term if f.startswith("dir_")
                else 1e-14 * float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got.coeff, f).numpy(), w,
                                   rtol=1e-12, atol=atol + H.TINY,
                                   err_msg=f"coeff.{f}")


def test_fdir_iso_flat_matches():
    """The direct beam on random inputs: with plain mu* (cumulative
    optical depths), and with the geometric zenith correction's weights
    (one matrix product in the port, a broadcast-multiply sum in JAX)."""
    rng = np.random.default_rng(5)
    L, S = 11, 48
    star = rng.uniform(1e3, 1e6, S)
    dtau = rng.uniform(0.0, 2.0, (L, S))
    kw = dict(mu_star=-0.17, R_star=6.9e10, a=4.5e12, dir_beam=1)
    weights, _ = H.zenith_weights(L, kw["mu_star"])
    for mu_w in (None, weights):
        want = jfp.fdir_iso_flat(
            jnp.asarray(star), jnp.asarray(dtau),
            None if mu_w is None else jnp.asarray(mu_w), **kw)
        got = tfp.fdir_iso_flat(
            torch.tensor(star), torch.tensor(dtau),
            None if mu_w is None else torch.tensor(mu_w), **kw)
        H.assert_close(got.numpy(), want, rtol=1e-12)


def _forward_pair(models, jarr_use, tarr_use):
    jphys, _, tphys, _ = models
    T = H.start_profile(jphys.nlayer)
    want = jax.jit(lambda t: jf.forward_fluxes(jphys, jarr_use, t)[:2])(
        jnp.asarray(T))
    got = tf.forward_fluxes(tphys, tarr_use, torch.tensor(T))[:2]
    return got, want


def _check_totals(got, want, rtol):
    (flux, totals), (wflux, wtotals) = got, want
    for f in ("F_up_tot", "F_down_tot"):
        H.assert_close(getattr(totals, f).numpy(), getattr(wtotals, f),
                       rtol=rtol, err_msg=f)
    scale = float(np.max(np.abs(np.asarray(wtotals.F_up_tot))))
    np.testing.assert_allclose(totals.F_net.numpy(),
                               np.asarray(wtotals.F_net), rtol=rtol,
                               atol=rtol * scale)
    return flux, wflux


def test_iso_forward_fluxes_match(models):
    """forward_fluxes totals at 1e-12 from identical model arrays (native
    fp64 Planck lookup on the JAX side), spectral fluxes to 1e-12 of their
    scale; the iso solve leaves Fc_down/Fc_up at zero, as in JAX."""
    _, jarr, _, _ = models
    got, want = _forward_pair(models, H.native_planck(jarr),
                              _converted(jarr))
    flux, wflux = _check_totals(got, want, 1e-12)
    for f in tf.FluxState._fields:
        H.assert_close(getattr(flux, f).numpy(), getattr(wflux, f),
                       rtol=1e-12, scale_atol=1e-12, err_msg=f)
    assert not flux.Fc_up.any() and not flux.Fc_down.any()


def test_iso_forward_fluxes_own_build_match_jax_pairs_planck(models):
    """The port from its own build_model against the unmodified JAX CPU
    path (two-float32 Planck pairs): totals within 1e-7 (2.2e-8 measured).
    The JAX package's own pairs and native paths differ by the same 2.2e-8
    under jit, and by 8e-16 when run eagerly: the error comes from XLA's
    compilation of the pairs arithmetic, not from the port (ROADMAP C)."""
    _, jarr, _, tarr = models
    got, want = _forward_pair(models, jarr, tarr)
    _check_totals(got, want, 1e-7)


def test_sigma_t4_closure():
    """An optically thick isothermal atmosphere at 1500 K with no star and
    no scattering emits sigma T^4 at the TOA, and nothing comes down
    there (the verify recipe of the repository's skill notes), on the port
    alone through a post-processing configuration."""
    table = synthetic_premixed_table(nbin=65, ny=4, ntemp=8, npress=6,
                                     seed=1)
    table.kpoints *= 1e4
    cfg = TorchConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                      R_star=0.0001, T_star=1.0, T_intern=0.0,
                      scattering="no", direct_beam="no", convection="no",
                      run_type="post-processing", iso_input="yes",
                      nlayer=12).finalize()
    phys, arrays = tf.build_model(cfg, table, device="cpu")
    T = torch.full((phys.nlayer + 1,), 1500.0, dtype=torch.float64)
    totals = tf.forward_fluxes(phys, arrays, T)[1]
    sigma_t4 = pc.SIGMA_SB * 1500.0 ** 4
    np.testing.assert_allclose(float(totals.F_up_tot[-1]), sigma_t4,
                               rtol=1e-3)
    assert abs(float(totals.F_down_tot[-1])) < 1e-6 * sigma_t4


# --------------------------------------------------------------------------- #
# the isothermal iterative run
# --------------------------------------------------------------------------- #

def test_one_iso_radiation_step_from_a_mid_run_state():
    """25 JAX iterations of the iso loop, the state carried across with
    rad_state_from_numpy (an IsoCoeffCache inside), then one more in both:
    T at rtol 1e-12."""
    jphys, jarr, tphys, _ = _models("no")
    jarr = H.native_planck(jarr)
    tarr = _converted(jarr)
    run = lambda steps, state0=None: jax.jit(
        lambda t: jrad.radiation_loop(
            jphys, jarr, jrad.make_const_thermo(0.1), t, max_steps=steps,
            state0=state0))(
                jnp.asarray(H.start_profile(jphys.nlayer)))
    mid = run(25)
    want = run(1, mid)
    s = convert.rad_state_from_numpy(H.nested_numpy(mid), device="cpu")
    assert isinstance(s.cache.coeff, tfp.IsoCoeffCache)
    got = trad.radiation_loop(tphys, tarr, None, None, max_steps=1,
                              state0=s)
    assert got.it == int(want.it) == 26
    H.assert_close(got.T_lay.numpy(), want.T_lay, rtol=1e-12)
    H.assert_close(got.prefactor.numpy(), want.prefactor, rtol=1e-12)


def test_small_iso_run_matches_jax_pipeline(tmp_path, monkeypatch):
    """pipeline.run of both packages on the small scenario with isothermal
    layers, from the same TP file, to convergence.  No convection loop
    runs (iso layers, as in helios_tpu.pipeline.run).  Against the JAX run
    with native fp64 Planck lookups: final T at rtol 1e-8 (1.2e-9
    measured).  The radiation counts differ (1703 here against 1629 in
    JAX): they are chaotic (ROADMAP C), and the final T carries where each
    run stopped inside the 1e-8 flux criterion.  (The unmodified JAX run,
    with two-float32 Planck pairs, does not converge in this scenario: it
    hits the 100000-iteration cap.)"""
    tp = tmp_path / "start_tp.dat"
    H.write_tp_file(tp, H.start_profile(12))
    cfg = dict(ISO_RUN, force_start_tp_from_file="yes",
               temp_format="helios", temp_path=str(tp))
    table = H.small_table()

    got = torch_pipeline.run(TorchConfig(**cfg), table, write_output=False,
                             device="cpu")
    assert got.conv is None
    assert not bool(got.rad.keep_running) and not got.rad.aborted
    assert got.n_flux_solves == got.rad.it > 100
    T = got.T_lay.numpy()
    assert np.all(np.isfinite(T))

    build = jax_pipeline.build_model
    monkeypatch.setattr(
        jax_pipeline, "build_model",
        lambda *a, **k: (lambda pa: (pa[0], H.native_planck(pa[1])))(
            build(*a, **k)))
    native = jax_pipeline.run(JaxConfig(**cfg), table=table,
                              write_output=False)
    assert native.conv is None and not bool(native.rad.keep_running)
    np.testing.assert_allclose(T, np.asarray(native.rad.T_lay), rtol=1e-8)
