"""The port's configuration and forward model (helios_tpu_torch.config,
.forward, .fastpath, .planck) against the JAX package on the CPU.

Tolerances.  The JAX package's CPU reference is XLA; the port's is
PyTorch.  Their exp/log10/pow differ in the last bit, and three places in
the physics amplify such 1-ulp differences well beyond 1e-12 *relative* in
single elements whose value is negligible next to the array's scale:
  * XLA flushes denormal results to zero (e.g. the transmission of an
    optically thick half layer is 0.0 there, ~1e-309 here);
  * N = zp zm (1 - T^2) and the thin-layer gradient term (M - N - P)/dtau
    of the coefficient cache cancel as T -> 1 and dtau -> 1e-4 (the
    isothermal fallback limit): up to 1e4 x a 1-ulp difference;
  * the Planck table's series difference S(y_top) - S(y_bot) cancels in
    the Rayleigh-Jeans tail (small y) of each temperature row.
So arrays are held to rtol 1e-12 plus an absolute term that is a stated
multiple of eps of the array's (or the table row's) largest value.

The JAX CPU path gathers Planck values as two-float32 pairs (built for
the TPU, planck.py:126-134), about 1e-14 from native fp64; the thin-layer
gradient term amplifies that to ~3e-8 in single fluxes.  The 1e-12 checks
therefore use the JAX package's native fp64 lookup (pairs=None), and one
test holds the port against the unmodified pairs path at its own bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import fastpath as jfp
from helios_tpu import forward as jf
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu_torch import convert
from helios_tpu_torch import fastpath as tfp
from helios_tpu_torch import forward as tf
from helios_tpu_torch.config import HeliosConfig as TorchConfig

import torch_port_helpers as H

VARIANTS = {
    "default": {},
    "single_beam": dict(precision="single", direct_beam="yes",
                        scat_corr="yes", zenith_angle_deg=45.0,
                        surf_albedo=0.3),
    "database_planet": dict(planet="HD_209458b", nlayer=20, smooth="yes",
                            T_intern=100.0, input_dampara=2.0,
                            geom_zenith_corr="yes",
                            crit_relaxation_numbers=[500, 900]),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_config_and_phys_match(name):
    """The copied config.py finalizes exactly like the JAX one, and Phys
    carries the same fields (the port's Phys drops only use_pallas)."""
    jc = JaxConfig(**VARIANTS[name]).finalize()
    tc = TorchConfig(**VARIANTS[name]).finalize()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    want = dataclasses.asdict(jf.Phys.from_config(jc, nbin=65, ny=4))
    del want["use_pallas"]
    assert dataclasses.asdict(tf.Phys.from_config(tc, nbin=65, ny=4)) == want


def _models(direct_beam="no"):
    kw = dict(H.SMALL_RUN, direct_beam=direct_beam)
    table = H.small_table()
    tphys, tarr = tf.build_model(TorchConfig(**kw).finalize(), table,
                                 device="cpu")
    jphys, jarr = jf.build_model(JaxConfig(**kw).finalize(), table)
    return jphys, jax.block_until_ready(jarr), tphys, tarr


@pytest.fixture(scope="module", params=["no", "yes"], ids=["nobeam",
                                                           "beam"])
def models(request):
    return _models(request.param)


def test_build_model_matches(models):
    """Every ModelArrays field of the port's own build equals JAX's; the
    Planck table to 1e-13 of each temperature row's largest value (the
    Rayleigh-Jeans cancellation above)."""
    jphys, jarr, tphys, tarr = models
    for name in tf.ModelArrays._fields:
        want = np.asarray(getattr(jarr, name))
        got = getattr(tarr, name).numpy()
        if name == "planck_grid":
            row = np.abs(want).max(axis=1, keepdims=True)
            assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want)
                          + 1e-13 * row + H.TINY), name
        else:
            H.assert_close(got, want, rtol=1e-12, err_msg=name)


def _converted(jarr):
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    return convert.model_arrays_from_numpy(d, device="cpu")


def test_compute_cells_pieces_match(models):
    """Opacities, half-layer cells, direct beam and the coefficient cache
    from identical model arrays (converted from the JAX ones)."""
    jphys, jarr, tphys, _ = models
    T = H.start_profile(jphys.nlayer)
    Tj = jnp.asarray(T)
    from helios_tpu.ops import interp as jinterp
    want = jax.jit(lambda t: jf.compute_cells(
        jphys, H.native_planck(jarr), t,
        jinterp.interface_temperatures(t)))(Tj)
    Tt = torch.tensor(T)
    from helios_tpu_torch.ops import interp as tinterp
    got = tf.compute_cells(tphys, _converted(jarr), Tt,
                           tinterp.interface_temperatures(Tt))

    for name in ("opac_lay", "meanmolmass_lay", "scat_cross_lay", "z_lay",
                 "F_add_heat_lay", "F_add_heat_sum", "scat_trigger"):
        H.assert_close(getattr(got, name).numpy(), getattr(want, name),
                       rtol=1e-12, err_msg=name)
    # eps-of-scale terms: denormal flush and the T -> 1 cancellation
    for half in ("cells_or_upper", "lower"):
        for f in tfp.FlatCells._fields:
            H.assert_close(getattr(getattr(got, half), f).numpy(),
                           getattr(getattr(want, half), f), rtol=1e-12,
                           scale_atol=1e-14, err_msg=f"{half}.{f}")
    for name in ("F_dir", "Fc_dir"):
        H.assert_close(getattr(got, name).numpy(), getattr(want, name),
                       rtol=1e-12, scale_atol=1e-14, err_msg=name)
    # the thin-layer gradient term: up to 1e4 x eps of the array's scale.
    # The direct-beam sources D_* are differences of two terms of size
    # |F_dir * G / mu*| that nearly cancel (the beam attenuated across the
    # half layer against the transmitted beam): 1e-14 of that size.
    G = max(np.abs(np.asarray(getattr(want, h).G_pl)).max()
            + np.abs(np.asarray(getattr(want, h).G_min)).max()
            for h in ("cells_or_upper", "lower"))
    beam_term = float(np.abs(np.asarray(want.F_dir)).max()) * G / abs(
        jphys.mu_star)
    for f in tfp.NonIsoCoeffCache._fields:
        w = np.asarray(getattr(want.coeff, f))
        atol = (1e-14 * beam_term if f.startswith("D_")
                else 1e-11 * float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got.coeff, f).numpy(), w,
                                   rtol=1e-12, atol=atol + H.TINY,
                                   err_msg=f"coeff.{f}")


def test_fdir_noniso_flat_matches():
    """The direct beam on random inputs: with plain mu* (cumulative
    optical depths), and with the geometric zenith correction's weights
    (one matrix product in the port, a broadcast-multiply sum in JAX)."""
    rng = np.random.default_rng(5)
    L, S = 11, 48
    star = rng.uniform(1e3, 1e6, S)
    up = rng.uniform(0.0, 2.0, (L, S))
    low = rng.uniform(0.0, 2.0, (L, S))
    kw = dict(mu_star=-0.17, R_star=6.9e10, a=4.5e12, dir_beam=1)
    weights, diag = H.zenith_weights(L, kw["mu_star"])
    for mu_w, mu_d in ((None, None), (weights, diag)):
        want = jfp.fdir_noniso_flat(
            jnp.asarray(star), jnp.asarray(up), jnp.asarray(low),
            None if mu_w is None else jnp.asarray(mu_w),
            None if mu_d is None else jnp.asarray(mu_d), **kw)
        got = tfp.fdir_noniso_flat(
            torch.tensor(star), torch.tensor(up), torch.tensor(low),
            None if mu_w is None else torch.tensor(mu_w),
            None if mu_d is None else torch.tensor(mu_d), **kw)
        for g, w in zip(got, want):
            H.assert_close(g.numpy(), w, rtol=1e-12)


def _forward_pair(models, jarr_use, tarr_use):
    jphys, _, tphys, _ = models
    T = H.start_profile(jphys.nlayer)
    want = jax.jit(lambda t: jf.forward_fluxes(jphys, jarr_use, t)[:2])(
        jnp.asarray(T))
    got = tf.forward_fluxes(tphys, tarr_use, torch.tensor(T))[:2]
    return got, want


def _check_totals(got, want, rtol):
    flux, totals = got
    wflux, wtotals = want
    scale = float(np.max(np.abs(np.asarray(wtotals.F_up_tot))))
    for f in ("F_up_tot", "F_down_tot"):
        H.assert_close(getattr(totals, f).numpy(), getattr(wtotals, f),
                       rtol=rtol, err_msg=f)
    # F_net = F_up - F_down cancels: held to rtol of the flux scale
    np.testing.assert_allclose(totals.F_net.numpy(),
                               np.asarray(wtotals.F_net), rtol=rtol,
                               atol=rtol * scale)
    return flux, wflux


def test_forward_fluxes_match(models):
    """forward_fluxes totals at 1e-12 from identical model arrays, and the
    spectral fluxes to 1e-12 of their scale."""
    jphys, jarr, _, _ = models
    got, want = _forward_pair(models, H.native_planck(jarr),
                              _converted(jarr))
    flux, wflux = _check_totals(got, want, 1e-12)
    for f in tf.FluxState._fields:
        H.assert_close(getattr(flux, f).numpy(), getattr(wflux, f),
                       rtol=1e-12, scale_atol=1e-12, err_msg=f)
    from helios_tpu.ops import integrate as jint
    from helios_tpu_torch.ops import integrate as tint
    H.assert_close(
        tint.integrate_beamflux(got[1].F_dir_band,
                                torch.tensor(np.asarray(jarr.delta_lambda))),
        jint.integrate_beamflux(want[1].F_dir_band, jarr.delta_lambda),
        rtol=1e-12, scale_atol=1e-14)


def test_forward_fluxes_own_build_match(models):
    """The port end to end from its own build_model (own Planck table)."""
    _, jarr, _, tarr = models
    got, want = _forward_pair(models, H.native_planck(jarr), tarr)
    _check_totals(got, want, 1e-12)


def test_forward_fluxes_match_jax_pairs_planck(models):
    """Against the unmodified JAX CPU path (two-float32 Planck pairs):
    totals within 1e-7, the pairs' ~1e-14 amplified by the thin-layer
    gradient term (module docstring)."""
    _, jarr, _, tarr = models
    got, want = _forward_pair(models, jarr, tarr)
    _check_totals(got, want, 1e-7)
