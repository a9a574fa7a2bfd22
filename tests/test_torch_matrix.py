"""The port's matrix flux method (helios_tpu_torch.kernels.thomas,
.ops.thomas and the matrix branches of .forward) against the JAX package on
the CPU.

Tolerances.  The Thomas solve's plain version is the numpy oracle
(tests/reference_impl.thomas_reference) bit for bit; the JAX scan differs
from both by the fma contractions of XLA's CPU compiler (6e-14 on the
diagonally dominant systems here), held at 1e-12.  The flux solves take
identical cells and Planck rows on both sides and are held at 1e-12, with
an absolute term of 1e-14 of the array's scale where the direct-beam
sources cancel (as tests/test_torch_iso.py).

The scenarios set a surface albedo of 0.3.  With the default albedo
(clamped to 1e-8), row 0 of the matrix, [-albedo, 1], makes the
reference's unpivoted elimination recover the BOA downward flux as
(F_up[0] - src_boa) / albedo: both packages are then ~1e-8 of the
column's scale from a long-double solve, and differ from each other by
~1e-9 there (ROADMAP C); test_default_albedo_bound states that bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import constants as jpc
from helios_tpu import fastpath as jfp
from helios_tpu import forward as jf
from helios_tpu import pipeline as jax_pipeline
from helios_tpu import planck as jplanck
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.ops import interp as jinterp
from helios_tpu.ops import sweep as jsweep
from helios_tpu.ops import thomas as jthomas
from helios_tpu_torch import convert
from helios_tpu_torch import fastpath as tfp
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.kernels import _build
from helios_tpu_torch.kernels.thomas import (thomas_solve,
                                             thomas_solve_reference)
from helios_tpu_torch.ops import thomas as tthomas

import reference_impl as ref
import torch_port_helpers as H

MATRIX_RUN = dict(H.SMALL_RUN, flux_calc_method="matrix", surf_albedo=0.3)
# a hot star, so that the direct beam is not negligible
BEAM_STAR = dict(R_star=0.805, T_star=5040.0, a=0.03142, direct_beam="yes")


def _system(seed, n, S):
    """A diagonally dominant tridiagonal system (sub-diagonal c_{i-1})."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(2.0, 3.0, (n, S)) * rng.choice([-1.0, 1.0], (n, S))
    c = rng.uniform(-0.5, 0.5, (n, S))
    d = rng.uniform(-1e3, 1e3, (n, S))
    return b, c, d


# --------------------------------------------------------------------------- #
# the Thomas solve
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,S", [(26, 16), (50, 40), (212, 8)])
def test_thomas_solve_matches_jax_and_oracle(n, S):
    """Against JAX's thomas_solve(use_pallas=False) at 1e-12 and the numpy
    oracle of the reference's elimination bit for bit; the sizes include
    the iso and non-iso matrices of the small scenario and n = 212 of the
    flagship iso matrix."""
    b, c, d = _system(n, n, S)
    got = thomas_solve(*(torch.from_numpy(x) for x in (b, c, d))).numpy()
    want = np.asarray(jthomas.thomas_solve(jnp.asarray(b), jnp.asarray(c),
                                           jnp.asarray(d), use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    oracle = np.stack([ref.thomas_reference(b[:, s], c[:, s], d[:, s])
                       for s in range(S)], axis=1)
    np.testing.assert_array_equal(got, oracle)


def test_thomas_solve_float32():
    """fp32 against the fp64 solve of the same (rounded) system: 1e-5."""
    b, c, d = (x.astype(np.float32) for x in _system(1, 50, 24))
    got = thomas_solve(*(torch.from_numpy(x) for x in (b, c, d)))
    assert got.dtype == torch.float32
    want = thomas_solve(*(torch.from_numpy(x).double() for x in (b, c, d)))
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_thomas_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors the wrapper returns exactly the plain version's
    result and launches nothing."""
    ts = [torch.from_numpy(x) for x in _system(2, 20, 12)]
    before = thomas_solve.launches
    torch.testing.assert_close(thomas_solve(*ts), thomas_solve_reference(*ts),
                               rtol=0, atol=0)
    assert thomas_solve.launches == before


BAD_ARGUMENTS = [
    ("shape", lambda ts: ts.__setitem__(2, ts[2][:-1].contiguous()),
     ValueError, "shape"),
    ("one_dim", lambda ts: ts.__setitem__(0, ts[0][0]), ValueError,
     r"\[n, S\]"),
    ("dtypes", lambda ts: ts.__setitem__(1, ts[1].float()), TypeError,
     "dtype"),
    ("contiguous", lambda ts: ts.__setitem__(
        0, ts[0].t().contiguous().t()), ValueError, "contiguous"),
    ("float16", lambda ts: ts.__setitem__(slice(None),
                                          [t.half() for t in ts]),
     TypeError, "unsupported dtype"),
    ("device", lambda ts: ts.__setitem__(slice(None),
                                         [t.to("meta") for t in ts]),
     ValueError, "cuda or cpu"),
]


@pytest.mark.parametrize("spoil,exc,match", [b[1:] for b in BAD_ARGUMENTS],
                         ids=[b[0] for b in BAD_ARGUMENTS])
def test_thomas_wrapper_rejects_bad_arguments(spoil, exc, match):
    """Wrong shapes, dtypes, devices and layouts raise; nothing is
    adjusted (no identity padding columns)."""
    ts = [torch.from_numpy(x) for x in _system(3, 12, 8)]
    spoil(ts)
    with pytest.raises(exc, match=match):
        thomas_solve(*ts)


def test_build_knows_the_new_sources():
    names = _build.kernel_names()
    assert {"thomas", "ro_mix", "iso_sweep", "noniso_sweep"} <= set(names)
    paths = {_build.library_path(n) for n in names}
    assert len(paths) == len(names)


# --------------------------------------------------------------------------- #
# the matrix flux solves, from identical cells
# --------------------------------------------------------------------------- #

def _models(iso, beam):
    kw = dict(MATRIX_RUN, iso_input="yes" if iso else "no",
              **(BEAM_STAR if beam else {}))
    table = H.small_table(16)
    jphys, jarr = jf.build_model(JaxConfig(**kw).finalize(), table)
    jarr = H.native_planck(jax.block_until_ready(jarr))
    tphys = tf.Phys.from_config(TorchConfig(**kw).finalize(), nbin=16, ny=4)
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    return jphys, jarr, tphys, convert.model_arrays_from_numpy(
        d, device="cpu")


def _solve_inputs(jphys, jarr):
    """The JAX cell cache at the start profile, its Planck rows and its
    scat_trigger, which takes both branches (a random mask would not do:
    the elimination is unstable in columns without scattering, which is
    why the reference takes the absorption recurrences there)."""
    T = jnp.asarray(H.start_profile(jphys.nlayer))
    T_int = jinterp.interface_temperatures(T)
    cache = jax.jit(lambda t, ti: jf.compute_cells(jphys, jarr, t, ti))(
        T, T_int)
    kw = dict(dim=jphys.plancktable_dim, step=jphys.plancktable_step)
    B_lay = jplanck.planckband_layers(jarr.planck_grid, T, jarr.starflux,
                                      real_star=jphys.real_star, **kw)
    B_int = jplanck.planckband_interfaces(jarr.planck_grid, T_int, **kw)
    trigger = np.array(cache.scat_trigger)
    assert 0 < trigger.sum() < trigger.size
    return cache, B_lay, B_int, trigger


def _common(phys):
    return dict(scat_corr=phys.scat_corr, i2s_transition=phys.i2s_transition,
                epsi=phys.epsi, mu_star=phys.mu_star, dir_beam=phys.dir_beam,
                f_factor=phys.f_factor, R_star=phys.R_star, a=phys.a)


def _flat_cells(cells):
    return tfp.FlatCells(*(torch.from_numpy(np.array(getattr(cells, f)))
                           for f in tfp.FlatCells._fields))


def _t(x):
    return torch.from_numpy(np.array(x))


def _beam_scale(cache, cells_list, phys):
    """|F_dir| * (|G+| + |G-|) / |mu*|: the size of the direct-beam source
    terms that nearly cancel."""
    g = max(float(np.abs(np.asarray(c.G_pl)).max()
                  + np.abs(np.asarray(c.G_min)).max()) for c in cells_list)
    return float(np.abs(np.asarray(cache.F_dir)).max()) * g / abs(
        phys.mu_star)


def _check_fluxes(got, want, beam_scale):
    """rtol 1e-12 plus 1e-14 of the array's and of the beam sources'
    scale."""
    for g, w in zip(got, want):
        w = np.asarray(jfp.cube_to_flat(w))
        atol = 1e-14 * (float(np.abs(w).max()) + beam_scale) + H.TINY
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("beam", [False, True], ids=["nobeam", "beam"])
def test_fband_matrix_iso_matches(beam):
    """fband_matrix_iso from identical cells, Planck rows and scat_trigger
    (both branches taken) at 1e-12."""
    jphys, jarr, _, tarr = _models(True, beam)
    cache, B_lay, _, trigger = _solve_inputs(jphys, jarr)
    Y = jphys.ny
    cells = cache.cells_or_upper
    want = jthomas.fband_matrix_iso(
        jf._matrix_cells(cells, Y), B_lay, jfp.flat_to_cube(cache.F_dir, Y),
        jarr.surf_albedo, jfp.flat_to_cube(jnp.asarray(trigger)[None], Y)[0],
        **_common(jphys))
    got = tthomas.fband_matrix_iso(
        _flat_cells(cells), _t(B_lay), _t(cache.F_dir), tarr.surf_albedo,
        torch.from_numpy(trigger), **_common(jphys))
    if beam:
        assert np.abs(np.asarray(cache.F_dir)).max() > 0
    _check_fluxes(got, want, _beam_scale(cache, [cells], jphys))


@pytest.mark.parametrize("beam", [False, True], ids=["nobeam", "beam"])
def test_fband_matrix_noniso_matches(beam):
    """fband_matrix_noniso from identical half-layer cells, Planck rows and
    scat_trigger (both branches taken) at 1e-12."""
    jphys, jarr, _, tarr = _models(False, beam)
    cache, B_lay, B_int, trigger = _solve_inputs(jphys, jarr)
    Y = jphys.ny
    up, low = cache.cells_or_upper, cache.lower
    want = jthomas.fband_matrix_noniso(
        jf._matrix_cells(up, Y), jf._matrix_cells(low, Y), B_lay, B_int,
        jfp.flat_to_cube(cache.F_dir, Y), jfp.flat_to_cube(cache.Fc_dir, Y),
        jarr.surf_albedo, jfp.flat_to_cube(jnp.asarray(trigger)[None], Y)[0],
        delta_tau_limit=jphys.delta_tau_limit, **_common(jphys))
    got = tthomas.fband_matrix_noniso(
        _flat_cells(up), _flat_cells(low), _t(B_lay), _t(B_int),
        _t(cache.F_dir), _t(cache.Fc_dir), tarr.surf_albedo,
        torch.from_numpy(trigger), delta_tau_limit=jphys.delta_tau_limit,
        **_common(jphys))
    _check_fluxes(got, want, _beam_scale(cache, [up, low], jphys))


@pytest.mark.parametrize("iso", [True, False], ids=["iso", "noniso"])
def test_absorption_fallback_matches_jax_scans(iso):
    """With scat_trigger unset everywhere the solve is the pure-absorption
    fallback, which the port runs as one pass of the sweep with zero
    coupling: against JAX's _absorption_* lax.scans at 1e-12."""
    jphys, jarr, _, tarr = _models(iso, True)
    cache, B_lay, B_int, _ = _solve_inputs(jphys, jarr)
    Y, L = jphys.ny, jphys.nlayer
    none = torch.zeros(jphys.nbin * Y, dtype=torch.bool)
    cube = lambda x: jfp.flat_to_cube(x, Y)
    alb = jarr.surf_albedo
    toa = jsweep.toa_incident_flux(
        B_lay, dir_beam=jphys.dir_beam, f_factor=jphys.f_factor,
        R_star=jphys.R_star, a=jphys.a)
    B_surf = B_lay[L + 1]
    F_dir = cube(cache.F_dir)
    if iso:
        trans = cube(cache.cells_or_upper.trans)
        B = B_lay[:L][:, :, None]
        down = jthomas._absorption_down(trans, B, toa, jphys.epsi)
        boa = (alb[:, None] * (F_dir[0] + down[0])
               + (1.0 - alb)[:, None] * jpc.PI * B_surf[:, None])
        want = (down, jthomas._absorption_up(trans, B, boa, jphys.epsi))
        got = tthomas.fband_matrix_iso(
            _flat_cells(cache.cells_or_upper), _t(B_lay), _t(cache.F_dir),
            tarr.surf_albedo, none, **_common(jphys))
    else:
        want = jthomas._absorption_noniso(
            jf._matrix_cells(cache.cells_or_upper, Y),
            jf._matrix_cells(cache.lower, Y), B_lay[:L][:, :, None],
            B_int[:, :, None], toa, F_dir, alb, B_surf, epsi=jphys.epsi,
            delta_tau_limit=jphys.delta_tau_limit)
        got = tthomas.fband_matrix_noniso(
            _flat_cells(cache.cells_or_upper), _flat_cells(cache.lower),
            _t(B_lay), _t(B_int), _t(cache.F_dir), _t(cache.Fc_dir),
            tarr.surf_albedo, none, delta_tau_limit=jphys.delta_tau_limit,
            **_common(jphys))
    for g, w in zip(got, want):
        H.assert_close(g.numpy(), np.asarray(jfp.cube_to_flat(w)),
                       rtol=1e-12)


# --------------------------------------------------------------------------- #
# the forward model and the run
# --------------------------------------------------------------------------- #

def _forward_pair(jphys, jarr, tphys, tarr):
    T = H.start_profile(jphys.nlayer)
    want = jax.jit(lambda t: jf.forward_fluxes(jphys, jarr, t)[:2])(
        jnp.asarray(T))
    got = tf.forward_fluxes(tphys, tarr, torch.tensor(T))[:2]
    return got, want


@pytest.mark.parametrize("iso", [True, False], ids=["iso", "noniso"])
def test_matrix_forward_fluxes_match(iso):
    """forward_fluxes with flux_calc_method="matrix" from identical model
    arrays (native fp64 Planck lookup on the JAX side): totals at 1e-12,
    the spectral fluxes to 1e-12 of their scale."""
    jphys, jarr, tphys, tarr = _models(iso, True)
    assert tphys.flux_calc_method == jphys.flux_calc_method == "matrix"
    (flux, totals), (wflux, wtotals) = _forward_pair(jphys, jarr, tphys,
                                                     tarr)
    for f in ("F_up_tot", "F_down_tot"):
        H.assert_close(getattr(totals, f).numpy(), getattr(wtotals, f),
                       rtol=1e-12, err_msg=f)
    for f in tf.FluxState._fields:
        H.assert_close(getattr(flux, f).numpy(), getattr(wflux, f),
                       rtol=1e-12, scale_atol=1e-12, err_msg=f)


def test_default_albedo_bound():
    """With the default surface albedo (1e-8) the BOA downward flux of
    scattering columns carries the elimination's 1e8-fold amplification:
    the port's totals are held to JAX's at 1e-10 (2.2e-11 measured in
    F_down_tot[0]), the upward totals still at 1e-12."""
    kw = dict(MATRIX_RUN, surf_albedo=0.0)
    table = H.small_table(16)
    jphys, jarr = jf.build_model(JaxConfig(**kw).finalize(), table)
    jarr = H.native_planck(jarr)
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    tarr = convert.model_arrays_from_numpy(d, device="cpu")
    tphys = tf.Phys.from_config(TorchConfig(**kw).finalize(), nbin=16, ny=4)
    assert float(tarr.surf_albedo[0]) == 1e-8
    (_, totals), (_, wtotals) = _forward_pair(jphys, jarr, tphys, tarr)
    H.assert_close(totals.F_up_tot.numpy(), wtotals.F_up_tot, rtol=1e-12)
    H.assert_close(totals.F_down_tot.numpy(), wtotals.F_down_tot,
                   rtol=1e-10)


def test_small_matrix_run_matches_jax_pipeline(tmp_path, monkeypatch):
    """pipeline.run of both packages, non-isothermal layers with the
    matrix method and convection, from the same TP file, to convergence
    through both loops: equal convection counts and the final T at rtol
    1e-10 against the JAX run with native fp64 Planck lookups.  The
    radiation counts are chaotic (ROADMAP C)."""
    tp = tmp_path / "start_tp.dat"
    H.write_tp_file(tp, H.start_profile(12))
    cfg = dict(MATRIX_RUN, force_start_tp_from_file="yes",
               temp_format="helios", temp_path=str(tp))
    table = H.small_table(16)

    got = torch_pipeline.run(TorchConfig(**cfg), table, write_output=False,
                             device="cpu")
    assert got.phys.flux_calc_method == "matrix"
    assert got.conv is not None and got.conv.steps > 0
    assert not got.conv.keep_running and not got.conv.aborted
    assert not bool(got.rad.keep_running) and not got.rad.aborted
    T = got.T_lay.numpy()
    assert np.all(np.isfinite(T))

    build = jax_pipeline.build_model
    monkeypatch.setattr(
        jax_pipeline, "build_model",
        lambda *a, **k: (lambda pa: (pa[0], H.native_planck(pa[1])))(
            build(*a, **k)))
    native = jax_pipeline.run(JaxConfig(**cfg), table=table,
                              write_output=False)
    assert got.conv.it == int(native.conv.it)
    assert not bool(native.conv.keep_running)
    np.testing.assert_allclose(T, np.asarray(native.conv.T_lay), rtol=1e-10)
