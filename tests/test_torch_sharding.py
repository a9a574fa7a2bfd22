"""Meshes of the PyTorch port (helios_tpu_torch.parallel.sharding) on the
CPU: the scenarios of tests/test_sharding.py, each against the port's run
on one device and against the JAX package's sharded run on its 8 virtual
CPU devices.

The port puts every slice on the CPU.  There a sliced run differs from
the run on one device in the last bits: torch.sum adds the band totals in
an order that depends on the row's length, and torch's CPU kernels finish
a tensor's tail in scalar code.  So the port's sliced run is held to the
JAX package's own sharded bounds (tests/test_sharding.py,
tests/test_pipeline.py:113): totals 1e-12, T after a few fixed iterations
1e-10, a converged T 1e-6.  On the card every sum runs in index order, and
the total carried from slice to slice is the same chain of adds as over the
whole bin axis: test_carried_total_is_the_one_device_total holds that bit
for bit here, with the card's in-order sum in place of torch.sum.  Against
the JAX package (its two-float32 Planck pairs) the bound is ROADMAP C's
1e-7, converged runs 1e-6.

Measured largest relative differences (against the port on one device;
against JAX): forward totals 2.6e-15; 8.4e-15, its bands 2.3e-11.  Three
batched steps, T 1.0e-12; 1.1e-8.  120 iterations from isothermal
starts 1.8e-14; 2.8e-9.  Both loops, 200 iterations each, 3.7e-13;
1.2e-7 (F_net 2.8e-6).  On-the-fly mixing, 25 iterations, 1.8e-16;
1.6e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import chem as jchem
from helios_tpu import forward as jf
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import synthetic_premixed_table
from helios_tpu.parallel import sharding as jshd
from helios_tpu.rce import radiative as jrad
from helios_tpu_torch import chem as tchem
from helios_tpu_torch import convert
from helios_tpu_torch import fastpath as tfp
from helios_tpu_torch import forward as tf
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.kernels.ordered import in_order_reference
from helios_tpu_torch.ops import slices
from helios_tpu_torch.parallel import ensemble as tens
from helios_tpu_torch.parallel import sharding as tshd
from helios_tpu_torch.rce import radiative as trad
from helios_tpu_torch.rce.loop import convection_loop

import torch_port_helpers as H

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

BASE = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=1.0, T_star=4000.0, T_intern=100.0, scattering="yes",
            direct_beam="no", convection="no", run_type="iterative",
            iso_input="yes", nlayer=10, p_boa=1e8, p_toa=1e3)
CONV = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=30.0, T_star=30.0, T_intern=700.0, scattering="yes",
            direct_beam="no", convection="yes", kappa_value=0.1,
            run_type="iterative", nlayer=12, p_boa=1e9, p_toa=1e3,
            adapt_interval=6)
OTF = dict(BASE, T_intern=200.0, nlayer=8, opacity_mixing="on-the-fly")


def both(cfg_kw, table):
    """(JAX phys, arrays), (port phys, arrays on the CPU) of one config."""
    jphys, jarr = jf.build_model(JaxConfig(**cfg_kw).finalize(), table)
    tphys, tarr = tf.build_model(TorchConfig(**cfg_kw).finalize(), table,
                                 device="cpu")
    return (jphys, jarr), (tphys, tarr)


def base_table():
    return synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                    seed=2)


def conv_table():
    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                     seed=3)
    table.kpoints *= 10.0
    return table


OTF_SPECIES = [("H2O", True, True, "1e-3"), ("CO2", True, False, "1e-4"),
               ("H2", False, True, "0.9"), ("He", False, False, "0.1")]


def otf_sets(donor):
    """The on-the-fly species of tests/test_sharding.py in both packages."""
    kw = dict(ktemps=donor.temperatures, kpress=donor.pressures, nbin=16,
              ny=4, nlayer=8,
              opacity_tables={"H2O": donor.kpoints,
                              "CO2": donor.kpoints * 3.0},
              scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4})
    jset = jchem.build_species_set(
        [jchem.SpeciesSpec(*s) for s in OTF_SPECIES], **kw)
    tset = tchem.build_species_set(
        [tchem.SpeciesSpec(*s) for s in OTF_SPECIES], device="cpu", **kw)
    return jset, tset


T_FWD = np.linspace(1500.0, 800.0, 11)
T0S = np.stack([np.full(11, 900.0), np.full(11, 1400.0)])
T_CONV = np.linspace(1500.0, 500.0, 13)
T_OTF = np.linspace(1500.0, 700.0, 9)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's sharded runs of tests/test_sharding.py:34-216."""
    (jphys, jarr), _ = both(BASE, base_table())
    mesh24 = jshd.make_mesh(n_planet=2, n_spectral=4)
    m24 = jshd.place_model(jarr, mesh24)
    out = dict(forward=jshd.sharded_forward(jphys, mesh24)(
        m24, jnp.asarray(T_FWD)))
    init, step = jshd.batched_rce_step(jphys, mesh24, None)
    state = init(m24, jnp.asarray(T0S))
    for _ in range(3):
        state = step(m24, state)
    out["batched"] = state
    T0_loop = jnp.stack([jnp.full(11, 900.0 + 150.0 * p) for p in range(2)])
    out["loop120"] = jshd.sharded_radiation_loop(
        jphys, mesh24, None, max_steps=120)(m24, T0_loop)

    mesh14 = jshd.make_mesh(n_planet=1, n_spectral=4,
                            devices=jax.devices()[:4])
    (cphys, carr), _ = both(CONV, conv_table())
    thermo = jrad.make_const_thermo(0.1)
    rad_init, rad_run, conv_enter, conv_run = jshd.production_runners(
        cphys, mesh14, thermo, None, chunk_iters=200)
    mc = jshd.place_model(carr, mesh14)
    rad = rad_run(mc, (), rad_init(mc, (), jnp.asarray(T_CONV)))
    out["rad200"] = rad
    out["conv200"] = conv_run(mc, (), conv_enter(mc, (), rad))

    donor = synthetic_premixed_table(nbin=16, ny=4, ntemp=8, npress=6,
                                     seed=1)
    jset, _ = otf_sets(donor)
    ophys, oarr = jf.build_model(JaxConfig(**OTF).finalize(), donor)
    sset_sh = jshd.place_species(jset, mesh14)
    rad_init, rad_run, _, _ = jshd.production_runners(
        ophys, mesh14, None, sset_sh, chunk_iters=25)
    mo = jshd.place_model(oarr, mesh14)
    sarr = jshd.sset_arrays(sset_sh)
    out["otf25"] = rad_run(mo, sarr, rad_init(mo, sarr, jnp.asarray(T_OTF)))
    return out


def mesh(n_planet, n_spectral):
    return tshd.make_mesh(n_planet, n_spectral, devices="cpu")


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_make_mesh_rows_and_device_lists():
    m = tshd.make_mesh(2, 3, devices="cpu")
    assert m.shape == {"planet": 2, "spectral": 3}
    assert all(d.type == "cpu" for row in m.devices for d in row)
    m = tshd.make_mesh(1, None, devices=["cpu", "cpu"])
    assert m.shape == {"planet": 1, "spectral": 2}
    with pytest.raises(ValueError, match="devices"):
        tshd.make_mesh(1, 3, devices=["cpu", "cpu"])


def test_sharded_forward_matches_single_device(jax_runs):
    """The forward model over a 2 x 4 mesh: its totals against the port on
    one device at 1e-12 and against JAX's sharded forward at 1e-7."""
    _, (phys, arrays) = both(BASE, base_table())
    want = tf.forward_fluxes(phys, arrays, t(T_FWD))[1]
    got = tshd.sharded_forward(phys, mesh(2, 4))(
        tshd.place_model(arrays, mesh(2, 4)), t(T_FWD))
    H.assert_close(got.F_net, want.F_net, rtol=1e-12)
    H.assert_close(got.F_up_band, want.F_up_band, rtol=1e-12)
    jwant = jax_runs["forward"]
    H.assert_close(got.F_net, jwant.F_net, rtol=1e-7)
    H.assert_close(got.F_up_band, jwant.F_up_band, rtol=1e-7)


def test_batched_rce_step_matches_per_planet_loop(jax_runs):
    """Three radiation iterations of two planets over a 2 x 4 mesh (one
    planet per planet position): each planet against its loop on one
    device (T 1e-10) and against JAX's batched step (T 1e-7)."""
    _, (phys, arrays) = both(BASE, base_table())
    m = tshd.place_model(tens.stack_models([arrays] * 2), mesh(2, 4))
    init, step = tshd.batched_rce_step(phys, mesh(2, 4), None)
    state = init(m, t(T0S.T))
    for _ in range(3):
        state = step(m, state)
    jstate = jax_runs["batched"]
    for p in range(2):
        want = trad.radiation_loop(phys, arrays, None, t(T0S[p]),
                                   max_steps=3)
        assert int(state.it[p]) == want.it == int(jstate.it[p]) == 3
        H.assert_close(state.T_lay[:, p], want.T_lay, rtol=1e-10)
        H.assert_close(state.totals.F_net[:, p], want.totals.F_net,
                       rtol=1e-8)
        H.assert_close(state.T_lay[:, p], jstate.T_lay[p], rtol=1e-7)


def test_sharded_radiation_loop_matches_single_device(jax_runs):
    """120 iterations of the radiation loop over a 2 x 4 mesh from
    isothermal starts, where the adaptive |F|^0.1 step amplifies the last
    bits of the totals (tests/test_sharding.py): the iteration counts equal,
    T within JAX's own sharded bound 1e-8 of the port on one device and
    within 1e-6 of JAX's sharded loop."""
    _, (phys, arrays) = both(BASE, base_table())
    T0 = np.stack([np.full(11, 900.0 + 150.0 * p) for p in range(2)])
    m = tshd.place_model(tens.stack_models([arrays] * 2), mesh(2, 4))
    state = tshd.sharded_radiation_loop(phys, mesh(2, 4), None,
                                        max_steps=120)(m, t(T0.T))
    jstate = jax_runs["loop120"]
    for p in range(2):
        want = trad.radiation_loop(phys, arrays, None, t(T0[p]),
                                   max_steps=120)
        assert int(state.it[p]) == want.it == int(jstate.it[p])
        H.assert_close(state.T_lay[:, p], want.T_lay, rtol=1e-8)
        H.assert_close(state.T_lay[:, p], jstate.T_lay[p], rtol=1e-6)


def test_production_runners_full_rce_matches_single(jax_runs):
    """Both loops of a non-isothermal convective run on four slices, 200
    iterations each: the counts equal those of the port on one device and
    of JAX's production runners, T within 1e-6 of both, the convective
    zones equal."""
    _, (phys, arrays) = both(CONV, conv_table())
    thermo = trad.make_const_thermo(0.1)
    mesh14 = mesh(1, 4)
    rad_init, rad_run, conv_enter, conv_run = tshd.production_runners(
        phys, mesh14, thermo, None, chunk_iters=200)
    m = tshd.place_model(arrays, mesh14)
    state = rad_run(m, rad_init(m, t(T_CONV)))
    cstate = conv_enter(m, state)
    assert cstate.keep_running, "no convective instability in the test"
    cstate = conv_run(m, cstate)

    want_rad = trad.radiation_loop(phys, arrays, thermo, t(T_CONV),
                                   max_steps=200)
    want_conv = convection_loop(phys, arrays, thermo, want_rad,
                                max_steps=200)
    jrad_, jconv = jax_runs["rad200"], jax_runs["conv200"]
    assert state.it == want_rad.it == int(jrad_.it)
    assert cstate.it == want_conv.it == int(jconv.it)
    for got, want in ((state, want_rad), (cstate, want_conv),
                      (state, jrad_), (cstate, jconv)):
        H.assert_close(got.T_lay, want.T_lay, rtol=1e-6)
    net = np.asarray(jconv.totals.F_net)
    H.assert_close(cstate.totals.F_net, net, rtol=1e-5,
                   scale_atol=1e-5)
    np.testing.assert_array_equal(cstate.conv_layer.numpy(),
                                  want_conv.conv_layer.numpy())
    np.testing.assert_array_equal(cstate.conv_layer.numpy(),
                                  np.asarray(jconv.conv_layer))


def test_production_runners_on_the_fly_sharded(jax_runs):
    """On-the-fly Random Overlap mixing on four slices, the species tables
    split by bins: 25 iterations, T within 1e-10 of the port on one device
    and 1e-7 of JAX's sharded run."""
    donor = synthetic_premixed_table(nbin=16, ny=4, ntemp=8, npress=6,
                                     seed=1)
    _, tset = otf_sets(donor)
    phys, arrays = tf.build_model(TorchConfig(**OTF).finalize(), donor,
                                  device="cpu")
    mesh14 = mesh(1, 4)
    rad_init, rad_run, _, _ = tshd.production_runners(
        phys, mesh14, None, tshd.place_species(tset, mesh14),
        chunk_iters=25)
    m = tshd.place_model(arrays, mesh14)
    state = rad_run(m, rad_init(m, t(T_OTF)))
    want = trad.radiation_loop(phys, arrays, None, t(T_OTF), max_steps=25,
                               sset=tset)
    jstate = jax_runs["otf25"]
    assert state.it == want.it == int(jstate.it) == 25
    H.assert_close(state.T_lay, want.T_lay, rtol=1e-10)
    H.assert_close(state.totals.F_net, want.totals.F_net, rtol=1e-8)
    H.assert_close(state.T_lay, jstate.T_lay, rtol=1e-7)


def test_padding_matches_jax_element_for_element():
    """pad_spectral, pad_species and strip_flux on the same arrays: 21
    bins padded to 24 (and 21 on 3 slices, no padding) equal JAX's."""
    table = synthetic_premixed_table(nbin=21, ny=4, ntemp=10, npress=8,
                                     seed=5)
    (jphys, jarr), (tphys, _) = both(BASE, table)
    tarr = convert.model_arrays_from_numpy(
        {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}, device="cpu")
    for n in (4, 3):
        jp, jm = jshd.pad_spectral(jphys, jarr, n)
        tp, tm = tshd.pad_spectral(tphys, tarr, n)
        assert tp.nbin == jp.nbin == tshd.padded_nbin(21, n)
        for f in tf.ModelArrays._fields:
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)),
                                          err_msg=f)
    donor = synthetic_premixed_table(nbin=21, ny=4, ntemp=8, npress=6,
                                     seed=1)
    kw = dict(ktemps=donor.temperatures, kpress=donor.pressures, nbin=21,
              ny=4, nlayer=8, opacity_tables={"H2O": donor.kpoints},
              scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4})
    specs = OTF_SPECIES[:1] + OTF_SPECIES[2:3]
    jset = jshd.pad_species(jchem.build_species_set(
        [jchem.SpeciesSpec(*s) for s in specs], **kw), 4)
    tset = tshd.pad_species(tchem.build_species_set(
        [tchem.SpeciesSpec(*s) for s in specs], device="cpu", **kw), 4)
    for jd, td in zip(jset.data, tset.data):
        for f in tchem.SpeciesDeviceData._fields:
            np.testing.assert_array_equal(getattr(td, f).numpy(),
                                          np.asarray(getattr(jd, f)),
                                          err_msg=f)
    rng = np.random.default_rng(0)
    flux = [rng.random((11, 96)), rng.random((11, 96)),
            rng.random((10, 96)), rng.random((10, 96))]
    jflux = jshd.strip_flux(jf.FluxState(*map(jnp.asarray, flux)), 21, 4)
    tflux = tshd.strip_flux(tf.FluxState(*map(t, flux)), 21, 4)
    for g, w in zip(tflux, jflux):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_carried_total_is_the_one_device_total(n, monkeypatch):
    """integrate_flux_flat over n slices (21 bins padded to a multiple of
    n, the padded bins copies of the last) with the card's in-order sum
    (in_order_reference) in place of torch.sum: the totals bit for bit
    those over the whole bin axis, each slice's sum starting from the
    slices before it, and the bands the same."""
    in_order = lambda x, dim: in_order_reference(x, dim, scan=False)
    monkeypatch.setattr(tf, "ordered_sum", in_order)
    monkeypatch.setattr(tfp, "ordered_sum", in_order)
    table = synthetic_premixed_table(nbin=21, ny=4, ntemp=10, npress=8,
                                     seed=5)
    _, (phys, arrays) = both(dict(BASE, iso_input="no"), table)
    flux, _, cache = tf.forward_fluxes(phys, arrays, t(T_FWD))
    want = tf.integrate_flux_flat(phys, arrays, flux, cache.F_dir)

    pphys, parr = tshd.pad_spectral(phys, arrays, n)
    nb = pphys.nbin - 21
    pad = lambda x: tshd._edge_pad(x.reshape(x.shape[:-1] + (21, 4)), -2,
                                   nb).reshape(x.shape[:-1] + (-1,))
    m = tshd.place_model(parr, mesh(1, n))[0]
    devs = slices.devices(m)
    got = tf.integrate_flux_flat(
        pphys, m, tf.FluxState(*(slices.split(pad(x), devs) for x in flux)),
        slices.split(pad(cache.F_dir), devs))
    assert isinstance(got.F_up_band, slices.Slices) and slices.count(m) == n
    for f in ("F_up_tot", "F_down_tot", "F_net"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    whole = slices.gather(got, torch.device("cpu"))
    for f in ("F_down_band", "F_up_band", "F_dir_band"):
        assert torch.equal(getattr(whole, f)[..., :21], getattr(want, f)), f
