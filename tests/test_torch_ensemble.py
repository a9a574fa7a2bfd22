"""Planet ensembles of the PyTorch port (helios_tpu_torch.parallel.ensemble)
on the CPU, against the JAX package's ensembles and against the port's own
runs of one planet.

A batch runs every member's arithmetic in the same operations as a run of
its own (the per-layer transcendental functions member by member on the
CPU, helios_tpu_torch/ops/members.py), so a member equals its solo run bit
for bit, also a member that converges while the others iterate on.
Against JAX's ``run_ensemble`` the members hold ROADMAP C's solo bounds:
final T at 1e-7 against the unmodified JAX package (its two-float32 Planck
pairs), 1e-10 against its native-fp64 lookup, equal convection counts.
The radiation loop's count is chaotic in this scenario (tests/
test_torch_rce.py) and is compared only within the port.

The small scenario: tests/torch_port_helpers.py's run at 10 layers, 16
bins x 4 Gauss points, two members that differ in surf_albedo and
converge at different radiation iterations.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import checkpoint as jck
from helios_tpu import examples as jexamples
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.config import config_from_cli as jax_config_from_cli
from helios_tpu.io.opacity import save_opacity_file
from helios_tpu.parallel import ensemble as jens
from helios_tpu_torch import checkpoint as ck
from helios_tpu_torch import convert
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.__main__ import main as torch_main
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.config import config_from_cli as torch_config_from_cli
from helios_tpu_torch.ops.members import member_state
from helios_tpu_torch.parallel import ensemble as tens
from helios_tpu_torch.rce import radiative as trad
from helios_tpu_torch.rce.loop import convection_loop

import torch_port_helpers as H
from test_torch_clouds import write_mie_dir

L = 10
ALBEDOS = {"ens_a": "0.0", "ens_b": "0.6"}


def small_table():
    return H.small_table(nbin=16)


def cli_args(d):
    """The small scenario as command-line flags, with its files in ``d``
    (opacity table, start profile, ensemble file)."""
    save_opacity_file(str(d / "opac.h5"), small_table())
    H.write_tp_file(d / "start_tp.dat", H.start_profile(L))
    (d / "planets.dat").write_text(
        "# per-planet overrides\nname surf_albedo\n"
        + "".join(f"{n} {a}\n" for n, a in ALBEDOS.items()))
    return ["-planet_ensemble_file", str(d / "planets.dat"), "-name", "base",
            "-planet", "manual", "-surface_gravity", "2288.0",
            "-orbital_distance", "0.0153", "-radius_planet", "1.0",
            "-radius_star", "30.0", "-temperature_star", "30.0",
            "-internal_temperature", "700.0", "-scattering", "yes",
            "-direct_irradiation_beam", "no", "-convective_adjustment",
            "yes", "-kappa_value", "0.1", "-run_type", "iterative",
            "-number_of_layers", str(L), "-boa_pressure", "1e9",
            "-toa_pressure", "1e3", "-adaptive_interval", "6",
            "-path_to_opacity_file", str(d / "opac.h5"),
            "-start_from_provided_tp_profile", "yes",
            "-path_to_temperature_file", str(d / "start_tp.dat"),
            "-temperature_file_format", "helios"]


def configs(config_from_cli, parse, from_rows, argv, out_dir):
    base = config_from_cli(argv + ["-output_directory", str(out_dir) + "/"],
                           finalize=False)
    return from_rows(base, parse(base.planet_ensemble_file))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-member ensemble through JAX's command-line path
    (configs_from_ensemble + run_ensemble: the unmodified package, and
    with the output files its native-fp64 Planck lookup, for the tighter
    bound) and through the port's run_ensemble; and each member alone
    through the port's pipeline.run."""
    d = tmp_path_factory.mktemp("ensemble")
    argv = cli_args(d)
    jcfgs = configs(jax_config_from_cli, jens.parse_ensemble_file,
                    jens.configs_from_ensemble, argv, d / "jax")
    jpairs = jens.run_ensemble(jcfgs, write_output=False)
    with pytest.MonkeyPatch.context() as mp:
        H.native_build(mp)
        jnative = jens.run_ensemble(jcfgs)
    tcfgs = configs(torch_config_from_cli, tens.parse_ensemble_file,
                    tens.configs_from_ensemble, argv, d / "torch")
    touts = tens.run_ensemble(tcfgs, write_output=False, device="cpu")
    solos = [torch_pipeline.run(c, write_output=False, device="cpu")
             for c in tcfgs]
    return dict(dir=d, argv=argv, jpairs=jpairs, jnative=jnative,
                touts=touts, solos=solos, tcfgs=tcfgs)


# --------------------------------------------------------------------------- #
# (a, b) the ensemble file, the configs and the shared physics
# --------------------------------------------------------------------------- #

ENSEMBLE_FILES = {
    "template": jexamples.ENSEMBLE_TEMPLATE,
    "header_only": "# nothing but a header\nname surf_albedo\n",
    "empty": "# only comments\n\n",
    "unknown_field": "name no_such_field\na 1\n",
    "short_row": "name surf_albedo\na 0.1\nb\n",
    "duplicate_names": "name surf_albedo\na 0.1\na 0.2\n",
    "unnamed": "surf_albedo T_intern\n0.1 300\n0.2 400\n",
}


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("case", sorted(ENSEMBLE_FILES))
def test_ensemble_file_parses_as_in_jax(case, tmp_path):
    """parse_ensemble_file and configs_from_ensemble (the port's copies):
    the same rows and configs, or the same error text, as JAX's."""
    path = tmp_path / "planets.dat"
    path.write_text(ENSEMBLE_FILES[case])

    def run(parse, from_rows, cfg_cls):
        rows = parse(str(path))
        cfgs = from_rows(cfg_cls(nlayer=6), rows)
        return rows, [(c.name, c.surf_albedo, c.T_intern) for c in cfgs]

    got = _outcome(lambda: run(tens.parse_ensemble_file,
                               tens.configs_from_ensemble, TorchConfig))
    want = _outcome(lambda: run(jens.parse_ensemble_file,
                                jens.configs_from_ensemble, JaxConfig))
    assert got == want
    if case == "template":
        assert got[0] == "ok" and len(got[1][1]) == 3


def test_mismatched_phys_raises_as_in_jax(tmp_path):
    """Members must share Phys: the same ValueError as helios_tpu's
    (tests/test_sharding.py:264)."""
    table = small_table()
    kw = dict(output_dir=str(tmp_path) + "/", **dict(H.SMALL_RUN, nlayer=L))
    cfgs = [dict(name="x", **kw), dict(name="y", **dict(kw, T_star=40.0))]
    with pytest.raises(ValueError) as want:
        jens.run_ensemble([JaxConfig(**c) for c in cfgs],
                          tables=[table, table], write_output=False)
    with pytest.raises(ValueError) as got:
        tens.run_ensemble([TorchConfig(**c) for c in cfgs],
                          tables=[table, table], write_output=False,
                          device="cpu")
    assert str(got.value) == str(want.value)
    assert "compile-time physics" in str(got.value)


# --------------------------------------------------------------------------- #
# (c, d, e) the batched loops
# --------------------------------------------------------------------------- #

def test_members_match_jax_run_ensemble(runs):
    """Each member's final T and convection count against JAX's ensemble:
    1e-7 against the unmodified package, 1e-10 against its native-fp64
    Planck lookup (ROADMAP C's solo bounds)."""
    for got, pairs, native in zip(runs["touts"], runs["jpairs"],
                                  runs["jnative"]):
        assert got.conv is not None and got.conv.steps > 0
        assert not got.conv.keep_running and not got.conv.aborted
        T = got.T_lay.numpy()
        np.testing.assert_allclose(T, np.asarray(pairs.conv.T_lay),
                                   rtol=1e-7)
        np.testing.assert_allclose(T, np.asarray(native.conv.T_lay),
                                   rtol=1e-10)
        assert got.conv.it == int(native.conv.it)
    a, b = (o.T_lay.numpy() for o in runs["touts"])
    assert np.abs(a - b).max() > 1.0       # the members differ


def _same_tree(got, want, where):
    if hasattr(want, "_fields"):
        for f in want._fields:
            _same_tree(getattr(got, f), getattr(want, f), f"{where}.{f}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    else:
        assert got == want, where


def test_members_equal_their_solo_runs_bitwise(runs):
    """Every member of the batch equals the port's run of it alone, bit for
    bit: T, the iteration counts, and the whole final state of both loops.
    The members stop their radiation loops at different iterations, so the
    one that converges first keeps its exact state while the other
    iterates on (the JAX package's vmap of its while_loop)."""
    its = [o.rad.it for o in runs["touts"]]
    assert its[0] != its[1]
    for got, solo in zip(runs["touts"], runs["solos"]):
        assert torch.equal(got.T_lay, solo.T_lay)
        assert (got.rad.it, got.conv.it, got.conv.steps) == (
            solo.rad.it, solo.conv.it, solo.conv.steps)
        assert got.n_flux_solves == solo.n_flux_solves
        _same_tree(got.rad, solo.rad, "rad")
        _same_tree(got.conv, solo.conv, "conv")


def test_a_member_that_stops_first_keeps_its_state(runs):
    """The batch stepped past the first member's last radiation iteration:
    after the other member's, the first member's radiation state is still
    its solo run's final one."""
    tcfgs = runs["tcfgs"]
    physes, models, T0s = [], [], []
    for c in tcfgs:
        phys, arrays, _ = torch_pipeline.prepare_model(c, small_table(),
                                                       device="cpu")
        models.append(arrays)
        T0s.append(torch_pipeline.initial_temperatures(c, phys, arrays))
    its = [o.rad.it for o in runs["solos"]]
    first, last = int(np.argmin(its)), int(np.argmax(its))
    T0 = torch.tensor(np.stack(T0s, axis=1))
    rad = trad.radiation_loop(phys, tens.stack_models(models),
                              trad.make_const_thermo(0.1), T0,
                              max_steps=its[first] + 10)
    assert list(rad.it) == [min(i, its[first] + 10) for i in its]
    assert bool(rad.keep_running[last]) and not bool(rad.keep_running[first])
    _same_tree(member_state(rad, first), runs["solos"][first].rad,
               "rad")


# --------------------------------------------------------------------------- #
# (f) one batched flux solve per method
# --------------------------------------------------------------------------- #

def _species_set(L_, donor):
    """An on-the-fly species set: H2O (own Rayleigh formula) and CO2
    absorbing with VMR profiles, H2 scattering, He."""
    from helios_tpu_torch import chem
    specs = [("He", False, False, "0.1"), ("H2O", True, True, "1e-3"),
             ("CO2", True, False, "1e-4"), ("H2", False, True, "0.9")]
    return chem.build_species_set(
        [chem.SpeciesSpec(*s) for s in specs], ktemps=donor.temperatures,
        kpress=donor.pressures, nbin=donor.nbin, ny=donor.ny, nlayer=L_,
        opacity_tables={"H2O": donor.kpoints, "CO2": donor.kpoints * 3.0},
        scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4},
        device="cpu")


@pytest.mark.parametrize("method", ["noniso", "iso", "matrix", "matrix_iso",
                                    "on_the_fly", "on_the_fly_iso",
                                    "cloudy_zenith"])
def test_batched_forward_fluxes_equal_the_solo_ones(method, tmp_path):
    """forward_fluxes of a batch of two planets (other albedos and
    profiles) against the two solo calls, bit for bit: one flux solve for
    the batch."""
    kw = dict(H.SMALL_RUN, nlayer=L)
    sset = None
    table = small_table()
    if method in ("iso", "matrix_iso", "on_the_fly_iso"):
        kw["iso_input"] = "yes"
    if method.startswith("matrix"):
        kw["flux_calc_method"] = "matrix"
    if method.startswith("on_the_fly"):
        kw["opacity_mixing"] = "on-the-fly"
        table = H.small_table(nbin=16)
        sset = _species_set(L, table)
    if method == "cloudy_zenith":
        mie = write_mie_dir(str(tmp_path / "deck"), 1e-8, 0.9)
        kw.update(R_star=0.805, T_star=5040.0, a=0.03142, direct_beam="yes",
                  zenith_angle_deg=80.0, nr_cloud_decks=1, mie_dirs=[mie],
                  cloud_radius_mode=[1.0], cloud_radius_geo_std=[1.5],
                  cloud_mixing_ratio_source="manual",
                  cloud_bottom_pressure=[1e7],
                  cloud_bottom_mixing_ratio=[2e-19],
                  cloud_to_gas_scale_height=[0.8])
    models, Ts = [], []
    for k, albedo in enumerate((0.1, 0.7)):
        cfg = TorchConfig(**kw, surf_albedo=albedo).finalize()
        phys, arrays, _ = torch_pipeline.prepare_model(cfg, table,
                                                       device="cpu")
        models.append(arrays)
        Ts.append(torch.tensor(H.start_profile(L) * (1.0 + 0.05 * k)))
    if method == "cloudy_zenith":
        assert phys.clouds and phys.geom_zenith_corr
    got = tf.forward_fluxes(phys, tens.stack_models(models),
                            torch.stack(Ts, dim=1), sset=sset)
    for k, (arrays, T) in enumerate(zip(models, Ts)):
        want = tf.forward_fluxes(phys, arrays, T, sset=sset)
        for part, g, w in zip(("flux", "totals"), got[:2], want[:2]):
            for f in w._fields:
                assert torch.equal(getattr(g, f)[:, k], getattr(w, f)), (
                    part, f)


# --------------------------------------------------------------------------- #
# (g, h) thermodynamics tables and cloud decks
# --------------------------------------------------------------------------- #

def _thermo_table(path):
    """The kappa / c_p / entropy table of tests/test_sharding.py:341."""
    temps = [100.0 * (i + 1) for i in range(12)]
    press = [10.0 ** e for e in range(3, 10)]
    lines = ["# synthetic kappa/cp/entropy table", "# T P kappa cp log10S"]
    for T, p in itertools.product(temps, press):
        lines.append(f"{T} {p} {0.28 + 0.0001 * (T / 100.0)} 1.3e8 "
                     f"{9.0 + T * 1e-4}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_table_thermodynamics_with_convection(tmp_path, monkeypatch):
    """tests/test_sharding.py:335's scenario (kappa and c_p from a table,
    two albedos) at a criterion of 1e-3 (at its 1e-5 the convection loop
    takes 15000 iterations): the final T and convection count of each
    member against JAX's ensemble (native-fp64 Planck lookup) at 1e-10,
    the second member bit for bit its solo run, and the entropy
    diagnostics from the table."""
    table = H.small_table(nbin=16)
    kw = dict(output_dir=str(tmp_path) + "/", planet="manual", g=2288.0,
              a=0.0153, R_planet=1.0, R_star=1.0, T_star=30.0,
              T_intern=700.0, scattering="no", direct_beam="no",
              convection="yes", kappa_value="file",
              kappa_file_path=_thermo_table(tmp_path / "thermo.dat"),
              run_type="iterative", nlayer=8, p_boa=1e9, p_toa=1e4,
              rad_convergence_limit=1e-3)
    names = {"th_a": 0.0, "th_b": 0.5}
    tcfgs = [TorchConfig(name=n, surf_albedo=a, **kw)
             for n, a in names.items()]
    outs = tens.run_ensemble(tcfgs, tables=[table, table],
                             write_output=False, device="cpu")
    H.native_build(monkeypatch)
    jouts = jens.run_ensemble([JaxConfig(name=n, surf_albedo=a, **kw)
                               for n, a in names.items()],
                              tables=[table, table], write_output=False)
    for got, want in zip(outs, jouts):
        assert got.conv is not None and got.conv.steps > 0
        np.testing.assert_allclose(got.T_lay.numpy(),
                                   np.asarray(want.conv.T_lay), rtol=1e-10)
        assert got.conv.it == int(want.conv.it)
        assert np.all(got.result.entropy_lay > 0)
    solo = torch_pipeline.run(tcfgs[1], table, write_output=False,
                              device="cpu")
    assert torch.equal(outs[1].T_lay, solo.T_lay)
    assert (outs[1].rad.it, outs[1].conv.it) == (solo.rad.it, solo.conv.it)


def test_cloudy_member_writes_its_solo_file_set(tmp_path):
    """A cloudy member with the zenith-corrected beam (tests/
    test_sharding.py:524): its files, the cloud files among them, are
    those its run alone writes, number for number."""
    mie = write_mie_dir(str(tmp_path / "deck"), 1e-8, 0.9)
    kw = dict(H.SMALL_RUN, nlayer=L, R_star=0.805, T_star=5040.0,
              a=0.03142, direct_beam="yes", zenith_angle_deg=80.0,
              iso_input="yes", convection="no", nr_cloud_decks=1,
              mie_dirs=[mie], cloud_radius_mode=[1.0],
              cloud_radius_geo_std=[1.5], cloud_mixing_ratio_source="manual",
              cloud_bottom_pressure=[1e7], cloud_bottom_mixing_ratio=[2e-19],
              cloud_to_gas_scale_height=[0.8], rad_convergence_limit=1e-6)
    H.write_tp_file(tmp_path / "tp.dat", H.start_profile(L))
    kw.update(force_start_tp_from_file="yes", temp_format="helios",
              temp_path=str(tmp_path / "tp.dat"))
    table = small_table()
    members = (("cl_a", 0.1), ("cl_b", 0.5))
    mk = lambda n, a, out: TorchConfig(name=n, surf_albedo=a, **kw,
                                       output_dir=str(tmp_path / out) + "/")
    cfgs = [mk(n, a, "ens") for n, a in members]
    outs = tens.run_ensemble(cfgs, tables=[table, table], device="cpu")
    for (n, a), cfg, out in zip(members, cfgs, outs):
        assert out.phys.clouds and out.phys.geom_zenith_corr
        solo = torch_pipeline.run(mk(n, a, "solo"), table, device="cpu")
        assert torch.equal(out.T_lay, solo.T_lay)
        got_dir = tmp_path / "ens" / cfg.name
        want_dir = tmp_path / "solo" / cfg.name
        files = sorted(os.listdir(want_dir))
        assert sorted(os.listdir(got_dir)) == files
        assert any("cloud" in f for f in files)
        for name in files:
            assert (got_dir / name).read_text() == (
                want_dir / name).read_text(), name


# --------------------------------------------------------------------------- #
# (i) checkpoints
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def batch():
    """The two members' models in both packages (the port's arrays carried
    over from JAX's, whose Planck lookups take its native-fp64 branch),
    JAX's batched state after 40 radiation iterations and 20 convection
    iterations, and JAX's batched runners."""
    table = small_table()
    jphys, jms, tms, T0s = None, [], [], []
    for albedo in (0.0, 0.6):
        cfg = dict(H.SMALL_RUN, nlayer=L, surf_albedo=albedo)
        jphys, jarr, _ = jax_pipeline.prepare_model(
            JaxConfig(**cfg).finalize(), table)
        jarr = H.native_planck(jarr)
        jms.append(jarr)
        tms.append(convert.model_arrays_from_numpy(
            {k: v for k, v in H.nested_numpy(jarr).items()
             if k != "planck_grid_pairs"}, device="cpu"))
        T0s.append(H.start_profile(L))
    tphys = tf.Phys.from_config(TorchConfig(**cfg).finalize(), nbin=16,
                                ny=4)
    thermo = jax_pipeline.make_thermo(JaxConfig(**cfg).finalize())
    init, rad_step, conv_enter, conv_step = jens._batched_runners(
        jphys, thermo, None, None, 20)
    jm = jens.stack_models(jms)
    rad40 = rad_step(jm, (), rad_step(jm, (), init(jm, (),
                                                   jnp.asarray(T0s))))
    conv20 = conv_step(jm, (), conv_enter(jm, (), rad40))
    return dict(jphys=jphys, jm=jm, tphys=tphys, tm=tens.stack_models(tms),
                thermo=trad.make_const_thermo(0.1), init=init,
                rad_step=rad_step, conv_step=conv_step, rad40=rad40,
                conv20=conv20, T0=torch.tensor(np.stack(T0s, axis=1)))


def test_batched_checkpoints_resume_bitwise(batch, tmp_path):
    """The port's batch: 40 radiation iterations, the file, and 20 more
    from it, bit for bit the 60 straight ones; the same in the convection
    loop (20 steps, the file, 20 more against 40)."""
    phys, m, thermo = batch["tphys"], batch["tm"], batch["thermo"]
    rad40 = trad.radiation_loop(phys, m, thermo, batch["T0"], max_steps=40)
    path = str(tmp_path / "ensemble.ckpt.npz")
    ck.save_rad_checkpoint(path, rad40, phys)
    resumed = trad.radiation_loop(
        phys, m, thermo, None, max_steps=20,
        state0=ck.restore_rad_state(phys, m, ck.load_rad_checkpoint(path)))
    straight = trad.radiation_loop(phys, m, thermo, None, max_steps=20,
                                   state0=rad40)
    assert list(resumed.it) == [60, 60]
    _same_tree(resumed.flux, straight.flux, "flux")
    assert torch.equal(resumed.T_lay, straight.T_lay)

    conv0 = convection_loop(phys, m, thermo, straight, max_steps=0)
    assert np.asarray(conv0.keep_running).all()
    conv20 = convection_loop(phys, m, thermo, None, max_steps=20,
                             state0=conv0)
    cpath = str(tmp_path / "ensemble_conv.ckpt.npz")
    ck.save_conv_checkpoint(cpath, conv20, phys)
    restored = ck.restore_conv_state(phys, m, ck.load_conv_checkpoint(cpath))
    got = convection_loop(phys, m, thermo, None, max_steps=20,
                          state0=restored)
    want = convection_loop(phys, m, thermo, None, max_steps=20,
                           state0=conv20)
    assert list(got.it) == list(want.it) == [40, 40]
    assert torch.equal(got.T_lay, want.T_lay)
    assert torch.equal(got.prefactor, want.prefactor)


def test_port_continues_a_jax_ensemble_checkpoint_as_jax_does(batch,
                                                              tmp_path):
    """JAX's ensemble checkpoints (leading planet axis) restore in the port
    and continue as JAX continues them: 20 more radiation iterations and
    20 more convection steps, T at 1e-10 (JAX's native-fp64 Planck
    lookup; with its two-float32 pairs the convective adjustment carries
    their 3e-8 to 2e-6 of T in 20 steps)."""
    phys, m, thermo = batch["tphys"], batch["tm"], batch["thermo"]
    rpath = str(tmp_path / "j.ckpt.npz")
    jck.save_rad_checkpoint(rpath, batch["rad40"], batch["jphys"])
    ckpt = ck.load_rad_checkpoint(rpath)
    assert ckpt["T_lay"].shape == (2, L + 1) and ckpt["it"].shape == (2,)
    want = batch["rad_step"](batch["jm"], (), jens._restore_batched_rad(
        batch["jphys"], batch["init"], batch["jm"], (), ckpt))
    got = trad.radiation_loop(phys, m, thermo, None, max_steps=20,
                              state0=ck.restore_rad_state(phys, m, ckpt))
    assert list(got.it) == [int(i) for i in want.it] == [60, 60]
    H.assert_close(got.T_lay.numpy().T, want.T_lay, rtol=1e-10)

    cpath = str(tmp_path / "j_conv.ckpt.npz")
    jck.save_conv_checkpoint(cpath, batch["conv20"], batch["jphys"])
    cckpt = ck.load_conv_checkpoint(cpath)
    want = batch["conv_step"](batch["jm"], (), jens._restore_batched_conv(
        batch["jphys"], batch["jm"], None, cckpt))
    got = convection_loop(phys, m, thermo, None, max_steps=20,
                          state0=ck.restore_conv_state(phys, m, cckpt))
    assert list(got.it) == [int(i) for i in want.it]
    H.assert_close(got.T_lay.numpy().T, want.T_lay, rtol=1e-10)


def test_port_ensemble_checkpoints_load_in_jax(batch, tmp_path):
    """The port's files of the batched states restored from JAX's have
    JAX's keys, dtypes, shapes and values, and JAX's loader reads them."""
    phys, m = batch["tphys"], batch["tm"]
    for name, jsave, save, restore, jstate in (
            ("r", jck.save_rad_checkpoint, ck.save_rad_checkpoint,
             ck.restore_rad_state, batch["rad40"]),
            ("c", jck.save_conv_checkpoint, ck.save_conv_checkpoint,
             ck.restore_conv_state, batch["conv20"])):
        jpath = str(tmp_path / f"{name}_jax.ckpt.npz")
        jsave(jpath, jstate, batch["jphys"])
        want = jck.load_rad_checkpoint(jpath)
        state = restore(phys, m, ck.load_rad_checkpoint(jpath))
        tpath = str(tmp_path / f"{name}_torch.ckpt.npz")
        save(tpath, state, phys)
        got = jck.load_rad_checkpoint(tpath)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------- #
# (j, k) the command line and pipeline.run
# --------------------------------------------------------------------------- #

def test_cli_runs_an_ensemble_file_as_jax_does(runs, tmp_path, capsys):
    """main(-planet_ensemble_file, progress, a checkpoint every 40) prints
    the progress and "Done! Ensemble of" lines, writes each member's files
    as JAX's command-line path does with its native-fp64 Planck lookup
    (the "%g" rule) and lands bit for bit on the unmonitored batch; a
    second identical call resumes from the ensemble checkpoints and leaves
    the files unchanged."""
    argv = runs["argv"] + ["-output_directory", str(tmp_path) + "/",
                           "-progress", "yes", "-checkpoint_every", "40"]
    assert torch_main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "[ensemble/radiation] iters=" in out
    assert "[ensemble/convection] iters=" in out
    assert "converged 2/2 planets" in out
    assert "Done! Ensemble of 2 planets finished in" in out
    for name in ALBEDOS:
        assert f"  {name}: " in out
        want_dir = runs["dir"] / "jax" / name
        H.assert_same_files(tmp_path / name, want_dir,
                            names=sorted(os.listdir(want_dir)))
    for f in ("ensemble.ckpt.npz", "ensemble_conv.ckpt.npz"):
        assert os.path.exists(tmp_path / "ens_a" / f)
    ckpt = ck.load_conv_checkpoint(str(tmp_path / "ens_a"
                                       / "ensemble_conv.ckpt.npz"))
    for k, want in enumerate(runs["touts"]):
        assert torch.equal(torch.tensor(ckpt["T_lay"][k]), want.T_lay)
        assert int(ckpt["it"][k]) == want.conv.it

    first = {n: sorted((p.name, p.read_bytes())
                       for p in (tmp_path / n).iterdir()
                       if not p.name.endswith(".npz")) for n in ALBEDOS}
    assert torch_main(argv, device="cpu") == 0
    assert "Done! Ensemble of 2 planets" in capsys.readouterr().out
    for n in ALBEDOS:
        assert sorted((p.name, p.read_bytes())
                      for p in (tmp_path / n).iterdir()
                      if not p.name.endswith(".npz")) == first[n]


def test_pipeline_run_ignores_n_planet_batch_as_jax_does(tmp_path,
                                                         monkeypatch):
    """helios_tpu.pipeline.run does not read n_planet_batch (its mesh knob
    is n_spectral_shards): with n_planet_batch=2 both packages run the one
    planet, here a post-processing solve: the port bit for bit its run
    without the knob, the TOA flux within 1e-10 of JAX's.  With
    n_spectral_shards=2 the solve runs on two spectral slices: within
    1e-12 of the port's solve on one device, and within 1e-7 of JAX's
    sharded solve (its Planck pairs, ROADMAP C)."""
    H.write_tp_file(tmp_path / "tp.dat", H.start_profile(L))
    kw = dict(H.SMALL_RUN, nlayer=L, run_type="post-processing",
              iso_input="no", temp_path=str(tmp_path / "tp.dat"),
              temp_format="helios")
    table = small_table()
    got = torch_pipeline.run(TorchConfig(**kw, n_planet_batch=2), table,
                             write_output=False, device="cpu")
    plain = torch_pipeline.run(TorchConfig(**kw), table, write_output=False,
                               device="cpu")
    assert torch.equal(got.totals.F_net, plain.totals.F_net)
    H.native_build(monkeypatch)
    want = jax_pipeline.run(JaxConfig(**kw, n_planet_batch=2), table=table,
                            write_output=False)
    np.testing.assert_allclose(got.result.F_up_tot, want.result.F_up_tot,
                               rtol=1e-10)
    sliced = torch_pipeline.run(TorchConfig(**kw, n_spectral_shards=2),
                                table, write_output=False, device="cpu")
    np.testing.assert_allclose(sliced.result.F_up_tot,
                               plain.result.F_up_tot, rtol=1e-12)
    monkeypatch.undo()
    jsliced = jax_pipeline.run(JaxConfig(**kw, n_spectral_shards=2),
                               table=table, write_output=False)
    np.testing.assert_allclose(sliced.result.F_up_tot,
                               jsliced.result.F_up_tot, rtol=1e-7)
