"""Checkpoints of the PyTorch port (helios_tpu_torch.checkpoint) on the
CPU: the round trip, a resume bit for bit in both loops, the refusals,
and the file format shared with helios_tpu.checkpoint in both directions.

A resume at a multiple of the 10-iteration cache refresh recomputes the
cell cache exactly where the uninterrupted run does, so the resumed runs
are compared bit for bit.  The port's continuation of a JAX checkpoint is
held to the unmodified JAX continuation at the Planck-pairs bound of
ROADMAP C (1e-7: the JAX CPU path looks up Planck values as two-float32
pairs).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import checkpoint as jck
from helios_tpu import forward as jf
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.rce import loop as jloop
from helios_tpu.rce import radiative as jrad
from helios_tpu_torch import checkpoint as ck
from helios_tpu_torch import convert
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.rce import radiative as rad_mod
from helios_tpu_torch.rce.loop import convection_loop

import torch_port_helpers as H
from test_torch_monitor import (CONV, ISO, assert_same_state, conv_table,
                                iso_table)


@pytest.fixture(scope="module")
def iso_model():
    phys, arrays = tf.build_model(HeliosConfig(**ISO).finalize(),
                                  iso_table(), device="cpu")
    return phys, arrays, torch.full((phys.nlayer + 1,), 1000.0,
                                    dtype=torch.float64)


@pytest.fixture(scope="module")
def conv_model():
    cfg = HeliosConfig(**CONV).finalize()
    phys, arrays = tf.build_model(cfg, conv_table(), device="cpu")
    thermo = rad_mod.make_const_thermo(cfg.kappa_value)
    T0 = torch.full((phys.nlayer + 1,), 900.0, dtype=torch.float64)
    return phys, arrays, thermo, rad_mod.radiation_loop(phys, arrays,
                                                        thermo, T0)


def test_save_load_roundtrip(iso_model, tmp_path):
    phys, arrays, T0 = iso_model
    state = rad_mod.radiation_loop(phys, arrays, None, T0, max_steps=25)
    path = str(tmp_path / "a.ckpt.npz")
    ck.save_rad_checkpoint(path, state, phys)
    restored = ck.restore_rad_state(phys, arrays, ck.load_rad_checkpoint(path))
    assert restored.it == state.it == 25
    for f in ("T_lay", "T_store", "prefactor", "F_smooth_sum", "abort",
              "keep_running", "goto_convection"):
        assert torch.equal(getattr(restored, f), getattr(state, f)), f
    assert_same_state(restored.flux, state.flux)
    assert restored.local_limit == state.local_limit
    assert restored.aborted is state.aborted is False
    assert ck.load_rad_checkpoint(str(tmp_path / "nope.npz")) is None


def test_radiation_resume_is_bitwise(iso_model, tmp_path):
    """40 iterations in chunks of 20 with a checkpoint after each, a
    preemption, the restore and 20 more: bit for bit the straight 60."""
    phys, arrays, T0 = iso_model
    straight = rad_mod.radiation_loop(phys, arrays, None, T0, max_steps=60)
    path = str(tmp_path / "resume.ckpt.npz")
    state = rad_mod.init_rad_state(phys, arrays, T0)
    for _ in range(2):
        state = rad_mod.radiation_loop(phys, arrays, None, None,
                                       max_steps=20, state0=state)
        ck.save_rad_checkpoint(path, state, phys)
    del state
    resumed = ck.restore_rad_state(phys, arrays, ck.load_rad_checkpoint(path))
    assert resumed.it == 40
    final = rad_mod.radiation_loop(phys, arrays, None, None, max_steps=20,
                                   state0=resumed)
    assert final.it == straight.it == 60
    for f in ("T_lay", "T_store", "prefactor", "F_smooth_sum", "abort"):
        assert torch.equal(getattr(final, f), getattr(straight, f)), f
    assert_same_state(final.flux, straight.flux)


def test_run_radiation_checkpointed_to_convergence(iso_model, tmp_path):
    phys, arrays, T0 = iso_model
    path = str(tmp_path / "conv.ckpt.npz")
    state = ck.run_radiation_checkpointed(phys, arrays, None, T0, path=path,
                                          every=200)
    straight = rad_mod.radiation_loop(phys, arrays, None, T0)
    assert bool(state.abort.all()) and not bool(state.keep_running)
    assert state.it == straight.it
    assert torch.equal(state.T_lay, straight.T_lay)
    assert int(ck.load_rad_checkpoint(path)["it"]) == state.it


def test_convection_resume_is_bitwise(conv_model, tmp_path):
    """Convection: saved at it = 300 and restored into a fresh state, run
    on to the end (this scenario stops at it = 400, the minimum): bit for
    bit the uninterrupted run."""
    phys, arrays, thermo, rad = conv_model
    straight = convection_loop(phys, arrays, thermo, rad)
    half = convection_loop(phys, arrays, thermo, rad, max_steps=300)
    path = str(tmp_path / "c.ckpt.npz")
    ck.save_conv_checkpoint(path, half, phys)
    del half
    ckpt = ck.load_conv_checkpoint(path)
    assert ck.checkpoint_phase(ckpt) == "convection"
    resumed = ck.restore_conv_state(phys, arrays, ckpt)
    assert resumed.it == 300 and resumed.steps == 0
    final = convection_loop(phys, arrays, thermo, None, state0=resumed)
    assert final.it == straight.it and not final.keep_running
    assert final.steps == straight.steps - 300   # bodies after the restore
    assert_same_state(final, straight)


def test_fingerprint_and_phase_mismatches_are_refused(iso_model, conv_model,
                                                      tmp_path):
    phys, arrays, T0 = iso_model
    state = rad_mod.radiation_loop(phys, arrays, None, T0, max_steps=20)
    path = str(tmp_path / "fp.ckpt.npz")
    ck.save_rad_checkpoint(path, state, phys)
    other = dataclasses.replace(phys, T_star=9999.0)
    with pytest.raises(ValueError, match="configuration"):
        ck.restore_rad_state(other, arrays, ck.load_rad_checkpoint(path))
    ck.restore_rad_state(phys, arrays, ck.load_rad_checkpoint(path))
    with pytest.raises(ValueError, match="radiation-phase"):
        ck.restore_conv_state(phys, arrays, ck.load_rad_checkpoint(path))

    cphys, carrays, thermo, rad = conv_model
    conv = convection_loop(cphys, carrays, thermo, rad, max_steps=30)
    cpath = str(tmp_path / "ph_conv.ckpt.npz")
    ck.save_conv_checkpoint(cpath, conv, cphys)
    with pytest.raises(ValueError, match="convection-phase"):
        ck.restore_rad_state(cphys, carrays, ck.load_conv_checkpoint(cpath))
    assert ck.checkpoint_phase({"it": np.int32(3)}) == "radiation"


def test_conv_checkpoint_path_never_collides():
    for p in ("/x/restart.ckpt.npz", "/x/ck.npz", "/x/ck", "/x/a.b.c"):
        rad_path, conv_path = pipeline.checkpoint_paths(
            HeliosConfig(checkpoint_path=p))
        assert rad_path == p and conv_path != p
    assert pipeline.checkpoint_paths(HeliosConfig(
        name="r", output_dir="/o/")) == ("/o/r/restart.ckpt.npz",
                                         "/o/r/restart_conv.ckpt.npz")


# --------------------------------------------------------------------------- #
# the file format shared with helios_tpu
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def both():
    """The small non-iso scenario of tests/torch_port_helpers.py in both
    packages (the port's arrays carried over from JAX's), with JAX's state
    after 40 radiation iterations and after 20 convection iterations."""
    cfg = H.SMALL_RUN
    jphys, jarr = jf.build_model(JaxConfig(**cfg).finalize(),
                                 H.small_table())
    tphys = tf.Phys.from_config(HeliosConfig(**cfg).finalize(), nbin=65,
                                ny=4)
    tarr = convert.model_arrays_from_numpy(
        {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}, device="cpu")
    thermo = jrad.make_const_thermo(0.1)
    T0 = jnp.asarray(H.start_profile(jphys.nlayer))
    step20 = jax.jit(lambda s: jrad.radiation_loop(
        jphys, jarr, thermo, s.T_lay, max_steps=20, state0=s))
    rad40 = step20(step20(jrad.init_rad_state(jphys, jarr, T0)))
    conv20 = jax.jit(lambda r: jloop.convection_loop(
        jphys, jarr, thermo, r, max_steps=20))(rad40)
    return jphys, jarr, tphys, tarr, thermo, rad40, conv20, step20


def _file(tmp_path, name, save, state, phys):
    path = str(tmp_path / name)
    save(path, state, phys)
    return path


def test_jax_checkpoints_restore_to_the_files_arrays(both, tmp_path):
    jphys, _, tphys, tarr, _, rad40, conv20, _ = both
    rpath = _file(tmp_path, "j.ckpt.npz", jck.save_rad_checkpoint, rad40,
                  jphys)
    cpath = _file(tmp_path, "j_conv.ckpt.npz", jck.save_conv_checkpoint,
                  conv20, jphys)
    for path, restore in ((rpath, ck.restore_rad_state),
                          (cpath, ck.restore_conv_state)):
        ckpt = ck.load_rad_checkpoint(path)
        state = restore(tphys, tarr, ckpt)
        for key, want in ckpt.items():
            if key == "phase" or key.startswith("fp__"):
                continue
            group, _, field = key.rpartition("__")
            obj = getattr(state, group) if group else state
            got = getattr(obj, field)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, want, err_msg=key)
        assert state.it == int(ckpt["it"]) > 0


def test_port_checkpoints_load_in_jax_with_its_keys_and_dtypes(both,
                                                               tmp_path):
    """The port's file of a state restored from JAX's has JAX's keys,
    dtypes and shapes, and jax's loader reads it."""
    jphys, _, tphys, tarr, _, rad40, conv20, _ = both
    for name, jsave, save, restore, jstate in (
            ("r", jck.save_rad_checkpoint, ck.save_rad_checkpoint,
             ck.restore_rad_state, rad40),
            ("c", jck.save_conv_checkpoint, ck.save_conv_checkpoint,
             ck.restore_conv_state, conv20)):
        jpath = _file(tmp_path, f"{name}_jax.ckpt.npz", jsave, jstate, jphys)
        want = jck.load_rad_checkpoint(jpath)
        state = restore(tphys, tarr, ck.load_rad_checkpoint(jpath))
        tpath = _file(tmp_path, f"{name}_torch.ckpt.npz", save, state, tphys)
        got = jck.load_rad_checkpoint(tpath)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        with np.load(tpath) as z:
            assert z["format_version"].dtype == np.int64


def test_port_continues_a_jax_checkpoint_as_jax_does(both, tmp_path):
    """From JAX's checkpoint at iteration 40, 20 more radiation iterations
    in each package: T at the Planck-pairs bound (1e-7)."""
    jphys, jarr, tphys, tarr, _, rad40, _, step20 = both
    path = _file(tmp_path, "cont.ckpt.npz", jck.save_rad_checkpoint, rad40,
                 jphys)
    jstate = jck.restore_rad_state(jphys, jarr, jck.load_rad_checkpoint(path))
    want = step20(jstate)
    tstate = ck.restore_rad_state(tphys, tarr, ck.load_rad_checkpoint(path))
    got = rad_mod.radiation_loop(tphys, tarr, rad_mod.make_const_thermo(0.1),
                                 None, max_steps=20, state0=tstate)
    assert got.it == int(want.it) == 60
    H.assert_close(got.T_lay.numpy(), want.T_lay, rtol=1e-7)
    H.assert_close(got.prefactor.numpy(), want.prefactor, rtol=1e-7)


def test_pipeline_resumes_from_its_checkpoints(tmp_path):
    """pipeline.run stopped by a callback after the radiation checkpoint
    at iteration 200, then run again: it resumes from the file and lands
    bit for bit on the uninterrupted run, counting only the flux solves
    after the restore; the same once more, stopped inside the convection
    loop and resumed from the _conv file."""
    kw = dict(CONV, output_dir=str(tmp_path) + "/")
    table = conv_table()
    plain = pipeline.run(HeliosConfig(**kw, name="plain"), table,
                         write_output=False, device="cpu")

    class Preempted(Exception):
        pass

    def stop_at(phase, it):
        def cb(info):
            if info.phase == phase and info.state.it >= it:
                raise Preempted
        return cb

    for phase, it in (("radiation", 200), ("convection", 200)):
        cfg = HeliosConfig(**kw, name=phase, checkpoint_every=100)
        with pytest.raises(Preempted):
            pipeline.run(cfg, table, write_output=False, device="cpu",
                         callbacks=[stop_at(phase, it)])
        out = pipeline.run(cfg, table, write_output=False, device="cpu")
        assert torch.equal(out.T_lay, plain.T_lay)
        assert (out.rad.it, out.conv.it) == (plain.rad.it, plain.conv.it)
        if phase == "radiation":
            assert out.rad_it0 == 200
            assert out.n_flux_solves == plain.n_flux_solves - 200
        else:
            assert out.rad_it0 == plain.rad.it
            assert out.conv.steps == plain.conv.steps - 200
            assert out.n_flux_solves == out.conv.steps
    assert os.path.exists(tmp_path / "convection" / "restart_conv.ckpt.npz")
