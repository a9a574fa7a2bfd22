"""A convective planet ensemble of the PyTorch port on a ("planet",
"spectral") mesh on the CPU, with its checkpoints (tests/test_sharding.py:
458-493) on a 2 x 2 mesh: two members, one per planet position, each over
two slices.  It is held against the port's ensemble on one device and
against the JAX package's ensemble on the same mesh of its virtual CPU
devices.

The scenario is tests/test_torch_ensemble.py's: tests/torch_port_helpers.py's
small run at 10 layers, 16 bins x 4, from a non-isothermal TP file, the
members' surface albedos 0.0 and 0.6.  Both loops run.  The radiation
loop's count is chaotic here (tests/test_torch_rce.py): the CPU's last
bits, which the slicing moves, move it.  The convection loop lands on the
same profile: the sliced and the one-device port end at the same
convection iteration, and T is held to rtol 1e-6 (the JAX package's own
sharded bound) against both.  The checkpoint pair is the
JAX package's ensemble layout, so each package resumes the other's: a
converged convection checkpoint restores the profile it holds (T rtol
1e-12).  Measured largest relative differences of T: 3.8e-16 against the
port on one device, 9.7e-9 against JAX's mesh ensemble, 0 after either
resume.
"""

import os
import shutil

import numpy as np
import pytest

import jax

from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.parallel import ensemble as jens
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.parallel import ensemble as tens

import torch_port_helpers as H

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

L = 10
MESH = dict(n_planet_batch=2, n_spectral_shards=2)
CKPT = ("ensemble.ckpt.npz", "ensemble_conv.ckpt.npz")


def table():
    return H.small_table(nbin=16)


def cfgs(Config, out_dir, **over):
    tp = os.path.join(str(out_dir), "start_tp.dat")
    if not os.path.exists(tp):
        os.makedirs(str(out_dir), exist_ok=True)
        H.write_tp_file(tp, H.start_profile(L))
    return [Config(**dict(H.SMALL_RUN, nlayer=L, name=f"cv_{i}",
                          surf_albedo=a, output_dir=str(out_dir) + "/",
                          force_start_tp_from_file="yes", temp_path=tp,
                          temp_format="helios", checkpoint_every=40,
                          chunk_iters=40, **over))
            for i, a in enumerate((0.0, 0.6))]


def run(out_dir, **over):
    return tens.run_ensemble(cfgs(TorchConfig, out_dir, **over),
                             tables=[table()] * 2, write_output=False,
                             device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("conv")
    jax_out = jens.run_ensemble(cfgs(JaxConfig, d / "jax", **MESH),
                                tables=[table()] * 2, write_output=False)
    return dict(dir=d, jax=jax_out, mesh=run(d / "mesh", **MESH),
                one=run(d / "one"))


def test_convective_mesh_matches_one_device_and_jax(runs):
    for got, one, want in zip(runs["mesh"], runs["one"], runs["jax"]):
        assert got.conv is not None and got.conv.steps > 0
        assert not got.conv.keep_running and not got.conv.aborted
        assert got.conv.it == one.conv.it
        H.assert_close(got.result.T_lay, one.result.T_lay, rtol=1e-6)
        H.assert_close(got.result.T_lay, want.result.T_lay, rtol=1e-6)
        np.testing.assert_array_equal(got.conv.conv_layer.numpy(),
                                      np.asarray(want.conv.conv_layer))


def test_mesh_checkpoints_hold_every_member_in_jax_layout(runs):
    d = runs["dir"]
    for name in CKPT:
        got = np.load(d / "mesh" / "cv_0" / name)
        want = np.load(d / "jax" / "cv_0" / name)
        assert sorted(got.files) == sorted(want.files), name
        for k in want.files:
            assert got[k].shape == want[k].shape, (name, k)
            assert got[k].dtype == want[k].dtype, (name, k)


def test_mesh_ensemble_resumes_its_convection_checkpoint(runs):
    again = run(runs["dir"] / "mesh", **MESH)
    for got, first in zip(again, runs["mesh"]):
        assert got.conv.steps == 0
        H.assert_close(got.result.T_lay, first.result.T_lay, rtol=1e-12)


def test_mesh_ensemble_resumes_jax_convection_checkpoint(runs, tmp_path):
    """The JAX mesh ensemble's converged checkpoint pair continued by the
    port's mesh ensemble: nothing left to solve, JAX's profiles."""
    os.makedirs(tmp_path / "cv_0")
    for name in CKPT:
        shutil.copy(runs["dir"] / "jax" / "cv_0" / name,
                    tmp_path / "cv_0" / name)
    got = run(tmp_path, **MESH)
    for g, want in zip(got, runs["jax"]):
        assert g.conv.steps == 0 and g.conv.it == int(want.conv.it)
        H.assert_close(g.result.T_lay, want.result.T_lay, rtol=1e-12)
