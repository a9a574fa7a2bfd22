"""pipeline.run and the command line of the PyTorch port on a mesh of
spectral slices (n_spectral_shards > 1) on the CPU: the scenarios of
tests/test_pipeline.py:98-150, :183-209 and :296-315, each against the
port's run on one device and against the JAX package's sharded run on its
virtual CPU devices.

The scenario is tests/test_pipeline.py's small isothermal run with 21 bins,
padded to 24 over 4 slices.  Converged runs are held to the JAX package's
own sharded bound, T rtol 1e-6 (tests/test_pipeline.py:113); the sliced and
the one-device port stop at the same iteration and measured within 5e-14
of each other (the CPU's sums, not the slicing, part them: on the card they
are bit for bit, chip_smoke.py path p).  Output files print "%g" and are
compared by tests/torch_port_helpers.py's rule.

Measured largest relative differences: T 4.3e-14 against the port on one
device and 1.5e-7 against JAX's sharded run, the TOA band fluxes 5.0e-13
and 4.3e-7; JAX's checkpoint continued by the port ends 1.5e-7 from
JAX's run and 2.7e-11 from the port's.
"""

import os
import shutil

import numpy as np
import pytest

import jax

from helios_tpu import checkpoint as jck
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import save_opacity_file, synthetic_premixed_table
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.__main__ import main as torch_main
from helios_tpu_torch.config import HeliosConfig as TorchConfig

import torch_port_helpers as H

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

NAME = "pad"
SMALL = dict(name=NAME, planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
             R_star=1.0, T_star=4000.0, T_intern=200.0, scattering="no",
             direct_beam="no", convection="no", run_type="iterative",
             iso_input="yes", nlayer=10, p_boa=1e8, p_toa=1e3,
             rad_convergence_limit=1e-6, checkpoint_every=40, chunk_iters=40)


def table():
    return synthetic_premixed_table(nbin=21, ny=4, ntemp=12, npress=10,
                                    seed=5)


def kw(out_dir, **over):
    return dict(SMALL, output_dir=str(out_dir) + "/", **over)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's padded sharded run (4 slices, a checkpoint every 40
    iterations; its first checkpoint kept), the port's on 4 slices and the
    port's on one device, each writing its files into a directory of its
    own."""
    d = tmp_path_factory.mktemp("mesh")
    saved = []
    save = jck.save_rad_checkpoint

    def keep_first(path, state, phys=None):
        save(path, state, phys)
        if not saved:
            saved.append(str(d / "jax_it40.ckpt.npz"))
            shutil.copy(path, saved[0])

    jck.save_rad_checkpoint = keep_first
    try:
        jax_out = jax_pipeline.run(
            JaxConfig(**kw(d / "jax", n_spectral_shards=4)), table=table())
    finally:
        jck.save_rad_checkpoint = save
    sliced = torch_pipeline.run(
        TorchConfig(**kw(d / "sliced", n_spectral_shards=4)), table(),
        device="cpu")
    single = torch_pipeline.run(TorchConfig(**kw(d / "single")), table(),
                                device="cpu")
    return dict(dir=d, jax=jax_out, jax_ckpt=saved[0], sliced=sliced,
                single=single)


def test_pipeline_sliced_matches_single(runs):
    """21 bins padded to 24 over 4 slices: converged at the one-device
    run's iteration, T within 1e-6 of it and of JAX's sharded run, the
    spectra on the real 21 bins."""
    got, single, jax_out = runs["sliced"], runs["single"], runs["jax"]
    assert got.phys.nbin == 21 and got.rad.T_lay.shape == (11,)
    assert bool(got.rad.abort.all()), "the sliced run did not converge"
    assert got.rad.it == single.rad.it
    assert got.result.F_up_band.shape == (11, 21)
    assert got.flux.F_up.shape == (11, 84)
    assert got.rad.flux.F_up.shape == (11, 96)      # the padded loop state
    H.assert_close(got.result.T_lay, single.result.T_lay, rtol=1e-6)
    H.assert_close(got.result.F_up_band[10], single.result.F_up_band[10],
                   rtol=1e-5)
    H.assert_close(got.result.T_lay, jax_out.result.T_lay, rtol=1e-6)
    H.assert_close(got.result.F_up_band[10], jax_out.result.F_up_band[10],
                   rtol=1e-5)


def test_sliced_run_writes_the_files_of_one_device(runs):
    """The sliced run's output files: the one-device run's names (and
    JAX's sharded run's) with the same numbers by the "%g" rule."""
    d = runs["dir"]
    got, want = d / "sliced" / NAME, d / "single" / NAME
    assert sorted(os.listdir(got)) == sorted(os.listdir(d / "jax" / NAME))
    H.assert_same_files(str(got), str(want),
                        names=sorted(n for n in os.listdir(want)
                                     if n.endswith(".dat")))


def test_sliced_padded_checkpoint_resumes(runs):
    """A second run of the sliced config finds its converged padded
    checkpoint (the padded 24 bins in the fingerprint), restores it and
    ends on the same profile."""
    d = runs["dir"]
    ckpt = np.load(d / "sliced" / NAME / "restart.ckpt.npz")
    assert float(ckpt["fp__nbin"]) == 24 and ckpt["flux__F_up"].shape == (
        11, 96)
    again = torch_pipeline.run(
        TorchConfig(**kw(d / "sliced", n_spectral_shards=4)), table(),
        write_output=False, device="cpu")
    assert again.rad_it0 == runs["sliced"].rad.it == again.rad.it
    H.assert_close(again.result.T_lay, runs["sliced"].result.T_lay,
                   rtol=1e-12)
    assert again.result.F_up_band.shape == (11, 21)


def test_port_continues_jax_padded_sharded_checkpoint(runs, tmp_path):
    """JAX's padded sharded checkpoint of iteration 40 continued by the
    port on 4 slices: converged within 1e-6 of JAX's run and of the port's
    run from the start."""
    path = str(tmp_path / "jax.ckpt.npz")
    shutil.copy(runs["jax_ckpt"], path)
    assert int(np.load(path)["it"]) == 40
    out = torch_pipeline.run(
        TorchConfig(**kw(tmp_path, n_spectral_shards=4,
                         checkpoint_path=path)), table(),
        write_output=False, device="cpu")
    assert out.rad_it0 == 40 and bool(out.rad.abort.all())
    H.assert_close(out.result.T_lay, runs["jax"].result.T_lay, rtol=1e-6)
    H.assert_close(out.result.T_lay, runs["sliced"].result.T_lay,
                   rtol=1e-6)


def test_too_few_devices_raise_as_in_jax():
    """n_spectral_shards beyond the devices at hand: JAX's RuntimeError."""
    cfg = TorchConfig(**dict(SMALL, n_spectral_shards=4,
                             checkpoint_every=0))
    with pytest.raises(RuntimeError, match="n_spectral_shards=4 but only 2"):
        torch_pipeline.run(cfg, table(), write_output=False,
                           device=["cpu", "cpu"])


def test_cli_runs_n_spectral_shards(tmp_path, capsys):
    """python -m helios_tpu_torch -n_spectral_shards 2 (main(argv,
    device="cpu")): the run of pipeline.run on two slices, bit for bit."""
    opac = str(tmp_path / "opac.h5")
    save_opacity_file(opac, table())
    argv = ["-name", "cli", "-output_directory", str(tmp_path) + "/",
            "-planet", "manual", "-surface_gravity", "2288.0",
            "-orbital_distance", "0.0153", "-radius_planet", "1.0",
            "-radius_star", "1.0", "-temperature_star", "4000.0",
            "-internal_temperature", "200.0", "-scattering", "no",
            "-direct_irradiation_beam", "no",
            "-convective_adjustment", "no", "-run_type", "iterative",
            "-isothermal_layers", "yes", "-number_of_layers", "10",
            "-boa_pressure", "1e8", "-toa_pressure", "1e3",
            "-radiative_equilibrium_criterion", "1e-6",
            "-path_to_opacity_file", opac, "-n_spectral_shards", "2"]
    assert torch_main(argv, device="cpu") == 0
    assert "Done!" in capsys.readouterr().out
    cfg = dict(SMALL, name="cli", output_dir=str(tmp_path / "api") + "/",
               checkpoint_every=0, n_spectral_shards=2)
    torch_pipeline.run(TorchConfig(**cfg), table(), device="cpu")
    for f in ("cli_tp.dat", "cli_spec_upflux.dat"):
        with open(tmp_path / "cli" / f) as got, open(
                tmp_path / "api" / "cli" / f) as want:
            assert got.read() == want.read(), f
