"""Planet ensembles of the PyTorch port on a ("planet", "spectral") mesh on
the CPU: the scenarios of tests/test_sharding.py:220-262 and :378-456,
each against the port's ensemble on one device and against the JAX
package's ensemble on the same mesh of its virtual CPU devices (the
convective one, :458-493, is tests/test_torch_mesh_ensemble_conv.py).

Four members on a 2 x 2 mesh: two groups of two consecutive members, each
group a batch over two slices, the bin axis (21 bins) padded to 22; the
on-the-fly scenario has two members, one per group.  Converged members are
held to T rtol 1e-6 (the JAX package's own sharded bound,
tests/test_sharding.py); the sliced and the one-device port stop at the
same iteration (the CPU's sums part them in the last bits; on the card
they are bit for bit, chip_smoke.py path q).

Measured largest relative differences of T: 1.1e-9 against the port on
one device and 3.2e-7 against JAX's mesh ensemble (the TOA band fluxes
8.3e-8); on the fly 2.0e-15 and 7.2e-7.
"""

import os

import numpy as np
import pytest

import jax

from helios_tpu import chem as jchem
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import synthetic_premixed_table
from helios_tpu.parallel import ensemble as jens
from helios_tpu_torch import chem as tchem
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.parallel import ensemble as tens

import torch_port_helpers as H

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

MESH = dict(n_planet_batch=2, n_spectral_shards=2)
ALBEDOS = (0.0, 0.7, 0.3, 0.5)
ISO = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0, R_star=1.0,
           T_star=4000.0, T_intern=200.0, scattering="no", direct_beam="no",
           convection="no", run_type="iterative", iso_input="yes",
           nlayer=10, p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6)
OTF = dict(ISO, opacity_mixing="on-the-fly")
SPECIES = [("H2O", True, True, "1e-3"), ("CO2", True, False, "1e-4"),
           ("H2", False, True, "0.9"), ("He", False, False, "0.1")]


def iso_table():
    return synthetic_premixed_table(nbin=21, ny=4, ntemp=10, npress=8,
                                    seed=6)


def donor():
    return synthetic_premixed_table(nbin=21, ny=4, ntemp=8, npress=6,
                                    seed=9)


def species_sets(table):
    kw = dict(ktemps=table.temperatures, kpress=table.pressures, nbin=21,
              ny=4, nlayer=10,
              opacity_tables={"H2O": table.kpoints,
                              "CO2": table.kpoints * 3.0},
              scat_tables={"H2": 8.49e-45 / table.wave_centers ** 4})
    return (jchem.build_species_set(
        [jchem.SpeciesSpec(*s) for s in SPECIES], **kw),
        tchem.build_species_set(
            [tchem.SpeciesSpec(*s) for s in SPECIES], device="cpu", **kw))


def cfgs(Config, base, out_dir, prefix, n=4, **over):
    return [Config(**dict(base, name=f"{prefix}_{i}",
                          output_dir=str(out_dir) + "/", surf_albedo=a,
                          **over))
            for i, a in enumerate(ALBEDOS[:n])]


@pytest.fixture(scope="module")
def iso_runs(tmp_path_factory):
    """The isothermal premixed ensemble on the 2 x 2 mesh in both packages
    and in the port on one device."""
    d = tmp_path_factory.mktemp("iso")
    jouts = jens.run_ensemble(cfgs(JaxConfig, ISO, d / "jax", "pp", **MESH),
                              tables=[iso_table()] * 4)
    mesh = tens.run_ensemble(cfgs(TorchConfig, ISO, d / "mesh", "pp", **MESH),
                             tables=[iso_table()] * 4, device="cpu")
    one = tens.run_ensemble(cfgs(TorchConfig, ISO, d / "one", "pp"),
                            tables=[iso_table()] * 4, write_output=False,
                            device="cpu")
    return dict(dir=d, jax=jouts, mesh=mesh, one=one)


def test_run_ensemble_padded_mesh_matches_one_device_and_jax(iso_runs):
    """Four members on the 2 x 2 mesh, 21 bins padded to 22: each converged
    within 1e-6 of the port's ensemble on one device (at its iteration) and
    of JAX's ensemble on the mesh, the spectra on the real 21 bins, and
    each member's files those of a run of its own."""
    d = iso_runs["dir"]
    for got, one, want in zip(iso_runs["mesh"], iso_runs["one"],
                              iso_runs["jax"]):
        assert bool(got.rad.abort.all())
        assert got.rad.it == one.rad.it
        assert got.result.F_up_band.shape == (11, 21)
        H.assert_close(got.result.T_lay, one.result.T_lay, rtol=1e-6)
        H.assert_close(got.result.T_lay, want.result.T_lay, rtol=1e-6)
        H.assert_close(got.result.F_up_band[10], want.result.F_up_band[10],
                       rtol=1e-5)
        name = got.result.name
        assert sorted(os.listdir(d / "mesh" / name)) == sorted(
            os.listdir(d / "jax" / name))
    # the members differ: the albedo moves the surface
    rel = np.abs(iso_runs["mesh"][0].result.T_lay
                 / iso_runs["mesh"][1].result.T_lay - 1)
    assert rel.max() > 1e-5


def test_on_the_fly_mesh_matches_one_device_and_jax(tmp_path):
    """On-the-fly mixing on the 2 x 2 mesh, the species tables split by
    bins and padded: each member converged at the iteration of the port's
    ensemble on one device, T within 1e-6 of it and of JAX's ensemble on
    the mesh."""
    jset, tset = species_sets(donor())
    want = jens.run_ensemble(cfgs(JaxConfig, OTF, tmp_path, "o", 2, **MESH),
                             tables=[donor()] * 2, sset=jset,
                             write_output=False)
    mesh = tens.run_ensemble(cfgs(TorchConfig, OTF, tmp_path, "o", 2,
                                  **MESH), tables=[donor()] * 2, sset=tset,
                             write_output=False, device="cpu")
    one = tens.run_ensemble(cfgs(TorchConfig, OTF, tmp_path, "o", 2),
                            tables=[donor()] * 2, sset=tset,
                            write_output=False, device="cpu")
    for got, o, w in zip(mesh, one, want):
        assert bool(got.rad.abort.all()) and got.rad.it == o.rad.it
        H.assert_close(got.result.T_lay, o.result.T_lay, rtol=1e-6)
        H.assert_close(got.result.T_lay, w.result.T_lay, rtol=1e-6)


def test_member_count_must_divide_the_planet_axis(tmp_path):
    """Three members on two planet positions raise, as in the JAX
    package."""
    cfg = cfgs(TorchConfig, ISO, tmp_path, "odd", **MESH)[:3]
    with pytest.raises(ValueError, match="not divisible by planet axis 2"):
        tens.run_ensemble(cfg, tables=[iso_table()] * 3, write_output=False,
                          device="cpu")
    with pytest.raises(ValueError, match="divisible by 2"):
        jens.run_ensemble(cfgs(JaxConfig, ISO, tmp_path, "odd", **MESH)[:3],
                          tables=[iso_table()] * 3, write_output=False)


def test_too_few_devices_run_on_one(tmp_path):
    """n_planet_batch x n_spectral_shards beyond the devices at hand: the
    ensemble runs on one device, as the JAX package's does."""
    got = tens.run_ensemble(cfgs(TorchConfig, ISO, tmp_path, "few", **MESH),
                            tables=[iso_table()] * 4, write_output=False,
                            device=["cpu", "cpu"])
    assert got[0].rad.flux.F_up.shape == (11, 84)      # no padding
    want = torch_pipeline.run(
        cfgs(TorchConfig, ISO, tmp_path, "few")[0], iso_table(),
        write_output=False, device="cpu")
    H.assert_close(got[0].result.T_lay, want.result.T_lay, rtol=0)
