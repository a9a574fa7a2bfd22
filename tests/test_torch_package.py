"""Properties of the PyTorch port as a package: it stands apart from JAX
and from helios_tpu, its entry points run on CUDA unless the caller asks
for the CPU, and on a card its kernels agree with their plain versions.

This file imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:
    python -m pytest --noconftest tests/test_torch_package.py -q
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.device import resolve_device, torch_dtype
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.kernels.integrate import (band_integrate,
                                                band_integrate_reference)
from helios_tpu_torch.kernels.ordered import (in_order_reference,
                                              ordered_cumsum, ordered_sum)
from helios_tpu_torch.kernels.ro import ro_mix, ro_mix_reference
from helios_tpu_torch.kernels.sweep import (iso_sweep, iso_sweep_reference,
                                            noniso_sweep,
                                            noniso_sweep_reference)
from helios_tpu_torch.kernels.thomas import (thomas_solve,
                                             thomas_solve_reference)
from helios_tpu_torch.rce import graphs

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "helios_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_imports_neither_jax_nor_helios_tpu(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "helios_tpu"), (
            f"{path.name} imports {mod}")


HOST_TOOLS = ("chem_analytic", "realdata", "ktable/__init__",
              "ktable/__main__", "ktable/build", "ktable/combine",
              "ktable/continuous", "ktable/information", "ktable/params",
              "ktable/rayleigh", "ktable/native/__init__",
              "startool/__init__", "startool/__main__", "startool/functions")


def test_import_check_holds_the_host_copies():
    """The JAX-free host modules the port keeps copies of (clouds and tools
    among them, and the host tools: the analytic chemistry, the real-data
    chain, ktable and startool), the mesh (parallel/sharding.py and its
    slices) are held by the import check above, as is chip_smoke.py."""
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for name in ("clouds", "tools", "host_physics", "config", "io/writers",
                 "io/opacity", "thermo", "plotting", "examples", "monitor",
                 "checkpoint", "__main__", "parallel/sharding",
                 "ops/slices") + HOST_TOOLS:
        assert f"helios_tpu_torch/{name}.py" in checked, name
    assert "chip_smoke.py" in checked
    # every module of helios_tpu's host tools has its copy
    for sub in ("ktable", "startool"):
        jax_side = {p.name for p in (ROOT / "helios_tpu" / sub).rglob("*.py")}
        port = {p.name for p in (ROOT / "helios_tpu_torch" / sub).rglob(
            "*.py")}
        assert jax_side == port, sub
    assert (ROOT / "helios_tpu_torch/ktable/native/kdistr.cpp").exists()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_default_device_raises_without_cuda(no_cuda):
    cfg = HeliosConfig(nlayer=6, convection="no").finalize()
    table = synthetic_premixed_table(nbin=4, ny=2, ntemp=4, npress=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.build_model(cfg, table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_pipeline.run(cfg, table)


def test_unported_paths_raise(tmp_path):
    """Nothing of helios_tpu's run is left unported: a mesh with fewer
    devices than n_spectral_shards raises helios_tpu's RuntimeError (a
    one-entry device list here; the mesh runs in tests/
    test_torch_sharding.py and test_torch_mesh_*.py), and a stellar
    spectrum from a file reaches the model.  Planet ensembles, tabulated
    thermodynamics and monitoring run (tests/test_torch_ensemble.py,
    test_torch_cli.py, test_torch_thermo.py, test_torch_monitor.py)."""
    table = synthetic_premixed_table(nbin=4, ny=2, ntemp=4, npress=4)
    cfg = HeliosConfig(nlayer=6, n_spectral_shards=2)
    with pytest.raises(RuntimeError,
                       match="n_spectral_shards=2 but only 1 devices"):
        torch_pipeline.run(cfg, table, write_output=False, device=["cpu"])
    phys, arrays = tf.build_model(
        HeliosConfig(nlayer=6, stellar_model="file").finalize(), table,
        starflux=np.full(4, 1e10), device="cpu")
    assert phys.real_star == 1 and float(arrays.starflux.min()) > 0
    # a TP file format other than helios/TP/PT is refused, as in helios_tpu
    tp = tmp_path / "tp.dat"
    tp.write_text("1e9 1500\n1e3 500\n")
    cfg = HeliosConfig(nlayer=6, force_start_tp_from_file="yes",
                       temp_format="csv", temp_path=str(tp)).finalize()
    with pytest.raises(ValueError, match="unknown TP format"):
        torch_pipeline.run(cfg, table, write_output=False, device="cpu")


def test_dtype_policy():
    assert torch_dtype(HeliosConfig().finalize().dtype) == torch.float64
    assert torch_dtype(HeliosConfig(precision="single").finalize().dtype
                       ) == torch.float32
    cfg = HeliosConfig(nlayer=6, precision="single").finalize()
    table = synthetic_premixed_table(nbin=4, ny=2, ntemp=4, npress=4,
                                     dtype=np.float32)
    _, arrays = tf.build_model(cfg, table, device="cpu")
    assert all(t.dtype == torch.float32 for t in arrays)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


DTYPES = [(torch.float64, 1e-12), (torch.float32, 1e-4)]
# shapes shorter than the kernels' blocks and rings (L = 1) and row lengths
# S that are odd or leave a block part-filled
RAGGED = [(L, S) for L in (1, 12) for S in (1, 37, 257)]


def _sweep_inputs(rng, dtype, device, L, S, iso):
    """Random sweep inputs: for the iso sweep a, b_nm, s_down, s_up [L, S],
    four [S] boundary rows and F_up_prev [L+1, S]; for the non-iso sweep
    the eight [L, S] coefficients and sources, the boundary rows,
    F_up_prev and Fc_up_prev [L, S]."""
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s), dtype=dtype,
                                         device=device)
    coeffs = lambda: [mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S),
                      mk(1e2, 1e4, L, S), mk(1e2, 1e4, L, S)]
    ts = coeffs() if iso else coeffs() + coeffs()
    ts += [mk(0.0, 1e3, S), mk(0.0, 0.4, S), mk(1e2, 1e4, S), mk(0.0, 1e3, S),
           mk(0.0, 1e3, L + 1, S)]
    return ts if iso else ts + [mk(0.0, 1e3, L, S)]


@pytest.mark.parametrize("L,S,n_passes",
                         [(L, S, 4) for L, S in RAGGED]
                         + [(12, S, n) for S in (37, 257) for n in (7, 1001)])
@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, rtol, L, S, n_passes):
    """The CUDA sweep against its plain version on the card (nvcc's fma
    contraction rules out a bitwise match), and one counted launch per
    call; L = 1 is shorter than the kernel's ring, S = 1, 37 and 257 are
    odd and leave a block part-filled; 7 and 1001 passes carry the ring's
    state across passes, as the post-processing run with non-isothermal
    layers does."""
    ts = _sweep_inputs(np.random.default_rng(3), dtype, cuda_device, L, S,
                       iso=False)
    before = noniso_sweep.launches
    got = noniso_sweep(*ts, n_passes=n_passes)
    torch.cuda.synchronize()
    assert noniso_sweep.launches == before + 1
    want = noniso_sweep_reference(*ts, n_passes=n_passes)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=0.0)


@pytest.mark.parametrize("L,S,n_passes",
                         [(L, S, n) for L, S in RAGGED + [(12, 300), (1000, 37)]
                          for n in (1, 4, 7)]
                         + [(12, S, 1001) for S in (37, 257)])
@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_cuda_iso_kernel_matches_plain(cuda_device, dtype, rtol, L, S,
                                       n_passes):
    """The CUDA iso sweep against its plain version on the card, and one
    counted launch per call: L = 1 is shorter than a straight-line block,
    L = 1000 runs the narrowest blocks the shared memory allows, odd S
    leaves a block part-filled, and 1001 passes are the post-processing
    run's."""
    ts = _sweep_inputs(np.random.default_rng(4), dtype, cuda_device, L, S,
                       iso=True)
    before = iso_sweep.launches
    got = iso_sweep(*ts, n_passes=n_passes)
    torch.cuda.synchronize()
    assert iso_sweep.launches == before + 1
    want = iso_sweep_reference(*ts, n_passes=n_passes)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_iso_kernel_refuses_a_column_too_deep(cuda_device, dtype):
    """A column whose state does not fit one block's shared memory is
    refused with the limit in the message, not run."""
    ts = _sweep_inputs(np.random.default_rng(6), dtype, cuda_device, 20000,
                       1, iso=True)
    with pytest.raises(RuntimeError, match=r"iso_sweep launch failed: .*"
                       r"takes L up to \d+"):
        iso_sweep(*ts, n_passes=1)


@pytest.mark.parametrize("n_passes", [7, 1001])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_sweeps_chain_passes_bitwise(cuda_device, dtype, n_passes):
    """One call of n passes equals n single-pass calls, each fed the last
    call's F_up (and Fc_up), bit for bit, for both sweeps: what a call
    carries from one pass to the next is exactly its outputs."""
    L, S = 12, 257
    for iso, fn in ((True, iso_sweep), (False, noniso_sweep)):
        ts = _sweep_inputs(np.random.default_rng(7), dtype, cuda_device, L,
                           S, iso)
        whole = fn(*ts, n_passes=n_passes)
        state = ts[-1:] if iso else ts[-2:]
        for _ in range(n_passes):
            out = fn(*ts[:len(ts) - len(state)], *state, n_passes=1)
            state = [out[1]] if iso else [out[1], out[3]]
        torch.cuda.synchronize()
        for w, o in zip(whole, out):
            assert torch.equal(w, o), fn.__name__


@pytest.mark.parametrize("n,S", [(n, S) for n in (2, 50)
                                 for S in (1, 37, 257)])
@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_cuda_thomas_kernel_matches_plain(cuda_device, dtype, rtol, n, S):
    """The CUDA Thomas solve against its plain version on the card, on a
    diagonally dominant M-matrix system with a positive solution (so that
    relative errors are defined), at n = 50 (the non-iso matrix size of 12
    layers) and n = 2 (shorter than the kernel's ring), and one counted
    launch per call."""
    rng = np.random.default_rng(5)
    mk = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, (n, S)),
                                     dtype=dtype, device=cuda_device)
    b, c, d = mk(2.0, 3.0), mk(-0.9, -0.1), mk(1.0, 1e3)
    before = thomas_solve.launches
    got = thomas_solve(b, c, d)
    torch.cuda.synchronize()
    assert thomas_solve.launches == before + 1
    torch.testing.assert_close(got, thomas_solve_reference(b, c, d),
                               rtol=rtol, atol=0.0)


# ny of the Random Overlap card test: small and odd counts, the tables' 20,
# powers of two and one past them, and the largest the kernel takes
RO_NY = [2, 3, 4, 5, 16, 17, 20, 32, 33, 64, 126]


def _ro_cells(rng, C, ny):
    """[C, ny] mixed and new: ascending random k-distributions, with cells
    of exact ties (new == mixed), gray cells (all sums tie), ties across
    rows among unequal weights, unsorted new (the kernel's general
    branch), unsorted mixed (still its stream), an infinite entry (general),
    negligible overlap and a +0 sum tied with a later -0 sum."""
    m = np.sort(10.0 ** rng.uniform(-4, 1, (C, ny)), axis=1)
    n = np.sort(10.0 ** rng.uniform(-3, 0.5, (C, ny)), axis=1)
    n[0::9] = m[0::9]
    m[1::9], n[1::9] = 0.3, 0.05
    m[2::9] = 0.5 * np.arange(ny) + 1.0
    n[2::9] = 1.0 * np.arange(ny) + 2.0
    n[3::9] = rng.permuted(n[3::9], axis=1)
    m[4::9] = rng.permuted(m[4::9], axis=1)
    n[5::9, -1] = np.inf
    n[6::9] *= 1e-7
    m[7::9, :2] = [0.0, -0.0]              # +0 and -0 sums tie
    n[7::9, 0] = -0.0
    return m, n


@pytest.mark.parametrize("ny", RO_NY)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_ro_kernel_matches_plain(cuda_device, dtype, ny):
    """The CUDA Random Overlap equals its plain version on the card bit for
    bit (rtol 0, atol 0), fp64 and fp32, on 203 cells (not a multiple of
    the kernel's block) of ties, gray cells, unsorted and infinite entries
    and negligible overlap; on one cell; on an all-negligible batch; with
    the last Gauss node past the last yg; with a weight far below the
    others (the stream still takes the sorted cells); with a zero weight
    (the launch's check fails: every live cell through the general
    branch); and with a weight whose square overflows (yg turns NaN on
    every live cell's stream: the check at each position sends each to the
    general branch).  One counted launch per call."""
    from helios_tpu_torch.io.opacity import gauss_legendre_ypoints
    from helios_tpu_torch.kernels.ro import ro_general_cells
    from helios_tpu_torch.ops.mixing import negligible_overlap
    rng = np.random.default_rng(ny)
    y, w = (np.asarray(a) for a in gauss_legendre_ypoints(ny))
    m, n = _ro_cells(rng, 203, ny)
    past_end, tiny, zero, huge = y.copy(), w.copy(), w.copy(), w.copy()
    past_end[-1] = 1 - 1e-7
    tiny[0] = 1e-30
    zero[0] = 0.0
    huge[0] = 4 * float(np.sqrt(torch.finfo(dtype).max))
    quiet = np.where(np.isfinite(n), n, 1.0) * 1e-9
    cases = {"cells": (m, n, w, y), "one cell": (m[:1], n[:1], w, y),
             "all negligible": (np.where(m == 0, 1.0, m), quiet, w, y),
             "node past the last yg": (m, n, w, past_end),
             "tiny weight": (m, n, tiny, y), "zero weight": (m, n, zero, y),
             "overflowing weight": (m, n, huge, y)}
    for label, case in cases.items():
        ts = [torch.tensor(x, dtype=dtype, device=cuda_device) for x in case]
        before = ro_mix.launches
        got = ro_mix(*ts)
        torch.cuda.synchronize()
        assert ro_mix.launches == before + 1
        torch.testing.assert_close(got, ro_mix_reference(*ts), rtol=0,
                                   atol=0, equal_nan=True, msg=label)
        general = ro_general_cells(*ts)
        if label == "cells":
            assert general.any() and not general.all()
        if label == "all negligible":
            assert negligible_overlap(ts[0], ts[1]).all()
        live = ~negligible_overlap(ts[0], ts[1])
        if label == "tiny weight":
            assert (general & live).sum() < live.sum()
        if label in ("zero weight", "overflowing weight"):
            assert general.equal(live)


def _write_mie_dir(path):
    """A synthetic LX-Mie directory over the 51 radii of R_VALUES_MICRON
    (the recipe of tests/test_clouds.py:74-90)."""
    from helios_tpu_torch.clouds import R_VALUES_MICRON
    path.mkdir()
    lam_um = np.geomspace(0.3, 30.0, 50)
    for r in R_VALUES_MICRON:
        x = 2 * np.pi * r / lam_um
        rows = np.column_stack([lam_um, 0 * x, 0 * x,
                                1e-8 * r ** 2 * np.minimum(x ** 4, 2.0),
                                1e-8 * r ** 2 * np.minimum(x, 1.0), 0 * x,
                                np.clip(0.9 * np.minimum(x, 1.0), 0, 1)])
        np.savetxt(path / "r{:.6f}.dat".format(r), rows, fmt="%.6e",
                   header="lam c2 c3 scat abs c5 g0")
    return str(path)


@pytest.mark.parametrize("iso,method,kscale", [
    ("yes", "iteration", 1.0), ("no", "iteration", 1.0),
    ("no", "matrix", 1e-6)])
def test_cuda_cloudy_zenith_forward_matches_cpu(cuda_device, tmp_path, iso,
                                                 method, kscale):
    """One forward solve with a cloud deck, scattering and the
    zenith-corrected beam (80 degrees) on the card against the same call
    on the CPU: the totals at 1e-10, with the flux method's kernels
    launched.  The matrix method runs on a translucent atmosphere: in
    columns opaque from top to bottom its unpivoted elimination turns a
    last-bit difference into ~1e-6 of F_down (ROADMAP C)."""
    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=8, npress=6,
                                     seed=1)
    table.kpoints *= 10.0 * kscale
    cfg = HeliosConfig(
        planet="manual", g=2288.0, a=0.03142, R_planet=1.0, R_star=0.805,
        T_star=5040.0, T_intern=700.0, nlayer=12, p_boa=1e9, p_toa=1e3,
        scattering="yes", direct_beam="yes", zenith_angle_deg=80.0,
        surf_albedo=0.3, iso_input=iso, flux_calc_method=method,
        nr_cloud_decks=1, mie_dirs=[_write_mie_dir(tmp_path / "mie")],
        cloud_radius_mode=[1.0], cloud_radius_geo_std=[1.5],
        cloud_bottom_pressure=[1e7], cloud_bottom_mixing_ratio=[2e-19],
        cloud_to_gas_scale_height=[0.8]).finalize()
    assert cfg.geom_zenith_corr == 1 and cfg.clouds == 1
    phys, arrays, _ = torch_pipeline.prepare_model(cfg, table,
                                                   device=cuda_device)
    T = torch.linspace(1500.0, 500.0, phys.nlayer + 1, dtype=torch.float64)
    kernels = ([thomas_solve] if method == "matrix" else
               [iso_sweep] if iso == "yes" else [noniso_sweep])
    before = [k.launches for k in kernels]
    gpu = tf.forward_fluxes(phys, arrays, T.to(cuda_device))[1]
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    cpu = tf.forward_fluxes(phys, tf.ModelArrays(*(a.cpu() for a in arrays)),
                            T)[1]
    for f in ("F_up_tot", "F_down_tot"):
        torch.testing.assert_close(getattr(gpu, f).cpu(), getattr(cpu, f),
                                   rtol=1e-10, atol=0.0, msg=f)


def test_cuda_chunked_and_resumed_runs_equal_the_straight_run(cuda_device,
                                                              tmp_path):
    """On the card: a monitored run in chunks with checkpoints, and a run
    stopped after the radiation checkpoint at iteration 200 and resumed
    from the file, both land bit for bit on the unmonitored run, with one
    noniso_sweep launch per flux solve of each run and one per loop
    iteration replayed past the stop (which the loops' runners count
    apart)."""
    table = synthetic_premixed_table(nbin=12, ny=3, ntemp=12, npress=10,
                                     seed=5)
    table.kpoints *= 10.0
    kw = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
              R_star=1.0, T_star=30.0, T_intern=700.0, scattering="no",
              direct_beam="no", convection="yes", kappa_value=0.1,
              run_type="iterative", nlayer=14, p_boa=1e9, p_toa=1e3,
              rad_convergence_limit=1e-5, adapt_interval=6,
              output_dir=str(tmp_path) + "/")

    def run(name, **extra):
        before = noniso_sweep.launches
        with graphs.loops() as loops:
            out = torch_pipeline.run(HeliosConfig(**kw, name=name, **extra),
                                     table, write_output=False,
                                     device=cuda_device)
        torch.cuda.synchronize()
        idle = sum(st.idle_launches.get("noniso_sweep", 0)
                   for st in loops.stats.values())
        assert noniso_sweep.launches - before == out.n_flux_solves + idle
        return out

    plain = run("plain")
    chunked = run("chunked", checkpoint_every=100,
                  metrics_file=str(tmp_path / "m.jsonl"))

    class Preempted(Exception):
        pass

    def stop(info):
        if info.phase == "radiation" and info.state.it >= 200:
            raise Preempted

    with pytest.raises(Preempted):
        torch_pipeline.run(HeliosConfig(**kw, name="resumed",
                                        checkpoint_every=100), table,
                           write_output=False, device=cuda_device,
                           callbacks=[stop])
    resumed = run("resumed", checkpoint_every=100)
    assert resumed.rad_it0 == 200
    for out in (chunked, resumed):
        assert torch.equal(out.T_lay, plain.T_lay)
        assert (out.rad.it, out.conv.it) == (plain.rad.it, plain.conv.it)


def test_cuda_ensemble_matches_cpu(cuda_device, tmp_path):
    """A batch of two planets (surface albedos 0.1 and 0.7) on the card:
    one batched forward solve against the same batch on the CPU at 1e-10
    with one noniso_sweep launch for both planets, and run_ensemble to
    convergence with one launch per batched flux solve (no member runs
    alone); each member's final T within 1e-8 of the CPU batch's."""
    from helios_tpu_torch.parallel import ensemble as ens

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=8, npress=6,
                                     seed=1)
    table.kpoints *= 10.0
    kw = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
              R_star=30.0, T_star=30.0, T_intern=700.0, scattering="yes",
              direct_beam="no", convection="yes", kappa_value=0.1,
              run_type="iterative", nlayer=10, p_boa=1e9, p_toa=1e3,
              adapt_interval=6, output_dir=str(tmp_path) + "/")
    cfgs = [HeliosConfig(name=f"m{k}", surf_albedo=a, **kw)
            for k, a in enumerate((0.1, 0.7))]
    models = [torch_pipeline.prepare_model(c.finalize(), table,
                                           device=cuda_device)
              for c in cfgs]
    phys = models[0][0]
    m = ens.stack_models([arrays for _, arrays, _ in models])
    T = torch.stack([torch.linspace(1500.0, 500.0, phys.nlayer + 1,
                                    dtype=torch.float64)] * 2, dim=1)
    before = noniso_sweep.launches
    gpu = tf.forward_fluxes(phys, m, T.to(cuda_device))[1]
    torch.cuda.synchronize()
    assert noniso_sweep.launches == before + 1
    cpu = tf.forward_fluxes(phys, tf.ModelArrays(*(a.cpu() for a in m)),
                            T)[1]
    for f in ("F_up_tot", "F_down_tot"):
        torch.testing.assert_close(getattr(gpu, f).cpu(), getattr(cpu, f),
                                   rtol=1e-10, atol=0.0, msg=f)

    before = noniso_sweep.launches
    outs = ens.run_ensemble(cfgs, tables=[table, table], write_output=False,
                            device=cuda_device)
    torch.cuda.synchronize()
    assert noniso_sweep.launches - before == (
        max(o.rad.it for o in outs) + max(o.conv.steps for o in outs))
    want = ens.run_ensemble(cfgs, tables=[table, table], write_output=False,
                            device="cpu")
    for got, w in zip(outs, want):
        assert not got.conv.keep_running and not got.conv.aborted
        torch.testing.assert_close(got.T_lay.cpu(), w.T_lay, rtol=1e-8,
                                   atol=0.0)


# ordered sums: (shape, dim), the loops' Gauss, band and layer sums and
# ragged rows
ORDERED = [((7, 5, 4), 2), ((7, 13), 1), ((6, 9), 0), ((11,), 0),
           ((3, 1, 5), 1), ((1,), 0)]


@pytest.mark.parametrize("shape,dim", ORDERED)
def test_ordered_sums_on_the_cpu_are_torch(shape, dim):
    """On the CPU the wrappers are torch.sum and torch.cumsum, bit for bit,
    and launch nothing; the in-order loop is a running sum from zero."""
    x = torch.tensor(np.random.default_rng(8).uniform(-1.0, 1.0, shape))
    before = ordered_sum.launches
    assert torch.equal(ordered_sum(x, dim), torch.sum(x, dim=dim))
    assert torch.equal(ordered_cumsum(x, dim), torch.cumsum(x, dim=dim))
    assert ordered_sum.launches == before
    scan = in_order_reference(x, dim, scan=True)
    assert torch.equal(scan.select(dim, -1), in_order_reference(x, dim, False))
    a = np.moveaxis(x.numpy(), dim, 0)
    acc = np.zeros(a.shape[1:])
    for k in range(a.shape[0]):
        acc = acc + a[k]
        np.testing.assert_array_equal(np.moveaxis(scan.numpy(), dim, 0)[k],
                                      acc)


@pytest.mark.parametrize("shape,dim", ORDERED)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_ordered_sums_are_in_order_at_any_slot(cuda_device, dtype,
                                                    shape, dim):
    """The kernel is the in-order loop bit for bit, within rounding of
    torch's sums, and a row gives the same bits at every slot of a batch
    of copies (the planet axis after the first axis)."""
    x = torch.tensor(np.random.default_rng(9).uniform(1.0, 1e4, shape),
                     dtype=dtype, device=cuda_device)
    P = 5
    xb = torch.stack([x] * P, dim=1).contiguous()
    dimb = dim + 1 if dim > 0 else 0
    for fn, scan in ((ordered_sum, False), (ordered_cumsum, True)):
        got = fn(x, dim)
        want = (torch.cumsum if scan else torch.sum)(x, dim)
        torch.cuda.synchronize()
        assert torch.equal(got, in_order_reference(x, dim, scan))
        torch.testing.assert_close(got, want, rtol=1e-13 if dtype ==
                                   torch.float64 else 1e-5, atol=0.0)
        got_b = fn(xb, dimb)
        axis = 0 if dim == 0 and not scan else 1
        for p in range(P):
            assert torch.equal(got_b.select(axis, p), got)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_ordered_sums_take_a_transposed_view(cuda_device, dtype):
    """A non-contiguous input (a restored state's [P, L] transposed to
    [L, P]) sums as its contiguous copy does, bit for bit."""
    x = torch.tensor(np.random.default_rng(10).uniform(1.0, 1e4, (6, 40)),
                     dtype=dtype, device=cuda_device).t()
    assert not x.is_contiguous()
    for fn in (ordered_sum, ordered_cumsum):
        for dim in (0, 1):
            assert torch.equal(fn(x, dim), fn(x.contiguous(), dim))


# the flux integration: (rows of the fluxes, nbin, ny), a planet, a batch,
# one bin of one Gauss point, and bins that leave a tile part-filled
BANDS = [((13,), 65, 4), ((13, 3), 65, 4), ((5,), 1, 1), ((7, 2), 300, 3),
         ((4,), 385, 20)]


@pytest.mark.parametrize("lead,nbin,ny", BANDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_band_integrate_is_the_in_order_chain(cuda_device, dtype, lead,
                                                   nbin, ny):
    """One launch per call, bit for bit the in-order chain, with and
    without a carry; a batch's shared delta_lambda (an expanded view) and
    fluxes that start off a 16-byte boundary take the same bits."""
    rng = np.random.default_rng(11)
    t = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s), dtype=dtype,
                                        device=cuda_device)
    S = nbin * ny
    # F_down starts one element into its buffer
    f = [t(0.0, 1e5, int(np.prod(lead)) * S + 1)[1:].view(lead + (S,))]
    f += [t(0.0, 1e5, *lead, S) for _ in range(2)]
    w = t(0.1, 0.7, ny)
    dls = [t(1e-6, 1e-4, nbin)]
    if len(lead) == 2:
        dls = [t(1e-6, 1e-4, lead[1], nbin), dls[0].expand(lead[1], nbin)]
    carry = (t(0.0, 1.0, *lead), t(0.0, 1.0, *lead))
    for dl in dls:
        for c in (None, carry):
            before = band_integrate.launches
            got = band_integrate(*f, w, dl, c)
            torch.cuda.synchronize()
            assert band_integrate.launches == before + 1
            want = band_integrate_reference(*f, w, dl, c, in_order=True)
            for name, g, x in zip(got._fields, got, want):
                assert torch.equal(g, x), name
