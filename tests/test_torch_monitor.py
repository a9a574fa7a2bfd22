"""The chunked, monitored runner of the PyTorch port
(helios_tpu_torch.monitor and the monitored path of .pipeline.run) on the
CPU: chunked loops against the straight loops, the callbacks, and a
monitored run against an unmonitored one.

A chunk is one call of the loop with ``max_steps`` / ``state0``, which adds
no arithmetic to an iteration, so every comparison here is bit for bit.
The scenarios are those of tests/test_monitor.py: 12 isothermal layers
with 16 bins x 4, and 14 convective layers with 12 bins x 3.
"""

import json
import os

import numpy as np
import pytest
import torch

from helios_tpu_torch import chem
from helios_tpu_torch import monitor as mon
from helios_tpu_torch import pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.forward import build_model
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.rce import radiative as rad_mod
from helios_tpu_torch.rce.loop import convection_loop

import torch_port_helpers as H  # noqa: F401  (one torch thread)

ISO = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0, R_star=1.0,
           T_star=4000.0, T_intern=200.0, scattering="no", direct_beam="no",
           convection="no", run_type="iterative", iso_input="yes",
           nlayer=12, p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6)
CONV = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0, R_star=1.0,
            T_star=30.0, T_intern=700.0, scattering="no", direct_beam="no",
            convection="yes", kappa_value=0.1, run_type="iterative",
            nlayer=14, p_boa=1e9, p_toa=1e3, rad_convergence_limit=1e-5,
            adapt_interval=6)


def iso_table():
    return synthetic_premixed_table(nbin=16, ny=4, ntemp=12, npress=10,
                                    seed=3)


def conv_table():
    table = synthetic_premixed_table(nbin=12, ny=3, ntemp=12, npress=10,
                                     seed=5)
    table.kpoints *= 10.0
    return table


@pytest.fixture(scope="module")
def iso_model():
    phys, arrays = build_model(HeliosConfig(**ISO).finalize(), iso_table(),
                               device="cpu")
    T0 = torch.full((phys.nlayer + 1,), 1000.0, dtype=torch.float64)
    return phys, arrays, T0, rad_mod.radiation_loop(phys, arrays, None, T0)


@pytest.fixture(scope="module")
def conv_model():
    cfg = HeliosConfig(**CONV).finalize()
    phys, arrays = build_model(cfg, conv_table(), device="cpu")
    thermo = rad_mod.make_const_thermo(cfg.kappa_value)
    T0 = torch.full((phys.nlayer + 1,), 900.0, dtype=torch.float64)
    rad = rad_mod.radiation_loop(phys, arrays, thermo, T0)
    return phys, arrays, thermo, rad


def assert_same_state(got, want):
    """Every field of two loop states bit for bit (host values equal)."""
    assert type(got) is type(want)
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f
        elif hasattr(w, "_fields"):
            assert_same_state(g, w)
        elif f != "steps":
            assert g == w, f


def test_chunked_radiation_equals_the_straight_loop(iso_model):
    phys, arrays, T0, straight = iso_model
    assert not bool(straight.keep_running) and straight.it > 37
    chunked = mon.run_radiation_chunked(phys, arrays, None, T0,
                                        chunk_iters=37)
    assert chunked.it == straight.it
    assert torch.equal(chunked.T_lay, straight.T_lay)
    assert torch.equal(chunked.flux.F_up, straight.flux.F_up)
    assert torch.equal(chunked.prefactor, straight.prefactor)


def test_chunked_convection_equals_the_straight_loop(conv_model):
    """150-iteration chunks against one call to convergence, with the
    callbacks seeing the convection phase in order."""
    phys, arrays, thermo, rad = conv_model
    straight = convection_loop(phys, arrays, thermo, rad)
    assert not straight.keep_running and straight.it > 150
    seen = []
    chunked = mon.run_convection_chunked(
        phys, arrays, thermo, rad, chunk_iters=150,
        callbacks=[lambda i: seen.append((i.phase, i.state.it))])
    assert chunked.steps == straight.steps
    assert_same_state(chunked, straight)
    its = [it for _, it in seen]
    assert its == sorted(its) and its[-1] == straight.it
    assert all(ph == "convection" for ph, _ in seen)


def test_callbacks_see_monotonic_progress(iso_model, tmp_path):
    phys, arrays, T0, straight = iso_model
    seen = []
    metrics = mon.MetricsWriter(str(tmp_path / "m.jsonl"))
    with open(tmp_path / "progress.txt", "w") as stream:
        state = mon.run_radiation_chunked(
            phys, arrays, None, T0, chunk_iters=50,
            callbacks=[lambda i: seen.append(i.state.it), metrics,
                       mon.ProgressPrinter(phys.nlayer, stream=stream)])
    assert state.it == straight.it
    assert seen == sorted(seen) and seen[-1] == state.it
    assert all(b - a <= 50 for a, b in zip(seen, seen[1:]))

    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[0].get("event") == "run_start"   # append-mode marker
    recs = recs[1:]
    assert len(recs) == len(seen)
    assert recs[0]["includes_compile"]
    assert not any(r["includes_compile"] for r in recs[1:])
    assert [r["iteration"] for r in recs] == seen
    assert recs[-1]["converged_layers"] == phys.nlayer + 1
    assert recs[0]["it_per_s"] > 0
    assert recs[-1]["T_min"] == float(state.T_lay.min())

    lines = (tmp_path / "progress.txt").read_text().splitlines()
    assert len(lines) == len(seen) and "converged layers" in lines[0]


def test_debug_checker_flags_nonfinite_and_negative(capsys):
    """DebugChecker: negative-flux warnings and finiteness errors (the
    debug=yes analogue of kernels.cu:1456-1459)."""
    class FakeFlux:
        F_down = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
        F_up = torch.tensor([[1.0, 2.0], [3.0, 4.0]])

    class FakeState:
        it = 7
        T_lay = torch.tensor([100.0, 200.0])
        flux = FakeFlux()

    info = mon.ChunkInfo(state=FakeState(), its_done=1, wall_s=0.1,
                         phase="radiation")
    cb = mon.DebugChecker()
    cb(info)
    out = capsys.readouterr().out
    assert "1 negative F_down values at iteration 7" in out
    assert "F_up" not in out

    FakeFlux.F_up = torch.tensor([[1.0, float("inf")], [3.0, 4.0]])
    with pytest.raises(FloatingPointError, match="non-finite F_up"):
        cb(info)
    FakeState.T_lay = torch.tensor([100.0, float("nan")])
    with pytest.raises(FloatingPointError, match="temperature"):
        cb(info)


def test_plot_callback_saves_frames(iso_model, tmp_path, monkeypatch):
    """PlotCallback draws a frame per chunk (saved here); a pipeline run
    with realtime plotting draws one per chunk (chunk_iters 100, as in
    helios_tpu: the chunk is n_plot only when n_plot is smaller) and lands
    bit for bit on the unmonitored run's T."""
    phys, arrays, T0, _ = iso_model
    frames = tmp_path / "frames"
    cb = mon.PlotCallback(phys, 1e8, 1e3, interactive=False,
                          save_dir=str(frames))
    state = mon.run_radiation_chunked(phys, arrays, None, T0,
                                      chunk_iters=None, callbacks=[cb])
    names = os.listdir(frames)
    assert names == [f"frame_{state.it:06d}.png"]
    assert (frames / names[0]).stat().st_size > 5000

    drawn = []
    draw = mon.PlotCallback.__call__
    monkeypatch.setattr(mon.PlotCallback, "__call__", lambda self, info: (
        drawn.append(info.state.it), draw(self, info)))
    plain, plotted = (pipeline.run(
        HeliosConfig(**ISO, name=name, output_dir=str(tmp_path) + "/", **kw),
        iso_table(), write_output=False, device="cpu")
        for name, kw in (("plain", {}), ("plot", {"realtime_plot": "200"})))
    assert plotted.rad.it == plain.rad.it > 200
    assert torch.equal(plotted.T_lay, plain.T_lay)
    assert drawn == [min(i, plain.rad.it)
                     for i in range(100, plain.rad.it + 100, 100)]


def test_pipeline_mid_run_coupling_tp_writes(tmp_path, monkeypatch):
    """coupl_tp_write_interval: the coupling TP file appears during the
    run, not only at the end (computation.py:967-971); the final write is
    the converged profile, BOA row first."""
    B, ny, L = 8, 4, 10
    table = synthetic_premixed_table(nbin=B, ny=ny, ntemp=8, npress=6,
                                     seed=3)
    specs = [chem.SpeciesSpec("H2O", True, False, "1e-3"),
             chem.SpeciesSpec("H2", False, False, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=table.temperatures, kpress=table.pressures,
        nbin=B, ny=ny, nlayer=L, opacity_tables={"H2O": table.kpoints},
        device="cpu")
    cfg = HeliosConfig(**dict(ISO, nlayer=L), name="cpl",
                       output_dir=str(tmp_path) + "/",
                       opacity_mixing="on-the-fly", coupling="yes",
                       coupl_tp_write_interval=30, chunk_iters=30)

    seen = []
    orig = mon.CouplingTPWriter.__call__

    def spy(self, info):
        orig(self, info)
        if os.path.exists(self.path):
            seen.append(info.state.it)

    monkeypatch.setattr(mon.CouplingTPWriter, "__call__", spy)
    out = pipeline.run(cfg, table, sset=sset, device="cpu")
    assert seen and seen[0] == 30 < out.rad.it
    path = tmp_path / "cpl" / "cpl_tp_coupling_0.dat"
    rows = path.read_text().splitlines()
    assert rows[0].startswith("press.")
    assert len(rows) == L + 2
    T = out.result.T_lay
    assert abs(float(rows[1].split()[1]) - T[L]) / T[L] < 1e-5


def test_monitored_run_equals_the_unmonitored_run(tmp_path):
    """pipeline.run with the monitors on (progress, metrics, checkpoints,
    debug, a profile; realtime plots are held by
    test_plot_callback_saves_frames) lands bit for bit on the unmonitored
    run's state and writes the same output files."""
    kw = dict(CONV, output_dir=str(tmp_path) + "/")
    table = conv_table()
    plain = pipeline.run(HeliosConfig(**kw, name="plain"), table,
                         device="cpu")
    monitored = pipeline.run(
        HeliosConfig(**kw, name="mon", progress="yes", debug="yes",
                     metrics_file=str(tmp_path / "m.jsonl"),
                     checkpoint_every=100,
                     profile_dir=str(tmp_path / "profile")),
        table, device="cpu")
    assert monitored.conv is not None and monitored.conv.steps > 0
    assert_same_state(monitored.rad, plain.rad)
    assert_same_state(monitored.conv, plain.conv)
    assert monitored.conv.steps == plain.conv.steps
    assert monitored.n_flux_solves == plain.n_flux_solves
    np.testing.assert_array_equal(monitored.result.T_lay,
                                  plain.result.T_lay)
    assert sorted(os.listdir(tmp_path / "mon")) == sorted(
        ["restart.ckpt.npz", "restart_conv.ckpt.npz"]
        + [n.replace("plain", "mon")
           for n in os.listdir(tmp_path / "plain")])
    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()[1:]]
    phases = [r["phase"] for r in recs]
    assert phases == sorted(phases, reverse=True)   # radiation, convection
    assert recs[-1]["iteration"] == plain.conv.it
    assert os.listdir(tmp_path / "profile")
