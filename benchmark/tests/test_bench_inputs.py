"""A configuration's ``inputs`` (``benchmark/inputs``): ``make`` is called
once with the run's configuration, its ``program`` keywords reach both
entry points, its ``reference`` arrays the judge; a configuration without it
calls the entry points and the judge exactly as before; and a tiny
on-the-fly run through ``Program.solve`` converges with the species set
its inputs module built."""

import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark.core import drive
from benchmark.tests.conftest import run_tiny, tiny


class Called(Exception):
    """Raised by a recording entry point once it has recorded its call."""


def probe(monkeypatch, **returned):
    """Register ``benchmark.inputs.probe``, whose ``make`` records its
    arguments and returns ``returned``; returns the record."""
    seen = {}

    def make(cfg, table_fields, tmpdir, device):
        seen.update(cfg=cfg, table_fields=table_fields, tmpdir=tmpdir,
                    device=device)
        return dict(dict(program={}, reference={}), **returned)

    mod = types.ModuleType("benchmark.inputs.probe")
    mod.make = make
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return seen


def record_entry_points(monkeypatch):
    """Replace pipeline.run and run_ensemble by recorders; returns the
    calls as (entry point, args, kwargs)."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.parallel import ensemble
    calls = []

    def recorder(name):
        def entry(*args, **kwargs):
            calls.append((name, args, kwargs))
            raise Called(name)
        return entry

    monkeypatch.setattr(pipeline, "run", recorder("run"))
    monkeypatch.setattr(ensemble, "run_ensemble", recorder("run_ensemble"))
    return calls


def program(c, tmp_path, precision=None):
    return drive.Program(c.config, c.traffic, "cpu", str(tmp_path),
                         precision=precision)


def test_make_is_called_once_and_members_keep_their_fields(monkeypatch,
                                                          tmp_path):
    calls = []

    def make(cfg, table_fields, tmpdir, device):
        calls.append(dict(cfg=cfg, table_fields=table_fields, tmpdir=tmpdir,
                          device=device))
        return dict(program={}, reference={})

    mod = types.ModuleType("benchmark.inputs.probe")
    mod.make = make
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    c = tiny("flagship.grid8", members=3)
    c.config["inputs"] = "probe"
    prog = program(c, tmp_path)
    (seen,) = calls
    assert seen["tmpdir"] == str(tmp_path) and seen["device"] == "cpu"
    assert seen["table_fields"] is prog.table_fields
    assert seen["cfg"]["helios"] == c.config["helios"]
    for k, cfg in enumerate(prog.cfgs):
        assert cfg.T_intern == c.config["helios"]["T_intern"]
        assert cfg.surf_albedo == pytest.approx(    # 0 is read as 1e-8
            c.traffic["members"][k]["surf_albedo"], abs=1e-8)
        assert cfg.name == f"member{k}"


def test_make_sees_the_precision_run(monkeypatch, tmp_path):
    seen = probe(monkeypatch)
    c = tiny("flagship.single")
    c.config["inputs"] = "probe"
    prog = program(c, tmp_path, precision="single")
    assert seen["cfg"]["helios"]["precision"] == "single"
    assert prog.cfgs[0].precision == "single"
    assert c.config["helios"]["precision"] == "double"


def test_program_reaches_both_entry_points(monkeypatch, tmp_path):
    sset = object()
    probe(monkeypatch, program=dict(sset=sset))
    calls = record_entry_points(monkeypatch)
    c = tiny("flagship.grid8")
    c.config["inputs"] = "probe"
    prog = program(c, tmp_path)
    for members in ([1], [0, 1]):
        with pytest.raises(Called):
            prog.solve(members)
    assert [name for name, _, _ in calls] == ["run", "run_ensemble"]
    for _, _, kwargs in calls:
        assert kwargs["sset"] is sset


def test_no_inputs_calls_the_entry_points_as_before(monkeypatch, tmp_path):
    calls = record_entry_points(monkeypatch)
    c = tiny("flagship.grid8")
    assert "inputs" not in c.config
    prog = program(c, tmp_path)
    assert prog.program == {} and prog.reference_table is prog.table_fields
    for members in ([1], [1, 0]):
        with pytest.raises(Called):
            prog.solve(members)
    (_, args1, kw1), (_, args2, kw2) = calls
    assert args1 == (prog.cfgs[1], prog.table)
    assert kw1 == dict(write_output=False, device="cpu")
    assert args2 == ([prog.cfgs[1], prog.cfgs[0]],)
    assert kw2 == dict(tables=[prog.table] * 2, write_output=False,
                       device="cpu")


@pytest.mark.parametrize("inputs", [False, True])
def test_reference_reaches_the_judge(monkeypatch, inputs, tmp_path):
    from benchmark.core import judge
    extra = dict(species_vmr=np.array([1e-3, 1e-4]))
    probe(monkeypatch, reference=extra)
    tables = []
    judged = judge.judge

    def judge_recording(cfg, traffic, table, reports, device):
        tables.append(table)
        return judged(cfg, traffic, table, reports, device)

    monkeypatch.setattr(judge, "judge", judge_recording)
    # cut short: the judge still reads every planet, which then failed
    c = tiny("flagship.single", members=1, max_nr_iterations=40)
    if inputs:
        c.config["inputs"] = "probe"
    out = run_tiny(c)
    assert out["attempted"] == out["failed"] == 1
    assert np.isfinite(out["checks"]["flux_gap"]["value"])
    (table,) = tables
    fields = set(table) - set(extra)
    assert fields == {"kpoints", "temperatures", "pressures", "wave_centers",
                      "wave_edges", "delta_wave", "gauss_y", "scat_cross",
                      "meanmolmass"}
    assert (set(extra) <= set(table)) == inputs
    if inputs:
        assert table["species_vmr"] is extra["species_vmr"]


def premixed_grid_reference(monkeypatch):
    """``benchmark.reference.premixed_grid``: the premixed reference's
    deployment and pressure grid, which the mixing does not change, for a
    configuration that mixes on the fly (``drive.Program`` reads the start
    profile's grid from its reference)."""
    from benchmark.reference import rce_premixed
    mod = types.ModuleType("benchmark.reference.premixed_grid")
    mod.deployment = lambda helios, member: rce_premixed.deployment(
        dict(helios, opacity_mixing="premixed"), member)
    mod.pressure_grid = rce_premixed.pressure_grid
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


@pytest.mark.parametrize("members", [[0], [0, 1]])
def test_tiny_on_the_fly_run_converges(monkeypatch, members, tmp_path):
    from benchmark.tests import onthefly_inputs
    monkeypatch.setitem(sys.modules, "benchmark.inputs.tiny_onthefly",
                        onthefly_inputs)
    premixed_grid_reference(monkeypatch)
    torch.set_num_threads(2)
    c = tiny("flagship.grid8")
    c.config.update(inputs="tiny_onthefly", reference="premixed_grid")
    c.config["helios"]["opacity_mixing"] = "on-the-fly"
    t0 = time.perf_counter()
    prog = program(c, tmp_path)
    assert all(cfg.opacity_mixing == "on-the-fly" for cfg in prog.cfgs)
    assert len(prog.program["sset"].specs) == 4
    assert set(prog.reference_table["species_kpoints"]) == {"H2O", "CO2"}
    call = prog.solve(members)
    assert time.perf_counter() - t0 < 30.0
    assert [r["member"] for r in call.reports] == members
    for r in call.reports:
        assert r["converged"] and r["finite"]
