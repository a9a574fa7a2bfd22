"""The on-the-fly cell's judge catches a program whose mixing is broken
underneath: at a planet's reported state, what the program would report
there (``control.forward_report``: its forward model's fluxes, the sweep
carried to its fixed point) is judged by ``reference/rce_onthefly.py``
under the configuration's limits.  The sound program meets ``flux_gap``
with room; the program mixing by correlated-k instead of Random Overlap,
the program's species set without VO (the smallest share of the
opacity), and the program in float32 each fail it.  The state is that of
a tiny solve cut short (the judge's other numbers read the state, which a
cut solve has not brought to equilibrium)."""

import pytest
import torch

from benchmark.tests.conftest import tiny


def cell(**helios):
    return tiny("onthefly.rce", members=1, max_nr_iterations=100, **helios)


def program(c, tmp_path, precision=None):
    from benchmark.core import drive
    return drive.Program(c.config, c.traffic, "cpu", str(tmp_path),
                         precision=precision)


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """(cell, the reference's table, the reported planet)."""
    torch.set_num_threads(2)
    c = cell()
    prog = program(c, tmp_path_factory.mktemp("sound"))
    return c, prog.reference_table, prog.solve([0]).reports[0]


def gap(state, prog):
    from benchmark import control
    from benchmark.reference import rce_onthefly as ref
    c, table, rep = state
    d = ref.deployment(c.config["helios"], c.traffic["members"][0])
    got = ref.check_planet(d, table, control.forward_report(prog, rep, "cpu"),
                           "cpu")
    return got["flux_gap"], c.config["limits"]["flux_gap"]


def test_sound_program_meets_flux_gap(state, tmp_path):
    value, limit = gap(state, program(state[0], tmp_path))
    assert value <= 1e-2 * limit


def test_correlated_k_instead_of_random_overlap(state, tmp_path,
                                                monkeypatch):
    from helios_tpu_torch.ops import mixing
    add = mixing.add_species_opacity
    monkeypatch.setattr(
        mixing, "add_species_opacity",
        lambda *a, **kw: add(*a, **dict(kw, ro_method=0)))
    value, limit = gap(state, program(state[0], tmp_path))
    assert value > limit


def test_vo_left_out(state, tmp_path, monkeypatch):
    from helios_tpu_torch import chem
    build = chem.build_species_set

    def without_vo(specs, **kw):
        kw["opacity_tables"] = {k: v for k, v in kw["opacity_tables"].items()
                                if k != "VO"}
        return build([s for s in specs if s.name != "VO"], **kw)

    monkeypatch.setattr(chem, "build_species_set", without_vo)
    prog = program(state[0], tmp_path)
    assert "VO" not in [s.name for s in prog.program["sset"].specs]
    value, limit = gap(state, prog)
    assert value > limit


def test_float32(state, tmp_path):
    value, limit = gap(state, program(state[0], tmp_path,
                                      precision="single"))
    assert value > limit
