"""The readers of the program's spans and counters in the loops
(graphs.Stats replay_s, read_s, adjust_reads, adjust_read_s): a number on
a record of their kind whose Stats carry the fields, nothing to read on a
record of the other kind or of a program whose Stats lack them."""

import pytest

from benchmark import run
from benchmark.core import cell as cell_mod
from benchmark.core.drive import Call

OLD = dict(graphs=3, replays=40, eager=16, reads=50, redos=0,
           iterations=700, past_stop=10, capture_s=0.8, eager_s=1.0,
           rounds=None, idle_launches={})
NEW = dict(OLD, replay_s=0.3, read_s=0.5, adjust_reads=900,
           adjust_read_s=0.2)
KIND = {"read_wait_s.run": "flagship.single",
        "replay_s.run": "flagship.single",
        "read_wait_s.grid": "flagship.grid8",
        "dispatch_s.grid": "flagship.grid8",
        "adjust_reads_per_it.grid": "flagship.grid8"}
# the number of a record of two calls, each with NEW in both loops
WANT = {"read_wait_s.run": 2 * 0.5,
        "replay_s.run": 2 * 0.3,
        "read_wait_s.grid": 2 * (0.5 + 0.2),
        "dispatch_s.grid": 2 * (1.0 - 0.2),
        "adjust_reads_per_it.grid": 900 / 700}


def record(name, stats):
    c = cell_mod.load(name)
    calls = [Call(members=list(range(c.traffic["batch"])), wall_s=3.0,
                  run_wall_s=2.9, rad_s=1.0, conv_s=1.8, flux_solves=719,
                  stats=dict(radiation=stats, convection=stats))] * 2
    return run.record(c.config, c.traffic, calls, None)


@pytest.mark.parametrize("metric", sorted(KIND))
def test_reads_its_fields(metric):
    v = cell_mod.reader(metric)(record(KIND[metric], NEW))
    assert v == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(KIND))
def test_nothing_without_the_fields(metric):
    assert cell_mod.reader(metric)(record(KIND[metric], OLD)) is None


@pytest.mark.parametrize("metric", sorted(KIND))
def test_nothing_in_the_other_kind(metric):
    other = ("flagship.grid8" if KIND[metric] == "flagship.single"
             else "flagship.single")
    assert cell_mod.reader(metric)(record(other, NEW)) is None


@pytest.mark.parametrize("metric", sorted(KIND))
def test_listed_for_the_cells_of_its_kind(metric):
    """The manifest lists the metric for exactly the cells of its kind."""
    entry = next(m for m in cell_mod.manifest()["per_layer"]
                 if m["name"] == metric)
    batch = {w["name"]: cell_mod.load(w["name"]).traffic["batch"] > 1
             for w in cell_mod.manifest()["workloads"]}
    grid = metric.endswith(".grid")
    assert set(entry["workloads"]) == {w for w, b in batch.items()
                                       if b == grid}


def test_no_convection_iterations_is_nothing_to_read():
    st = dict(NEW, iterations=0)
    rec = record("flagship.grid8", st)
    assert cell_mod.reader("adjust_reads_per_it.grid")(rec) is None
