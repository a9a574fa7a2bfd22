"""The readers of the on-the-fly mixing's metrics (mix_host_s.run,
ro_launches_per_mix.run, ro_mix_roofline.run) on synthetic records: a
number where the record carries the program's mixing fields (graphs.Stats
mix_s, mixes, mix_launches) or ro_mix's device time, nothing to read on a
premixed record, on the parent's record of the cell (Stats without the
fields) or on a grid's, and the Stats' fields as the program has them."""

import pytest

from benchmark import run
from benchmark.core import cell as cell_mod
from benchmark.core.drive import Call
from benchmark.frozen import costs

BASE = dict(graphs=3, replays=40, eager=16, reads=50, redos=0,
            iterations=700, past_stop=10, capture_s=0.8, eager_s=1.0,
            replay_s=0.03, read_s=1.1, adjust_reads=30, adjust_read_s=0.1,
            rounds=None, idle_launches={})
MIXED = dict(BASE, mix_s=0.25, mixes=134, mix_launches=1608)
PREMIXED = dict(BASE, mix_s=0.0, mixes=0, mix_launches=0)
PROFILE = dict(window_s=5.0, busy_s=1.7, device_s=1.8,
               kernels=dict(noniso_sweep=(0.12, 700),
                            ro_mix=(0.31, 1608)),
               missing=[], attempts=1, events=10, reduce_s=1.0)
MIX_METRICS = ("mix_host_s.run", "ro_launches_per_mix.run",
               "ro_mix_roofline.run")


def record(name, stats, profile=PROFILE, calls=2):
    c = cell_mod.load(name)
    cs = [Call(members=list(range(c.traffic["batch"])), wall_s=4.0,
               run_wall_s=3.9, rad_s=1.0, conv_s=2.8, flux_solves=719,
               stats=dict(radiation=stats, convection=stats))] * calls
    return run.record(c.config, c.traffic, cs, profile)


def test_the_programs_stats_carry_the_fields():
    from helios_tpu_torch.rce import graphs
    assert set(graphs.Stats(mixes=1).as_dict()) == set(MIXED)
    st = graphs.Stats().as_dict()
    assert set(st) == set(PREMIXED)
    assert {k: st[k] for k in MIXED.keys() - BASE.keys()} == {
        k: PREMIXED[k] for k in MIXED.keys() - BASE.keys()}


def test_numbers_on_the_cells_record():
    rec = record("onthefly.rce", MIXED)
    read = {m: cell_mod.reader(m)(rec) for m in MIX_METRICS}
    assert read["mix_host_s.run"] == pytest.approx(2 * 2 * 0.25 / 2)
    assert read["ro_launches_per_mix.run"] == pytest.approx(12.0)
    L, B, Y = 105, 385, 20
    bound = costs.ro_mix((2 * L + 1) * B / 2.0, Y, 0)["bound_s"]
    assert read["ro_mix_roofline.run"] == pytest.approx(
        100.0 * bound / (0.31 / 1608))
    assert 0.0 < read["ro_mix_roofline.run"] <= 100.0
    # the bound is the bytes' at ny = 20 with no negligible cell or all
    assert costs.ro_mix(L * B, Y, 0)["by"] == "bytes"
    assert costs.ro_mix(L * B, Y, L * B)["by"] == "bytes"


def test_one_loop_that_did_not_mix_counts_as_zero():
    c = cell_mod.load("onthefly.rce")
    calls = [Call(members=[0], wall_s=4.0, run_wall_s=3.9, rad_s=1.0,
                  conv_s=2.8, flux_solves=719,
                  stats=dict(radiation=MIXED, convection=PREMIXED))]
    rec = run.record(c.config, c.traffic, calls, PROFILE)
    assert cell_mod.reader("mix_host_s.run")(rec) == pytest.approx(0.25)
    assert cell_mod.reader("ro_launches_per_mix.run")(rec) == 12.0


@pytest.mark.parametrize("metric", MIX_METRICS)
def test_nothing_without_the_fields(metric):
    """The parent's run of the cell: its Stats lack the fields (and a
    premixed trace has no ro_mix)."""
    no_ro = dict(PROFILE, kernels=dict(noniso_sweep=(0.12, 700)))
    rec = record("onthefly.rce", BASE, profile=no_ro)
    assert cell_mod.reader(metric)(rec) is None


@pytest.mark.parametrize("stats", [BASE, PREMIXED],
                         ids=["parent", "premixed"])
@pytest.mark.parametrize("metric", MIX_METRICS)
def test_nothing_in_the_premixed_cells_or_a_grid(metric, stats):
    """The premixed cells' records, from the parent (no mixing fields) or
    from this program (the fields at zero), and a grid's."""
    for name in ("flagship.single", "flagship_matrix.single"):
        no_ro = dict(PROFILE, kernels=dict(noniso_sweep=(0.12, 700)))
        assert cell_mod.reader(metric)(record(name, stats, no_ro)) is None
    assert cell_mod.reader(metric)(record("flagship.grid8", MIXED)) is None


def test_no_profile_is_nothing_for_the_roofline():
    rec = record("onthefly.rce", MIXED, profile=None)
    assert cell_mod.reader("ro_mix_roofline.run")(rec) is None


def test_listed_for_the_cell_alone():
    for entry in cell_mod.manifest()["per_layer"]:
        if entry["name"] in MIX_METRICS:
            assert entry["workloads"] == ["onthefly.rce"]
            assert entry["moves"] == "run_seconds"
