"""The reader of adjust_launches_per_it.run on synthetic records: the
convection loop's conv_adjust launches over its iterations run and
replayed past the stop, where the record carries the program's field
(graphs.Stats adjust_launches); nothing to read on a record without it
(the parent's), with no convection iteration, or for a batch; and the
field as the program's Stats have it."""

import pytest

from benchmark import run
from benchmark.core import cell as cell_mod
from benchmark.core.drive import Call

BASE = dict(graphs=0, replays=600, eager=2, reads=45, redos=0,
            iterations=440, past_stop=8, capture_s=0.0, eager_s=0.02,
            replay_s=0.03, read_s=1.1, adjust_reads=0, adjust_read_s=0.0,
            rounds=None, idle_launches={}, mix_s=0.0, mixes=0,
            mix_launches=0, cache_hits=1, cache_misses=0)


def record(name, radiation, convection, calls=2):
    c = cell_mod.load(name)
    cs = [Call(members=list(range(c.traffic["batch"])), wall_s=2.0,
               run_wall_s=1.9, rad_s=0.4, conv_s=1.4, flux_solves=651,
               stats=dict(radiation=radiation, convection=convection))
          ] * calls
    return run.record(c.config, c.traffic, cs, None)


def launched(n, **kw):
    return dict(BASE, adjust_launches=n, **kw)


def test_the_programs_stats_carry_the_field():
    from helios_tpu_torch.rce import graphs
    assert graphs.Stats().as_dict()["adjust_launches"] == 0


@pytest.mark.parametrize("name, convection, want", [
    # one launch per adjustment: every iteration, past the stop too
    ("flagship.single", launched(448), 1.0),
    ("flagship_matrix.single", launched(448), 1.0),
    ("onthefly.rce", launched(448), 1.0),
    # a chunk of 16 redone with unbounded rounds: its first tries and a
    # launch per read of each redone adjustment
    ("flagship.single", launched(448 + 16 * 3, redos=1, adjust_reads=48),
     (448 + 48) / 448),
    # the parent's record: Stats without the field
    ("flagship.single", BASE, None),
    ("flagship.single", launched(0, iterations=0, past_stop=0), None),
    ("flagship.grid8", launched(448), None),
])
def test_adjust_launches_per_it(name, convection, want):
    got = cell_mod.reader("adjust_launches_per_it.run")(
        record(name, launched(0), convection))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)


def test_no_convection_loop_reads_nothing():
    c = cell_mod.load("flagship.single")
    cs = [Call(members=[0], wall_s=2.0, run_wall_s=1.9, rad_s=0.4,
               conv_s=0.0, flux_solves=651,
               stats=dict(radiation=launched(0)))]
    rec = run.record(c.config, c.traffic, cs, None)
    assert cell_mod.reader("adjust_launches_per_it.run")(rec) is None
