"""The reader of runner_hit_share.run on synthetic records: the share of
the loops' runner lookups that took over a kept runner where the record
carries the program's fields (graphs.Stats cache_hits, cache_misses),
nothing to read on a record without them (the parent's), with no lookup,
or for a batch; and the Stats' fields as the program has them."""

import pytest

from benchmark import run
from benchmark.core import cell as cell_mod
from benchmark.core.drive import Call

BASE = dict(graphs=0, replays=600, eager=2, reads=45, redos=0,
            iterations=650, past_stop=10, capture_s=0.0, eager_s=0.02,
            replay_s=0.03, read_s=1.1, adjust_reads=0, adjust_read_s=0.0,
            rounds=None, idle_launches={}, mix_s=0.0, mixes=0,
            mix_launches=0)


def record(name, radiation, convection, calls=2):
    c = cell_mod.load(name)
    cs = [Call(members=list(range(c.traffic["batch"])), wall_s=2.0,
               run_wall_s=1.9, rad_s=0.4, conv_s=1.4, flux_solves=651,
               stats=dict(radiation=radiation, convection=convection))
          ] * calls
    return run.record(c.config, c.traffic, cs, None)


def kept(hits, misses):
    return dict(BASE, cache_hits=hits, cache_misses=misses)


def test_the_programs_stats_carry_the_fields():
    from helios_tpu_torch.rce import graphs
    st = graphs.Stats().as_dict()
    assert set(st) == set(kept(0, 0))
    assert st["cache_hits"] == st["cache_misses"] == 0


@pytest.mark.parametrize("name, radiation, convection, want", [
    # every solve took both loops' runners over (the entry check and the
    # loop: two lookups of the convection runner)
    ("flagship.single", kept(1, 0), kept(2, 0), 1.0),
    ("flagship_matrix.single", kept(1, 0), kept(1, 1), 2 / 3),
    ("onthefly.rce", kept(0, 1), kept(0, 2), 0.0),
    # the parent's record: Stats without the fields
    ("flagship.single", BASE, BASE, None),
    ("flagship.single", kept(1, 0), BASE, None),
    ("flagship.single", kept(0, 0), kept(0, 0), None),
    ("flagship.grid8", kept(1, 0), kept(2, 0), None),
])
def test_runner_hit_share(name, radiation, convection, want):
    got = cell_mod.reader("runner_hit_share.run")(
        record(name, radiation, convection))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)
        assert 0.0 <= got <= 1.0
