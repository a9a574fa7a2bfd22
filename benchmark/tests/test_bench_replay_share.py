"""The reader of replay_share.grid on synthetic records: the share of a
batch's iterations that replayed a graph, 0.0 for a batch that ran every
iteration eagerly, nothing to read for one planet's solves."""

import pytest

from benchmark.core import cell as cell_mod


def record(kind, *stats):
    """A record of one call per entry of ``stats``, each {loop: Stats}."""
    return dict(kind=kind, calls=[dict(stats=s) for s in stats],
                profile=None)


def loops(replays, eager):
    return dict(radiation=dict(replays=replays[0], eager=eager[0]),
                convection=dict(replays=replays[1], eager=eager[1]))


@pytest.mark.parametrize("kind, stats, want", [
    ("grid", [loops((600, 500), (30, 80)), loops((620, 500), (30, 60))],
     2220 / 2420),
    ("grid", [loops((0, 0), (690, 470))], 0.0),
    ("single", [loops((600, 500), (30, 80))], None),
])
def test_replay_share(kind, stats, want):
    got = cell_mod.reader("replay_share.grid")(record(kind, *stats))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)
        assert 0.0 <= got <= 1.0
