"""The spans and counters of the port's run phases and loops
(helios_tpu_torch.rce.graphs.span, graphs.Stats), on the CPU, counts and
structure only (no time is compared with a threshold).

A tiny ``pipeline.run`` and a tiny two-member ``run_ensemble`` (the small
scenario of tests/torch_port_helpers.py at 8 bins, a physical timestep: 40
radiation iterations, then one convective adjustment and solve), and the
batch again in ``graphs.loops(graphs.PER_ITERATION)``, run under
torch.profiler: each is one ``helios.run`` range holding ``helios.prepare``,
``helios.radiation``, ``helios.convection`` and ``helios.result`` in that
order, and the loops' ranges match their Stats one for one: every
``helios.read`` is a runner's read (``reads``) or the convection loop's
entry read, every ``helios.iteration`` an eager iteration, every
``helios.adjust_read`` a blocking read of an unbounded adjustment
(``adjust_reads``): the per-iteration batch's; the chunked loops bound
their adjustments and read none.  Without a profiler no range is entered,
and the spans still time into the Stats.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helios_tpu_torch import pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.parallel import ensemble
from helios_tpu_torch.rce import graphs

import torch_port_helpers as H

# 40 radiation iterations stopped by the run time, one adjustment
SHORT = dict(physical_tstep=1e4, runtime_limit=4e5)
KINDS = ("single", "batch", "batch per iteration")
PHASES = ["helios.prepare", "helios.radiation", "helios.convection",
          "helios.result"]
NEW_FIELDS = ("replay_s", "read_s", "adjust_reads", "adjust_read_s")
TRACED = {}


def _solve(kind):
    """The run's outputs (one per planet) and its loops' Stats."""
    table = H.small_table(8)
    settings = graphs.PER_ITERATION if kind == "batch per iteration" else None
    with graphs.loops(settings) as lp:
        if kind == "single":
            cfg = HeliosConfig(**dict(H.SMALL_RUN, **SHORT)).finalize()
            outs = [pipeline.run(cfg, table, write_output=False,
                                 device="cpu")]
        else:
            cfgs = [HeliosConfig(**dict(H.SMALL_RUN, **SHORT,
                                        name=f"m{k}")).finalize()
                    for k in range(2)]
            outs = ensemble.run_ensemble(cfgs, tables=[table] * 2,
                                         write_output=False, device="cpu")
    return outs, lp.stats


def _traced(kind):
    """(outputs, Stats, the helios.* ranges as (start, end, name) in start
    order) of one run under the profiler, made once per kind."""
    if kind not in TRACED:
        torch.set_num_threads(2)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs, stats = _solve(kind)
        ranges = sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("helios."))
        TRACED[kind] = outs, stats, ranges
    return TRACED[kind]


def _inside(ranges, outer):
    """The names of the ranges that lie within the range ``outer``."""
    s0, e0, _ = outer
    return [n for s, e, n in ranges if s0 <= s and e <= e0
            and (s, e, n) != outer]


def _the(ranges, name):
    found = [r for r in ranges if r[2] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


@pytest.mark.parametrize("kind", KINDS)
def test_run_is_one_range_of_its_phases_in_order(kind):
    """One helios.run holds every other range, and its four phases each
    once, one after the other."""
    _, _, ranges = _traced(kind)
    run = _the(ranges, "helios.run")
    assert len(_inside(ranges, run)) == len(ranges) - 1
    phases = [_the(ranges, p) for p in PHASES]
    assert [p[2] for p in sorted(phases)] == PHASES
    for a, b in zip(phases, phases[1:]):
        assert a[1] <= b[0], (a[2], b[2])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("loop", ["radiation", "convection"])
def test_loop_ranges_match_their_stats(kind, loop):
    """Inside a loop's phase: one helios.read per runner read (and the
    convection loop's entry read), one helios.iteration per eager
    iteration, one helios.adjust_read per counted adjustment read, and no
    capture or replay on the CPU."""
    _, stats, ranges = _traced(kind)
    names = _inside(ranges, _the(ranges, f"helios.{loop}"))
    st = stats[loop]
    entry = loop == "convection"
    assert names.count("helios.read") == st.reads + entry
    assert names.count("helios.iteration") == st.eager
    assert names.count("helios.adjust_read") == st.adjust_reads
    assert names.count("helios.capture") == st.graphs == 0
    assert names.count("helios.replay") == st.replays == 0
    assert st.read_s > 0.0 and st.eager_s > 0.0
    if loop == "radiation":
        assert "helios.refresh" in names


@pytest.mark.parametrize("kind", KINDS)
def test_adjustment_reads_are_counted_where_unbounded(kind):
    """The per-iteration batch runs its adjustments unbounded
    (graphs.PER_ITERATION): each is a helios.adjust, whose blocking reads
    the convection Stats count; the chunked loops' adjustments, one
    planet's and a batch's, are bounded and read nothing."""
    _, stats, ranges = _traced(kind)
    conv = stats["convection"]
    adjusts = [r for r in ranges if r[2] == "helios.adjust"]
    if kind == "batch per iteration":
        assert conv.adjust_reads > 0 and conv.adjust_read_s > 0.0
        assert len(adjusts) == conv.iterations
    else:
        assert conv.adjust_reads == 0 and conv.adjust_read_s == 0.0
        assert not adjusts
    assert stats["radiation"].adjust_reads == 0


@pytest.mark.parametrize("kind", KINDS)
def test_walls_are_the_spans(kind):
    """The RunOutput walls come from the spans: the loops lie inside the
    run, and every member of a batch carries the batch's one wall."""
    outs, _, ranges = _traced(kind)
    assert len({o.wall_seconds for o in outs}) == 1
    for o in outs:
        assert o.wall_seconds >= o.rad_seconds + o.conv_seconds
        assert o.rad_seconds > 0.0 and o.conv_seconds > 0.0
    run, rad, conv = (_the(ranges, f"helios.{p}")
                      for p in ("run", "radiation", "convection"))
    assert run[1] - run[0] >= (rad[1] - rad[0]) + (conv[1] - conv[0])


@pytest.mark.parametrize("kind", KINDS)
def test_no_range_without_a_profiler(kind, monkeypatch):
    """With no profiler recording, record_function is never entered; the
    spans still time into the Stats."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    torch.set_num_threads(2)
    outs, stats = _solve(kind)
    assert stats["radiation"].eager_s > 0.0
    assert stats["convection"].read_s > 0.0
    assert outs[0].wall_seconds > 0.0


@pytest.mark.parametrize("field", NEW_FIELDS)
def test_new_stats_fields_default_to_zero(field):
    st = graphs.Stats()
    assert getattr(st, field) == 0
    assert st.as_dict()[field] == 0


@pytest.mark.parametrize("field", ["eager_s", "read_s", None])
def test_span_adds_its_seconds_to_a_field(field):
    """A span adds its own seconds to the named field (twice: the sum of
    both), or to nothing without Stats."""
    st = graphs.Stats()
    stats = st if field else None
    with graphs.span("helios.test", stats, field) as a:
        pass
    with graphs.span("helios.test", stats, field) as b:
        pass
    assert a.seconds >= 0.0 and b.seconds >= 0.0
    if field:
        assert getattr(st, field) == pytest.approx(a.seconds + b.seconds)
    others = lambda d: {k: v for k, v in d.items() if k != field}
    assert others(st.as_dict()) == others(graphs.Stats().as_dict())


def test_span_is_a_range_and_closes_on_error():
    """Under the profiler a span is a range of its name, nested under the
    span it was entered in; an error closes it and passes through."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with graphs.span("helios.outer"):
            with pytest.raises(ValueError):
                with graphs.span("helios.inner"):
                    raise ValueError("passes through")
    got = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("helios."))
    assert [n for _, _, n in got] == ["helios.outer", "helios.inner"]
    assert got[0][0] <= got[1][0] and got[1][1] <= got[0][1]


def test_loop_stats_follow_the_open_block():
    """graphs.loop_stats: None outside a block; in one, a kind's Stats
    (the runner's own), and without a kind the running loop's (none
    between loops)."""
    assert graphs.loop_stats("convection") is None
    assert graphs.loop_stats() is None
    with graphs.loops() as lp:
        st = graphs.loop_stats("convection")
        assert lp.stats["convection"] is st
        assert graphs.loop_stats() is None
