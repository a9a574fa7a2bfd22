"""A batch of planets in chunks (helios_tpu_torch.rce.graphs): the batch
of a model whole on one device runs the chunked, predicated path that one
planet takes, with static buffers, one read of the device per chunk and
the adjustment bounded to ``rounds``; on the CPU it runs eagerly (on the
card each iteration is a replayed CUDA graph).  It is bit for bit the
per-iteration batch (``graphs.PER_ITERATION``, unbounded adjustments, a
read after every iteration).

The small scenario (tests/torch_port_helpers.py) at 8 bins as a
``run_ensemble`` of three members that differ in surface albedo and stop
at different iterations of both loops: every tensor of each member's
final states of both loops, both counts and the flags equal those of the
per-iteration batch, rtol 0, at chunks of 1, 3 and 16; with bounds that
hold every adjustment (no redo, no read of the adjustment's rounds) and
with one round per adjustment (chunks redone from their snapshots).
"""

import pytest
import torch

from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.parallel import ensemble
from helios_tpu_torch.rce import graphs

import torch_port_helpers as H

NBIN = 8
# members that stop at different iterations: the radiation loop after 779,
# 806 and 794 iterations, the convection loop after 465, 468 and 456 steps
ALBEDOS = (0.0, 0.3, 0.6)
SETTINGS = {
    "chunk 1": graphs.Settings(chunk=1),
    "chunk 3": graphs.Settings(chunk=3),
    "chunk 16": graphs.Settings(chunk=16),
    # the scenario's adjustments need at most 5 rounds
    "no redo": graphs.Settings(chunk=16, rounds=6),
    "forced redo": graphs.Settings(chunk=16, rounds=1, entry_rounds=1),
}
REFERENCE = []


def run_batch(settings):
    """The members' RunOutputs and the loops' Stats of one run_ensemble of
    the batch inside ``graphs.loops(settings)``."""
    cfgs = [HeliosConfig(**dict(H.SMALL_RUN, name=f"member{k}",
                                surf_albedo=a)).finalize()
            for k, a in enumerate(ALBEDOS)]
    with graphs.loops(settings) as lp:
        outs = ensemble.run_ensemble(cfgs,
                                     tables=[H.small_table(NBIN)] * len(cfgs),
                                     write_output=False, device="cpu")
    return outs, lp.stats


def batch_reference():
    """The per-iteration batch, run once per process."""
    if not REFERENCE:
        REFERENCE.append(run_batch(graphs.PER_ITERATION)[0])
    return REFERENCE[0]


def assert_same_members(got, want):
    """Each member's final states of both loops, its final T and flux
    totals, bit for bit."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        H.assert_same_state(g.rad, w.rad, f"member {k} rad")
        H.assert_same_state(g.conv, w.conv, f"member {k} conv")
        assert torch.equal(g.T_lay, w.T_lay), k
        for f in w.totals._fields:
            assert torch.equal(getattr(g.totals, f), getattr(w.totals, f))


@pytest.mark.parametrize("case", list(SETTINGS))
def test_batch_in_chunks_is_the_per_iteration_batch(case):
    """run_ensemble in chunks equals the per-iteration batch bit for bit,
    member by member; the runners read the device once per chunk (and at
    entry), and the adjustment's rounds only in a redone chunk; a batch's
    iteration counts once in the rounds' histogram."""
    want = batch_reference()
    settings = SETTINGS[case]
    got, stats = run_batch(settings)
    assert_same_members(got, want)

    # the members stop at different iterations of both loops
    assert len({o.rad.it for o in want}) == len(ALBEDOS)
    assert len({o.conv.steps for o in want}) == len(ALBEDOS)
    assert not any(o.rad.aborted or o.conv.keep_running for o in want)

    rad, conv = stats["radiation"], stats["convection"]
    n_rad = max(o.rad.it for o in want)
    n_conv = max(o.conv.steps for o in want)
    chunks = lambda n: -(-n // settings.chunk)
    assert rad.iterations == n_rad and conv.iterations == n_conv
    assert rad.reads == 1 + chunks(n_rad)                 # entry, chunks
    # the convection loop's entry call (max_steps 0) reads once more, and
    # a redone chunk reads again
    assert conv.reads == 2 + chunks(n_conv) + conv.redos
    assert rad.graphs == conv.graphs == rad.replays == conv.replays == 0
    assert rad.adjust_reads == 0
    assert (conv.adjust_reads > 0) == (conv.redos > 0)
    if settings.chunk > 1:          # the first members stop inside a chunk
        assert rad.past_stop > 0
    if case == "no redo":
        assert conv.redos == 0 and conv.adjust_reads == 0
        assert sum(conv.rounds) == n_conv
        assert conv.rounds[-1] == 0
    if case == "forced redo":
        assert conv.redos > 0
        assert conv.rounds[-1] > 0      # more than one round, first tries
