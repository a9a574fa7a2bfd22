"""The loops of one planet in chunks (helios_tpu_torch.rce.graphs): the
predicated body, chunk after chunk with one read of the device each, is bit
for bit the per-iteration loop on the CPU, where it runs eagerly (on the
card each iteration is a replayed CUDA graph; chip_smoke.py holds that).

The small scenario (tests/torch_port_helpers.py) at 8 bins: every tensor
of both loops' final states, both counts, the flags and the criterion
equal those of the per-iteration loop (``graphs.PER_ITERATION``), rtol 0,
at chunks of 1, 3 and 16 iterations; for a run that converges inside a chunk, one that
overheats at the surface (the jump to the convection loop at iteration
200), and one whose criterion is relaxed twice and which hits the
iteration cap in the radiation loop (and is relaxed once in the
convection loop), and one of a physical timestep (40 iterations, stopped
by its run time, then one convective adjustment).  Also: monitored chunks of ``max_steps`` (the callbacks see
the same states at the same iterations, and the states they keep are not
overwritten by later chunks); a resume from a state in the middle of each
loop; an adjustment that needs more rounds than a chunk's graphs hold
(rounds = 1: the chunk is redone from its snapshot); and one run against
the JAX package at the bounds of ROADMAP C (equal convection counts, T at
rtol 1e-10 against its native fp64 Planck lookup).

A replay runs the ops that its key's capture recorded, so every eager
iteration that a graph would hold is recorded op by op (a
``TorchFunctionMode``): the iterations of one key run the same ops with the
same host numbers, and none reads the device; so do a batch's.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)

from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu_torch import pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.rce import graphs, loop, radiative

import torch_port_helpers as H
from test_torch_device_loop_batch import (assert_same_members,
                                          batch_reference, run_batch)

NBIN = 8
CASES = {
    "converging": {},
    "overheating": dict(plancktable_dim=760, max_nr_iterations=700),
    "relaxed and capped": dict(crit_relaxation_numbers=[200.0, 500.0],
                               max_nr_iterations=650),
    # 40 iterations of a constant timestep, then one adjustment
    "physical timestep": dict(physical_tstep=1e4, runtime_limit=4e5),
}
REFERENCES = {}


def _run(extra, **kw):
    cfg = HeliosConfig(**dict(H.SMALL_RUN, **extra)).finalize()
    return pipeline.run(cfg, H.small_table(NBIN), write_output=False,
                        device="cpu", **kw)


def _reference(case):
    if case not in REFERENCES:
        with graphs.loops(graphs.PER_ITERATION):
            REFERENCES[case] = _run(CASES[case])
    return REFERENCES[case]


def _assert_same_run(got, want):
    H.assert_same_state(got.rad, want.rad, "rad")
    assert (got.conv is None) == (want.conv is None)
    if want.conv is not None:
        H.assert_same_state(got.conv, want.conv, "conv")
    assert torch.equal(got.T_lay, want.T_lay)
    for f in want.totals._fields:
        assert torch.equal(getattr(got.totals, f), getattr(want.totals, f))


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_run_is_the_per_iteration_run(case, chunk):
    """pipeline.run in chunks equals the per-iteration run bit for bit:
    final states of both loops (T, fluxes, cache, totals, flags), both
    counts, the criterion, goto_convection and aborted."""
    want = _reference(case)
    with graphs.loops(graphs.Settings(chunk=chunk)) as lp:
        got = _run(CASES[case])
    _assert_same_run(got, want)
    rad = lp.stats["radiation"]
    assert rad.iterations == want.rad.it
    assert rad.reads == 1 + -(-want.rad.it // chunk)    # entry, chunks
    if case == "converging":
        assert not want.rad.aborted and not want.conv.keep_running
        if chunk > 1:      # it stopped inside a chunk
            assert rad.past_stop + lp.stats["convection"].past_stop > 0
    if case == "overheating":
        assert bool(want.rad.goto_convection) and want.rad.it == 201
        assert want.conv is not None and want.conv.steps > 0
    if case == "relaxed and capped":
        limit = want.phys.rad_convergence_limit
        assert want.rad.aborted and want.rad.it == 651
        assert want.rad.local_limit == pytest.approx(100 * limit)
        assert want.conv.it > 200            # relaxed again at iteration 200
        assert want.conv.local_limit == pytest.approx(10 * limit)
    if case == "physical timestep":
        assert want.rad.it == 40 and want.conv.steps == 1
        if chunk > 1:      # stopped by its run time inside a chunk
            assert rad.past_stop > 0


def test_monitored_chunks_see_the_same_states():
    """Chunks of max_steps = 50 through the monitor (pipeline.run with a
    callback): the callbacks see the same iterations and states, and the
    states they keep stay as they were after later chunks; a chunk of the
    graphs (16) never crosses a max_steps boundary."""
    def record(seen):
        def cb(info):
            seen.append((info.phase, info.its_done, info.state,
                         info.state.T_lay.clone()))
        return cb

    extra = dict(chunk_iters=50)
    want, got = [], []
    with graphs.loops(graphs.PER_ITERATION):
        ref = _run(extra, callbacks=[record(want)])
    with graphs.loops(graphs.Settings(chunk=16)):
        out = _run(extra, callbacks=[record(got)])
    _assert_same_run(out, ref)
    assert len(got) == len(want) > 4
    for (gp, gn, gs, gT), (wp, wn, ws, wT) in zip(got, want):
        assert (gp, gn) == (wp, wn)
        assert torch.equal(gs.T_lay, gT), "a kept state was overwritten"
        assert torch.equal(gT, wT)
        H.assert_same_state(gs, ws, gp)


def test_resume_from_a_state_in_each_loop():
    """A state from the middle of each loop, restarted with state0 (as a
    restored checkpoint is): the chunked loop ends bit for bit as the
    per-iteration loop from the same state."""
    seen = []
    cfg = HeliosConfig(**dict(H.SMALL_RUN, chunk_iters=100)).finalize()
    table = H.small_table(NBIN)
    with graphs.loops(graphs.PER_ITERATION):
        out = pipeline.run(cfg, table, write_output=False, device="cpu",
                           callbacks=[lambda info: seen.append(info)])
    thermo = pipeline.make_thermo(cfg, device="cpu")
    rad_mid = next(i.state for i in seen if i.phase == "radiation"
                   and i.state.it == 300)
    conv_mid = next(i.state for i in seen if i.phase == "convection"
                    and i.state.it >= 200)
    runs = {}
    for mode in ("per", "chunked"):
        settings = (graphs.PER_ITERATION if mode == "per"
                    else graphs.Settings(chunk=16))
        with graphs.loops(settings):
            rad = radiative.radiation_loop(out.phys, out.arrays, thermo,
                                           rad_mid.T_lay, state0=rad_mid)
            conv = loop.convection_loop(out.phys, out.arrays, thermo, None,
                                        state0=conv_mid)
        runs[mode] = (rad, conv)
    H.assert_same_state(runs["chunked"][0], runs["per"][0], "rad")
    H.assert_same_state(runs["chunked"][1], runs["per"][1], "conv")
    H.assert_same_state(runs["per"][0], out.rad, "rad against the run")
    H.assert_same_state(runs["per"][1], out.conv, "conv against the run")


def test_adjustment_overflow_redoes_the_chunk():
    """With one adjustment round per iteration (the entry's too), chunks
    whose adjustments need more are redone from their snapshot with
    unbounded rounds: the run is bit for bit the per-iteration run, and
    the redos are counted."""
    want = _reference("converging")
    with graphs.loops(graphs.Settings(chunk=16, rounds=1,
                                      entry_rounds=1)) as lp:
        got = _run(CASES["converging"])
    _assert_same_run(got, want)
    conv = lp.stats["convection"]
    assert conv.redos > 0
    assert conv.rounds[-1] > 0          # more than one round, first tries


def test_chunked_run_matches_jax_pipeline(tmp_path, monkeypatch):
    """The chunked run of the small scenario (65 bins, the start profile of
    tests/test_torch_rce.py) against the JAX package with its native fp64
    Planck lookup: equal convection counts, final T at rtol 1e-10
    (ROADMAP C: the radiation count is chaotic)."""
    tp = tmp_path / "start_tp.dat"
    H.write_tp_file(tp, H.start_profile(12))
    cfg = dict(H.SMALL_RUN, force_start_tp_from_file="yes",
               temp_format="helios", temp_path=str(tp))
    table = H.small_table()
    with graphs.loops() as lp:
        got = pipeline.run(HeliosConfig(**cfg), table, write_output=False,
                           device="cpu")
    assert lp.stats["convection"].iterations == got.conv.steps
    H.native_build(monkeypatch)
    native = jax_pipeline.run(JaxConfig(**cfg), table=table,
                              write_output=False)
    assert not got.conv.keep_running and not bool(native.conv.keep_running)
    assert got.conv.it == int(native.conv.it)
    np.testing.assert_allclose(got.T_lay.numpy(),
                               np.asarray(native.conv.T_lay), rtol=1e-10)


# functions that read a tensor's values to the host (on the card: a sync,
# which a capture refuses, or a value baked into the graph)
HOST_READS = frozenset((
    "item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
    "__index__", "__array__", "nonzero", "argwhere", "masked_select",
    "unique", "unique_consecutive"))


def _signature(x):
    """What a replay fixes of an argument: a host value itself (a tensor's
    shape cannot change between iterations without a read of the
    device, which _reads_device catches)."""
    kind = type(x)
    if isinstance(x, torch.Tensor):
        return TENSOR
    if kind is list or kind is tuple:
        return tuple(map(_signature, x))
    if kind is dict:
        return tuple((k, _signature(v)) for k, v in x.items())
    if x is None or kind in PLAIN:
        return x
    return kind.__name__


TENSOR = "tensor"
PLAIN = (bool, int, float, str, torch.dtype, torch.device)


def _reads_device(name, args):
    """Whether a call reads the device: a host read, a tensor made from
    host data, or an index by a 0-d or boolean tensor (the index's value,
    or the result's shape, comes from the device)."""
    if name in HOST_READS:
        return True
    if name in ("tensor", "as_tensor"):
        return not isinstance(args[0], torch.Tensor)
    if name in ("__getitem__", "__setitem__"):
        index = args[1] if isinstance(args[1], tuple) else (args[1],)
        return any(isinstance(i, torch.Tensor)
                   and (i.dim() == 0 or i.dtype == torch.bool)
                   for i in index)
    return False


class OpRecorder(TorchFunctionMode):
    """Every torch call made inside it, with its arguments' signatures,
    and the calls that read the device."""

    def __init__(self):
        super().__init__()
        self.ops, self.reads = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", None) or repr(func)
        if _reads_device(name, args):
            self.reads.append(name)
        self.ops.append((name, _signature(args), _signature(kwargs)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("case", list(CASES) + ["batch"])
def test_iterations_of_one_key_run_the_same_ops(case, monkeypatch):
    """Every eager iteration that a graph would hold (the adjustment at
    the graph's rounds; not a redo's unbounded one), recorded op by op
    with its host numbers: the iterations of one key (``rad_key``,
    ``conv_key``) run the same ops, so a replay of the key's graph runs
    what the iteration would, and none reads the device; for one planet
    of each case, and for a batch of three whose members stop at
    different iterations (tests/test_torch_device_loop_batch.py)."""
    traces = {}
    eager = graphs.Runner._eager

    def recording(self, it, rounds):
        if not self.graphable or rounds != self.graph_rounds(it):
            return eager(self, it, rounds)
        rec = OpRecorder()
        with rec:
            made = eager(self, it, rounds)
        traces.setdefault((self.done_count, self.key(it)), []).append(
            (it, rec.ops, rec.reads))
        return made

    monkeypatch.setattr(graphs.Runner, "_eager", recording)
    if case == "batch":
        outs, _ = run_batch(graphs.Settings(chunk=16))
        assert_same_members(outs, batch_reference())
        ran = (max(o.rad.it for o in outs)
               + max(o.conv.steps for o in outs))
    else:
        with graphs.loops(graphs.Settings(chunk=16)):
            out = _run(CASES[case])
        _assert_same_run(out, _reference(case))
        ran = out.rad.it + out.conv.steps
    runs = sum(len(v) for v in traces.values())
    assert runs >= ran
    repeated = [k for k, v in traces.items() if len(v) > 1]
    assert len(repeated) >= 5, sorted(traces)
    for key, seen in traces.items():
        it0, ops0, _ = seen[0]
        assert ops0
        for it, ops, reads in seen:
            assert not reads, (key, it, reads)
            assert ops == ops0, (
                f"{key}: iteration {it} runs other ops than {it0}: first "
                f"difference at op "
                f"{next(i for i, (a, b) in enumerate(zip(ops, ops0)) if a != b) if len(ops) == len(ops0) else 'count'}")
