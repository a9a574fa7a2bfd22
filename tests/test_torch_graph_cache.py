"""The loops' runners kept across ``graphs.loops`` blocks
(helios_tpu_torch.rce.graphs): a later solve whose owners (phys, model,
thermo, species set) and state have the same structure, Python scalars and
tensor shapes takes the kept runner over, copies its model into the
runner's own tensors and, on the card, replays the graphs already
captured.

On the CPU the kept runner's body reads its copies too, so a tensor left
out of the copy would give a stale result here: the small scenario at 8
bins with a physical timestep (40 radiation iterations, one adjustment and
solve), planet A, then B with another surface albedo (a model tensor) in a
new block is bit for bit B solved with nothing kept, and C with another
T_intern (a ``Phys`` field) misses and is right.  A batch of 2 takes the
kept runners of an earlier batch of 2 over, a batch of 3 does not;
``loops(PER_ITERATION)`` and a sliced model leave them alone; a model
tensor written in place between two loops is copied again; each block's
Stats count its own work.  The convection loop looks its runner up twice a
solve (the entry check runs it with no step, then the loop).

On the card (skipped without one): A, B, A and a batch's three calls in
three blocks each, the later blocks capture no graph, and every result is
bit for bit its ``graphs.loops(PER_ITERATION)`` twin.
"""

import numpy as np
import pytest
import torch

from helios_tpu_torch import pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.device import torch_dtype
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.parallel import ensemble
from helios_tpu_torch.rce import graphs
from helios_tpu_torch.rce.radiative import radiation_loop

# the small scenario (12 layers, optically thick, convective) at 8 bins;
# the physical timestep stops the radiation loop after 40 iterations and
# runs one adjustment and solve
RUN = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0, R_star=30.0,
           T_star=30.0, T_intern=700.0, scattering="yes", direct_beam="no",
           convection="yes", kappa_value=0.1, run_type="iterative",
           nlayer=12, p_boa=1e9, p_toa=1e3, adapt_interval=6,
           physical_tstep=1e4, runtime_limit=4e5)
# what a block's loops did, apart from host seconds and the lookups
WORK = ("graphs", "replays", "eager", "reads", "redos", "iterations",
        "past_stop", "adjust_reads", "rounds", "idle_launches", "mixes",
        "mix_launches")


def table():
    t = synthetic_premixed_table(nbin=8, ny=4, ntemp=8, npress=6, seed=1)
    t.kpoints *= 10.0
    return t


def config(k=0, **kw):
    return HeliosConfig(**dict(RUN, name=f"p{k}", **kw)).finalize()


@pytest.fixture(autouse=True)
def nothing_kept():
    graphs.clear_kept()
    yield
    graphs.clear_kept()


def solve(device="cpu", settings=None, **kw):
    """One pipeline.run in its own block: (output, the block's Stats)."""
    with graphs.loops(settings) as lp:
        out = pipeline.run(config(**kw), table(), write_output=False,
                           device=device)
    return out, lp.stats


def solve_batch(albedos, device="cpu", settings=None):
    """One run_ensemble of planets that differ in surface albedo, in its
    own block: (outputs, the block's Stats)."""
    cfgs = [config(k, surf_albedo=a) for k, a in enumerate(albedos)]
    with graphs.loops(settings) as lp:
        outs = ensemble.run_ensemble(cfgs, tables=[table()] * len(cfgs),
                                     write_output=False, device=device)
    return outs, lp.stats


def lookups(stats):
    return {k: (st.cache_hits, st.cache_misses) for k, st in stats.items()}


def work(stats):
    return {k: {f: getattr(st, f) for f in WORK} for k, st in stats.items()}


def assert_same_state(got, want, label):
    assert (got is None) == (want is None), label
    if want is None:
        return
    g, w = graphs._leaves(got), graphs._leaves(want)
    assert len(g) == len(w), label
    for k, (a, b) in enumerate(zip(g, w)):
        assert torch.equal(a, b), (label, graphs._leaf_names(want)[k])
    for f in graphs.host_fields(want):
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), (label, f)


def assert_same_runs(got, want):
    """Both loops' final states, the final T and the flux totals, bit for
    bit, planet by planet."""
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same_state(g.rad, w.rad, f"planet {k} rad")
        assert_same_state(g.conv, w.conv, f"planet {k} conv")
        assert torch.equal(g.T_lay, w.T_lay), k
        assert_same_state(g.totals, w.totals, f"planet {k} totals")


def test_a_later_solve_takes_the_kept_runners_over():
    """B after A, in a new block, is bit for bit B with nothing kept, and
    its block counts only hits and only its own work."""
    a, st_a = solve(surf_albedo=0.0)
    assert lookups(st_a) == {"radiation": (0, 1), "convection": (1, 1)}
    b, st_b = solve(surf_albedo=0.5)
    assert lookups(st_b) == {"radiation": (1, 0), "convection": (2, 0)}
    graphs.clear_kept()
    fresh, st_fresh = solve(surf_albedo=0.5)
    assert lookups(st_fresh) == lookups(st_a)
    assert not torch.equal(a.T_lay, b.T_lay)      # the albedo tells
    assert_same_runs(b, fresh)
    assert work(st_b) == work(st_fresh)
    assert st_b["radiation"].iterations == 40


def test_another_phys_misses_and_is_right():
    """C with another T_intern after B misses, and is C with nothing
    kept."""
    solve(surf_albedo=0.5)
    c, st_c = solve(surf_albedo=0.5, T_intern=600.0)
    assert lookups(st_c) == {"radiation": (0, 1), "convection": (1, 1)}
    graphs.clear_kept()
    fresh, _ = solve(surf_albedo=0.5, T_intern=600.0)
    assert_same_runs(c, fresh)


def test_a_batch_takes_over_a_batch_of_its_size():
    """A batch of 2 after a batch of 2 hits and is bit for bit the batch
    with nothing kept; a batch of 3 then misses."""
    solve_batch((0.0, 0.3))
    outs, st = solve_batch((0.1, 0.4))
    assert lookups(st) == {"radiation": (1, 0), "convection": (2, 0)}
    graphs.clear_kept()
    fresh, st_fresh = solve_batch((0.1, 0.4))
    assert_same_runs(outs, fresh)
    assert work(st) == work(st_fresh)
    _, st3 = solve_batch((0.0, 0.3, 0.6))
    assert lookups(st3) == {"radiation": (0, 1), "convection": (1, 1)}


@pytest.mark.parametrize("case", ["per iteration", "sliced"])
def test_per_iteration_and_sliced_runs_leave_the_kept_runners(case):
    """loops(PER_ITERATION) and a model on two spectral slices run
    runners of their block: they neither look up nor change the kept
    ones."""
    solve(surf_albedo=0.0)
    kept = dict(graphs._KEPT)
    assert set(kept) == {"radiation", "convection"}
    if case == "per iteration":
        _, st = solve(settings=graphs.PER_ITERATION, surf_albedo=0.5)
    else:
        _, st = solve(surf_albedo=0.5, n_spectral_shards=2)
    assert lookups(st) == {"radiation": (0, 0), "convection": (0, 0)}
    assert graphs._KEPT.keys() == kept.keys()
    assert all(graphs._KEPT[k] is kept[k] for k in kept)


def test_a_model_tensor_written_in_place_is_copied_again():
    """The same model object, its albedo written in place between two
    loops: the kept runner copies it again (its write counter moved)."""
    cfg = config(surf_albedo=0.0)
    phys, m, _ = pipeline.prepare_model(cfg, table(), device="cpu")
    thermo = pipeline.make_thermo(cfg, device="cpu")
    T0 = torch.as_tensor(pipeline.initial_temperatures(cfg, phys, m),
                         dtype=torch_dtype(cfg.dtype))
    first = radiation_loop(phys, m, thermo, T0)
    m.surf_albedo.fill_(0.5)
    with graphs.loops() as lp:
        again = radiation_loop(phys, m, thermo, T0)
    assert lookups(lp.stats) == {"radiation": (1, 0)}
    graphs.clear_kept()
    fresh = radiation_loop(phys, m, thermo, T0)
    assert not torch.equal(first.T_lay, again.T_lay)
    assert_same_state(again, fresh, "rad")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    return "cuda"


@pytest.mark.parametrize("kind", ["planet", "batch of 2"])
def test_on_the_card_later_blocks_replay_the_kept_graphs(cuda_device, kind):
    """A, B, A in three blocks: the first captures, the others capture no
    graph and replay, and each is bit for bit its per-iteration twin."""
    if kind == "planet":
        run = lambda albedo, settings=None: solve(
            cuda_device, settings, surf_albedo=albedo[0])
        calls = [(0.0,), (0.5,), (0.0,)]
    else:
        run = lambda albedos, settings=None: solve_batch(
            albedos, cuda_device, settings)
        calls = [(0.0, 0.3), (0.1, 0.4), (0.0, 0.3)]
    for k, albedo in enumerate(calls):
        out, st = run(albedo)
        assert st["radiation"].replays > 0, k
        if k == 0:
            assert st["radiation"].graphs > 0
        else:
            assert lookups(st) == {"radiation": (1, 0),
                                   "convection": (2, 0)}, k
            assert all(s.graphs == 0 for s in st.values()), k
        twin, _ = run(albedo, graphs.PER_ITERATION)
        assert_same_runs(out, twin)
