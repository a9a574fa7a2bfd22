"""The on-the-fly opacity mixing's span and counters on the CPU
(helios_tpu_torch.tracing.mixing, rce.graphs.Stats mix_s, mixes and
mix_launches): counts and structure only, no time compared with a
threshold.

A tiny non-isothermal ``pipeline.run`` (the small scenario of
tests/torch_port_helpers.py at 8 bins, a physical timestep: 40 radiation
iterations, then one convective adjustment and solve) mixes 13 absorbers
on the fly, each a scaled copy of the small table at a constant VMR, over
H2 and He.  Every cell refresh of a loop (``helios.refresh``) mixes twice,
the layers and the interfaces, each pass one ``helios.mix`` range inside
it, and each pass mixes the 12 absorbers after the first by one
``ro_mix`` call.  ``ro_mix.launches`` counts the card's kernel launches
only, so here the plain version's calls are counted as the launches they
are on the card (one each), which the loops' Stats take as ``mix_launches``.
The profiler changes no result, and a premixed run's Stats count no
mixing.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helios_tpu_torch import chem, pipeline, tracing
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.kernels import ro
from helios_tpu_torch.rce import graphs

import torch_port_helpers as H

SHORT = dict(physical_tstep=1e4, runtime_limit=4e5)
ABSORBERS = ("H2O", "CO", "CO2", "CH4", "C2H2", "NH3", "HCN", "Na", "K",
             "TiO", "VO", "CIA_H2H2", "CIA_H2He")
LOOPS = ("helios.radiation", "helios.convection")
MIX_FIELDS = ("mix_s", "mixes", "mix_launches")
RUNS = {}


def _counted_reference(*args):
    """ro_mix's plain version, counted as the one launch a call is on the
    card."""
    ro.ro_mix.launches += 1
    return REFERENCE(*args)


REFERENCE = ro.ro_mix_reference


def _species_set(table, nlayer):
    specs = [chem.SpeciesSpec(n, True, n == "H2O",
                              "0.85&0.15" if "CIA" in n else "1e-4")
             for n in ABSORBERS]
    specs += [chem.SpeciesSpec("H2", False, True, "0.85"),
              chem.SpeciesSpec("He", False, False, "0.15")]
    return chem.build_species_set(
        specs, ktemps=table.temperatures, kpress=table.pressures,
        nbin=len(table.wave_centers), ny=len(table.gauss_y), nlayer=nlayer,
        opacity_tables={n: table.kpoints * (50.0 + 10.0 * k)
                        for k, n in enumerate(ABSORBERS)},
        scat_tables={"H2": 8.14e-45 / table.wave_centers ** 4},
        device="cpu")


def _solve(mixing: str):
    table = H.small_table(8)
    cfg = HeliosConfig(**dict(H.SMALL_RUN, **SHORT,
                              opacity_mixing=mixing)).finalize()
    sset = (_species_set(table, cfg.nlayer) if mixing == "on-the-fly"
            else None)
    with graphs.loops() as lp, mock.patch.object(
            ro, "ro_mix_reference", _counted_reference):
        out = pipeline.run(cfg, table, sset=sset, write_output=False,
                           device="cpu")
    return out, lp.stats


def _run(mixing: str, traced: bool):
    """(output, Stats, helios.* ranges as (start, end, name)) of one run,
    made once per kind."""
    key = (mixing, traced)
    if key not in RUNS:
        torch.set_num_threads(2)
        if not traced:
            RUNS[key] = _solve(mixing) + ([],)
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out, stats = _solve(mixing)
            ranges = sorted(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.name().startswith("helios."))
            RUNS[key] = out, stats, ranges
    return RUNS[key]


def _in_loops(ranges, name):
    """The ranges named ``name`` inside either loop's range."""
    loops = [r for r in ranges if r[2] in LOOPS]
    return [r for r in ranges if r[2] == name and any(
        s <= r[0] and r[1] <= e for s, e, _ in loops)]


def test_two_passes_per_refresh_and_twelve_ro_calls_per_pass():
    """The loops' Stats count the passes of their iterations' refreshes,
    two each; a loop's entry state (its first cell cache, made before the
    runner) mixes outside any refresh and is counted by no Stats."""
    out, stats, ranges = _run("on-the-fly", True)
    refreshes = _in_loops(ranges, "helios.refresh")
    mixes = _in_loops(ranges, "helios.mix")
    inside = [m for m in mixes if any(s <= m[0] and m[1] <= e
                                      for s, e, _ in refreshes)]
    st = [stats[k] for k in ("radiation", "convection")]
    assert refreshes and out.conv is not None
    assert sum(s.mixes for s in st) == len(inside) == 2 * len(refreshes)
    assert 0 < len(mixes) - len(inside) <= 2
    for s in st:
        assert s.mixes > 0 and s.mix_s > 0.0
        assert s.mix_launches == 12 * s.mixes
        d = s.as_dict()
        assert (d["mixes"], d["mix_launches"]) == (s.mixes, s.mix_launches)


def test_results_are_the_same_with_and_without_a_profiler():
    a, st_a, _ = _run("on-the-fly", True)
    b, st_b, _ = _run("on-the-fly", False)
    for field in ("T_lay", "F_up_tot", "F_down_tot", "F_up_band"):
        assert np.array_equal(getattr(a.result, field),
                              getattr(b.result, field)), field
    for kind in ("radiation", "convection"):
        assert (st_a[kind].mixes, st_a[kind].mix_launches) == (
            st_b[kind].mixes, st_b[kind].mix_launches)


def test_a_premixed_run_counts_no_mixing():
    out, stats, ranges = _run("premixed", True)
    assert not [r for r in ranges if r[2] == "helios.mix"]
    for s in stats.values():
        assert (s.mix_s, s.mixes, s.mix_launches) == (0.0, 0, 0)
        assert {f: s.as_dict()[f] for f in MIX_FIELDS} == dict(
            mix_s=0.0, mixes=0, mix_launches=0)
    assert np.isfinite(np.asarray(out.result.T_lay)).all()


@pytest.mark.parametrize("field", MIX_FIELDS)
def test_mixing_fields_default_to_zero_and_are_in_the_dict(field):
    st = graphs.Stats()
    assert getattr(st, field) == 0
    assert st.as_dict()[field] == 0
    setattr(st, field, 1)
    assert st.as_dict()[field] == 1


def test_a_pass_outside_a_loop_is_only_a_span():
    """compute_cells outside the loops (the start and the result) mixes
    too: the span is there, no Stats take it."""
    assert tracing.running_stats() is None
    with graphs.loops() as lp:
        with tracing.mixing():
            pass
        assert lp.stats == {}


def test_the_running_loop_takes_the_passes_and_no_other():
    """tracing.running marks the loop whose Stats a pass counts into, and
    tracing.running_stats() reads it inside a loops() block."""
    a, b = graphs.Stats(), graphs.Stats()
    with graphs.loops():
        with tracing.running(a):
            assert tracing.running_stats() is a
            with tracing.mixing():
                pass
            with tracing.running(b):
                with tracing.mixing():
                    pass
            assert tracing.running_stats() is a
        assert tracing.running_stats() is None
    assert (a.mixes, b.mixes) == (1, 1)
    assert a.mix_s > 0.0 and a.mix_launches == 0
