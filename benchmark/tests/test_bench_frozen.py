"""The frozen copies hold: each kernel's bytes at the flagship shapes as
PERF.md's kernel table gives them, the table generator bit for bit the
program's, and the profiler arithmetic."""

import numpy as np
import pytest

from benchmark.frozen import costs, trace
from benchmark.frozen.table import synthetic_premixed_table

L, S, P = 105, 385 * 20, 8


def test_kernel_bytes_at_the_flagship_shapes():
    mb = lambda c: round(c["bytes"] / 1e6, 1)
    assert mb(costs.noniso_sweep(L, S, 4)) == 91.0
    assert mb(costs.noniso_sweep(L, P * S, 4)) == 727.9
    assert mb(costs.thomas_solve(4 * (L + 1) - 2, S)) == 104.0
    assert mb(costs.thomas_solve(2 * (L + 1), S)) == 52.2
    assert mb(costs.band_integrate(L + 1, S, 385, 20, 385)) == 20.6
    assert mb(costs.ro_mix(L * 385, 20, 0)) == 19.4
    # the bounds of PERF.md's kernel table, ms
    ms = lambda c: round(c["bound_s"] * 1e3, 4)
    assert ms(costs.noniso_sweep(L, S, 4)) == 0.0272
    assert ms(costs.noniso_sweep(L, P * S, 4)) == 0.2173
    assert ms(costs.thomas_solve(4 * (L + 1) - 2, S)) == 0.0310
    assert costs.noniso_sweep(L, S, 4)["by"] == "bytes"
    assert round(costs.iso_sweep(L, S, 1001)["bound_s"] * 1e3, 3) == 0.190
    assert costs.iso_sweep(L, S, 1001)["by"] == "operations"


@pytest.mark.parametrize("kw", [dict(nbin=16, ny=4, ntemp=6, npress=5),
                                dict(nbin=33, ny=5, seed=3)])
def test_table_generator_is_the_programs(kw):
    from helios_tpu_torch.io.opacity import synthetic_premixed_table as port
    got, want = synthetic_premixed_table(**kw), port(**kw)
    for field, value in got.items():
        w = getattr(want, field)
        assert value.dtype == w.dtype and np.array_equal(value, w), field


def test_union_gaps_and_labels():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert trace.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.busy(iv) == 3.0
    gaps = trace.gaps(iv, 0.0, 5.0)
    assert gaps == [(2.0, 3.0), (4.0, 5.0)]
    host = [(1.5, 3.5, "outer"), (2.2, 2.8, "inner"), (0.0, 10.0, "top")]
    assert trace.label_gaps(gaps, host) == {"inner": 1.0, "top": 1.0}
    assert trace.label_gaps([(6.0, 7.0)], [(0.0, 1.0, "a")]) == {
        "host (no span)": 1.0}
