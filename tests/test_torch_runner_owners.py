"""The runners that no loop keeps (helios_tpu_torch.rce.graphs): a sliced
model's runner is made for each loop call, holds its state in static
buffers on the slices' devices, and goes when the call returns.

A model on 2 spectral slices (12 layers, 8 bins) runs in monitored chunks
of 10 iterations, every chunk a loop call with a runner of its own, and
is bit for bit its straight sliced run (one call per loop): both loops'
final states, the final temperatures and the flux totals, with convection
off and on.  No runner is kept.
"""

import numpy as np
import pytest
import torch

from helios_tpu_torch import pipeline
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.rce import graphs

# the small optically thick scenario; it converges in 776 radiation
# iterations, and with convection in 464 more
RUN = dict(name="owners", planet="manual", g=2288.0, a=0.0153,
           R_planet=1.0, R_star=30.0, T_star=30.0, T_intern=700.0,
           scattering="yes", direct_beam="no", kappa_value=0.1,
           run_type="iterative", nlayer=12, p_boa=1e9, p_toa=1e3,
           adapt_interval=6, chunk_iters=10, n_spectral_shards=2)


def table():
    t = synthetic_premixed_table(nbin=8, ny=4, ntemp=8, npress=6, seed=1)
    t.kpoints *= 10.0
    return t


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


@pytest.mark.parametrize("convection", ["no", "yes"])
def test_sliced_chunks_are_the_straight_sliced_run(convection):
    torch.set_num_threads(2)
    graphs.clear_kept()
    cfg = HeliosConfig(**RUN, convection=convection).finalize()
    phases = []
    chunked = pipeline.run(cfg, table(), write_output=False, device="cpu",
                           callbacks=[lambda info: phases.append(info.phase)])
    straight = pipeline.run(cfg, table(), write_output=False, device="cpu")
    assert not graphs._KEPT
    assert phases.count("radiation") > 1
    assert (phases.count("convection") > 1) == (convection == "yes")
    assert_same_state(chunked.rad, straight.rad, "rad")
    assert_same_state(chunked.conv, straight.conv, "conv")
    assert torch.equal(chunked.T_lay, straight.T_lay)
    assert_same_state(chunked.totals, straight.totals, "totals")
