"""The chunk of an ensemble run of the PyTorch port against the JAX
package's ensemble rule (helios_tpu/parallel/ensemble.py:349-357).

Both ``run_ensemble`` functions are stopped where they hand the chunk to
their loops: the JAX package's at ``_batched_runners(..., chunk)``, the
port's at ``run_radiation_chunked(..., chunk_iters=chunk)``.  The chunk
is ``chunk_iters`` capped at ``checkpoint_every``, on the 10-iteration
refresh cadence, with realtime plotting on or off: an ensemble draws no
plots, so the plot interval never caps it (as it does a single monitored
run, helios_tpu_torch.pipeline.monitored_chunk).
"""

import dataclasses

import pytest

from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.parallel import ensemble as jens
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.parallel import ensemble as tens

import torch_port_helpers as H

RUN = dict(H.SMALL_RUN, nlayer=6)


class Stop(Exception):
    """Raised where a run_ensemble hands its chunk to the loops."""


def jax_chunk(monkeypatch, kw):
    seen = []

    def runners(phys, thermo, sset, mesh, chunk):
        seen.append(chunk)
        raise Stop

    monkeypatch.setattr(jens, "_batched_runners", runners)
    cfgs = [JaxConfig(**kw, name=f"m{k}", surf_albedo=a).finalize()
            for k, a in enumerate((0.0, 0.5))]
    with pytest.raises(Stop):
        jens.run_ensemble(cfgs, tables=[H.small_table(nbin=8)] * 2,
                          write_output=False)
    return seen[0]


def torch_chunk(monkeypatch, kw):
    seen = []

    def rad_loop(phys, m, thermo, T0, *, chunk_iters, **rest):
        seen.append(chunk_iters)
        raise Stop

    monkeypatch.setattr(tens, "run_radiation_chunked", rad_loop)
    cfgs = [TorchConfig(**kw, name=f"m{k}", surf_albedo=a).finalize()
            for k, a in enumerate((0.0, 0.5))]
    with pytest.raises(Stop):
        tens.run_ensemble(cfgs, tables=[H.small_table(nbin=8)] * 2,
                          write_output=False, device="cpu")
    return seen[0]


# (progress, checkpoint_every, chunk_iters)
MONITORING = [("no", 0, 100), ("yes", 0, 100), ("no", 50, 100),
              ("yes", 250, 100), ("yes", 35, 100), ("yes", 0, 7),
              ("no", 30, 45)]


@pytest.mark.parametrize("realtime_plot", ["no", "yes", "30"])
@pytest.mark.parametrize("progress,checkpoint_every,chunk_iters", MONITORING)
def test_ensemble_chunk_is_jax_rule(monkeypatch, tmp_path, realtime_plot,
                                    progress, checkpoint_every, chunk_iters):
    kw = dict(RUN, realtime_plot=realtime_plot, progress=progress,
              checkpoint_every=checkpoint_every, chunk_iters=chunk_iters,
              output_dir=str(tmp_path))
    want = jax_chunk(monkeypatch, kw)
    got = torch_chunk(monkeypatch, kw)
    assert got == want
    cfg = TorchConfig(**kw).finalize()
    phys = tens.pl.prepare_model(cfg, H.small_table(nbin=8),
                                 device="cpu")[0]
    assert tens.ensemble_chunk(cfg, phys) == want


def test_plot_interval_caps_only_a_single_run():
    """With realtime plotting every 10 iterations and progress lines, a
    single monitored run takes chunks of 10, the ensemble chunk_iters."""
    cfg = TorchConfig(**RUN, realtime_plot="yes", progress="yes",
                      chunk_iters=100).finalize()
    phys = torch_pipeline.prepare_model(cfg, H.small_table(nbin=8),
                                        device="cpu")[0]
    assert cfg.n_plot == 10
    assert torch_pipeline.monitored_chunk(cfg, 0) == 10
    assert tens.ensemble_chunk(cfg, phys) == 100
    single = dataclasses.replace(cfg, progress=0)
    assert tens.ensemble_chunk(single, phys) is None
