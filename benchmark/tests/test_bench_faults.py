"""A run with the timed path broken underneath comes out not correct: a
temperature step that returns its state unchanged, half of a batch left
out (its members given the others' results), and an answer altered where
it is produced.  One chip has no exchange between chips to leave out."""

import dataclasses

import numpy as np

from benchmark.tests.conftest import run_tiny, tiny


def test_step_returning_its_state(monkeypatch):
    import torch
    from helios_tpu_torch.rce import loop, radiative

    def rad_unchanged(phys, m, totals, T_lay, T_store, prefactor, it,
                      local_limit, **kw):
        L = phys.nlayer
        return radiative.RadTempResult(
            T_lay=T_lay, T_store=T_store, prefactor=prefactor,
            F_smooth_sum=torch.zeros_like(T_lay[:L]),
            abort=torch.zeros(T_lay.shape, dtype=torch.bool,
                              device=T_lay.device))

    def conv_unchanged(phys, m, totals, T_lay, T_store, prefactor,
                       marked_red, it, **kw):
        return T_lay, T_store, prefactor, torch.zeros_like(
            T_lay[:phys.nlayer])

    monkeypatch.setattr(radiative, "rad_temp_step", rad_unchanged)
    monkeypatch.setattr(loop, "conv_temp_step", conv_unchanged)
    out = run_tiny(tiny("flagship.single", max_nr_iterations=40))
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_half_of_the_batch_left_out(monkeypatch):
    from helios_tpu_torch.parallel import ensemble
    solve = ensemble.run_ensemble

    def half(cfgs, **kw):
        kw["tables"] = kw["tables"][:len(cfgs) // 2]
        outs = solve(cfgs[:len(cfgs) // 2], **kw)
        return outs + outs[:len(cfgs) - len(outs)]

    monkeypatch.setattr(ensemble, "run_ensemble", half)
    out = run_tiny(tiny("flagship.grid8"))
    assert not out["correct"]
    assert out["checks"]["flux_gap"]["value"] > 1e-6


def test_answer_altered_where_produced(monkeypatch):
    from helios_tpu_torch import pipeline
    solve = pipeline.run

    def altered(*a, **kw):
        o = solve(*a, **kw)
        r = dataclasses.replace(o.result, T_lay=o.result.T_lay
                                * (1.0 + 1e-6))
        return dataclasses.replace(o, result=r)

    monkeypatch.setattr(pipeline, "run", altered)
    out = run_tiny(tiny("flagship.single"))
    assert not out["correct"]
    assert not out["checks"]["rad_residual"]["value"] <= (
        out["checks"]["rad_residual"]["limit"]) or (
        out["checks"]["flux_gap"]["value"] > 1e-7)
    assert np.isfinite(out["checks"]["flux_gap"]["value"])
