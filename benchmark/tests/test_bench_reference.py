"""The plain reference against the program on the CPU at a tiny size:
every cell's run is correct, with its numbers far inside their limits,
and the reference's forward model matches the program's at a state away
from equilibrium too."""

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import tiny


@pytest.mark.parametrize("name", ["flagship.single", "flagship_matrix.single",
                                  "flagship.grid8"])
def test_tiny_run_is_correct(tiny_runs, name):
    out = tiny_runs[name]
    checks = out["checks"]
    assert out["correct"] and out["failed"] == 0, checks
    assert out["attempted"] >= 2
    assert checks["flux_gap"]["value"] < 1e-9
    assert checks["adiabat_gap"]["value"] < 1e-12
    assert checks["rad_residual"]["value"] < 1e-8


@pytest.mark.parametrize("method", ["iteration", "matrix"])
def test_forward_model_matches_the_program(method):
    """At a start profile (far from equilibrium) the reference's fluxes are
    the program's forward model's, its sweep carried to its fixed point."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.forward import (compute_cells, integrate_flux_flat,
                                          solve_fluxes, zero_fluxes)
    from helios_tpu_torch.ops import interp

    from benchmark.core import drive
    from benchmark.core.cell import reference

    c = tiny("flagship.single", flux_calc_method=method)
    ref = reference(c.config)
    d = ref.deployment(c.config["helios"], {"surf_albedo": 0.3})
    p_lay, _ = ref.pressure_grid(d)
    T = drive.start_profile(p_lay, c.config["start_profile"])
    T = torch.tensor(np.append(T, T[0] * 1.02))
    table = drive.make_table(c.config["table"])
    want = ref.fluxes(d, table, T)

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        prog = drive.Program(c.config, dict(c.traffic, members=[
            {"surf_albedo": 0.3}], batch=1), "cpu", tmp)
        phys, arrays, _ = pipeline.prepare_model(prog.cfgs[0], prog.table,
                                                 device="cpu")
    cache = compute_cells(phys, arrays, T, interp.interface_temperatures(T))
    flux = zero_fluxes(phys, arrays, T)
    for _ in range(200):
        flux = solve_fluxes(phys, arrays, cache, T, flux)
    got = integrate_flux_flat(phys, arrays, flux, cache.F_dir)
    for key in ("F_up_tot", "F_down_tot", "F_up_band"):
        g, w = getattr(got, key), want[key]
        assert float((g - w).abs().max() / w.abs().max()) < 1e-12, key
