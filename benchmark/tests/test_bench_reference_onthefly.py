"""The plain on-the-fly reference (``benchmark/reference/rce_onthefly.py``)
against the program on the CPU at small sizes: its Random Overlap against
the program's plain version, its forward model against the program's
``forward_fluxes`` with a species set at the same temperatures, and a
tiny on-the-fly planet solved through ``drive.Program.solve`` and judged
correct."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import rce_onthefly as ref
from benchmark.tests.conftest import tiny

# five species: a FastChem absorber, a constant, a CIA pair (FastChem
# pairs), H2O (FastChem, absorbing and scattering by its own formula) and
# a scatterer
FIVE = [["H2O", "yes", "yes", "FastChem"], ["CO", "yes", "no", "FastChem"],
        ["Na", "yes", "no", "3.5e-06"], ["CIA_H2H2", "yes", "no", "FastChem"],
        ["H2", "no", "yes", "FastChem"]]


def _gauss(ny):
    x, w = np.polynomial.legendre.leggauss(ny)
    return torch.tensor(w), torch.tensor(0.5 * (x + 1.0))


def _k(rng, C, ny, scale):
    """[C, ny] k-distributions, ascending, spread over up to 1e4 along y,
    their levels drawn over eight decades (some pairs overlap
    negligibly)."""
    base = scale * 10.0 ** rng.uniform(-4.0, 4.0, (C, 1))
    return torch.tensor(base * np.sort(10.0 ** rng.uniform(-2.0, 2.0,
                                                           (C, ny)), axis=1))


@pytest.mark.parametrize("ny", [4, 20])
def test_random_overlap_is_the_programs(ny):
    """The reference's walk against the program's closed form and its
    select of negligible cells (kernels.ro.ro_mix_reference, which
    ro_mix's kernel equals bit for bit).  Both add the running weights in
    index order on the CPU; the rebin divides by differences of
    neighbouring yg (~1e-4 at ny = 20), which may turn a last-bit
    difference of the interpolation into 1e-12 of the value: rtol
    1e-12."""
    from helios_tpu_torch.kernels.ro import ro_mix_reference
    from helios_tpu_torch.ops.mixing import (negligible_overlap,
                                             random_overlap_mix)
    rng = np.random.default_rng(ny)
    mixed, new = _k(rng, 3000, ny, 1.0), _k(rng, 3000, ny, 3.0)
    w, y = _gauss(ny)
    got = ref.random_overlap(mixed, new, w, y)
    plain = negligible_overlap(mixed, new)
    assert 0 < int(plain.sum()) < 3000       # both kinds of cell
    torch.testing.assert_close(got, ro_mix_reference(mixed, new, w, y),
                               rtol=1e-12, atol=0.0)
    torch.testing.assert_close(got[~plain],
                               random_overlap_mix(mixed, new, w, y)[~plain],
                               rtol=1e-12, atol=0.0)


def _five_species_cell():
    c = tiny("onthefly.rce")
    c.config["helios"]["nlayer"] = 8
    c.config["table"].update(nbin=12, ny=20)
    c.config["species"] = FIVE
    c.config["opacity_shares"] = dict(H2O=0.4, CO=0.3, Na=0.2, CIA_H2H2=0.1)
    return c


def test_forward_model_matches_the_program(tmp_path):
    """At a start profile (far from equilibrium) the reference's fluxes
    are the program's forward model's, its sweep carried to its fixed
    point.  rtol 1e-10 over each array's largest value: the two
    interpolate and sum in other orders (1e-16 of an opacity), and the
    Random Overlap's rebin amplifies a last-bit difference of a sorted
    sum by up to the inverse of a weight difference (~1e4 at ny = 20)."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.forward import (compute_cells, integrate_flux_flat,
                                          solve_fluxes, zero_fluxes)
    from helios_tpu_torch.ops import interp

    from benchmark.core import drive
    c = _five_species_cell()
    torch.set_num_threads(2)
    d = ref.deployment(c.config["helios"], {"surf_albedo": 0.3})
    p_lay, _ = ref.pressure_grid(d)
    T = drive.start_profile(p_lay, c.config["start_profile"])
    T = torch.tensor(np.append(T, T[0] * 1.02))
    prog = drive.Program(c.config, dict(c.traffic, members=[
        {"surf_albedo": 0.3}], batch=1), "cpu", str(tmp_path))
    want = ref.fluxes(d, prog.reference_table, T)
    sset = prog.program["sset"]
    assert [s.name for s in sset.specs] == [r[0] for r in FIVE]
    phys, arrays, _ = pipeline.prepare_model(prog.cfgs[0], prog.table,
                                             device="cpu")
    cache = compute_cells(phys, arrays, T, interp.interface_temperatures(T),
                          sset)
    flux = zero_fluxes(phys, arrays, T)
    for _ in range(200):
        flux = solve_fluxes(phys, arrays, cache, T, flux)
    got = integrate_flux_flat(phys, arrays, flux, cache.F_dir)
    for key in ("F_up_tot", "F_down_tot", "F_up_band"):
        g, w = getattr(got, key), want[key]
        assert float((g - w).abs().max() / w.abs().max()) < 1e-10, key
    # the mixing is on the path: correlated-k mixing is far from it
    ck = compute_cells(dataclasses.replace(phys, ro_method=0), arrays, T,
                       interp.interface_temperatures(T), sset)
    flux = zero_fluxes(phys, arrays, T)
    for _ in range(200):
        flux = solve_fluxes(phys, arrays, ck, T, flux)
    off = integrate_flux_flat(phys, arrays, flux, ck.F_dir)
    w = want["F_up_band"]
    assert float((off.F_up_band - w).abs().max() / w.abs().max()) > 1e-4


def test_tiny_planet_is_judged_correct(tmp_path):
    """A tiny on-the-fly planet of the configuration's 13 absorbers (12
    layers, 16 bins x 4), solved through ``drive.Program.solve`` to
    equilibrium and judged by the reference under the configuration's
    limits.  A hotter interior (T_intern 2000 K) and a larger opacity
    total (0.03) than the cell's give it a convective zone, as the cell's
    planets have: a planet that ends in the radiation loop reads its
    residual one temperature step after the loop's last check, 4-7e-8 at
    this size, over the limit."""
    from benchmark.core import drive, judge
    torch.set_num_threads(2)
    c = tiny("onthefly.rce", members=1, T_intern=2000.0)
    c.config["opacity_share_total"] = 0.03
    prog = drive.Program(c.config, c.traffic, "cpu", str(tmp_path))
    reports = prog.solve([0]).reports
    checks = judge.judge(c.config, c.traffic, prog.reference_table, reports,
                         "cpu")
    assert judge.correct(checks), checks
    assert checks["adiabat_gap"]["value"] > 0.0      # a convective zone
    assert checks["flux_gap"]["value"] < 1e-9
