"""The configuration ``onthefly``'s inputs (``benchmark/inputs/onthefly.py``)
keep ``benchmark/inputs``' contract at a small size: 13 absorbers and two
further scatterers in the species file's order, the program's species set
in the run's precision, the reference's arrays in float64; the frozen
chemistry is the program's bit for bit, and the program's VMR table, made
from it through its FastChem path, equals the tabulated chemistry at the
opacity grid's nodes."""

import numpy as np
import pytest

from benchmark.frozen import chemistry
from benchmark.inputs import onthefly
from benchmark.tests.conftest import tiny

ABSORBERS = ["H2O", "CO", "CO2", "CH4", "C2H2", "NH3", "HCN", "Na", "K",
             "TiO", "VO", "CIA_H2H2", "CIA_H2He"]


def made(precision="double", **table):
    """(cell, table fields, make's result) at the tests' size."""
    from benchmark.core.drive import make_table
    c = tiny("onthefly.rce")
    c.config["table"].update(table)
    cfg = dict(c.config, helios=dict(c.config["helios"],
                                     precision=precision))
    fields = make_table(cfg["table"])
    return c, fields, onthefly.make(cfg, fields, None, "cpu")


@pytest.mark.parametrize("grid", [
    (np.linspace(50.0, 6000.0, 60), np.logspace(0.0, 10.0, 31)),
    (np.array([300.0, 800.0, 1450.0, 2999.0, 5000.0]),
     np.array([1.0, 1e3, 1e6, 1e9])),
])
def test_frozen_chemistry_is_the_programs(grid):
    from helios_tpu_torch import chem_analytic
    temps, press = grid
    args = (np.clip(temps, 500.0, 3000.0), press / 1e6)
    got, want = chemistry.as_fastchem_table(*args), (
        chem_analytic.as_fastchem_table(*args))
    assert sorted(got[0]) == sorted(want[0])
    for col, values in got[0].items():
        assert values.dtype == want[0][col].dtype
        assert np.array_equal(values, want[0][col]), col
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


def test_weights_are_the_programs_database():
    from helios_tpu_torch import species
    for name, weight in onthefly.WEIGHT.items():
        assert species.SPECIES[name].weight == weight, name


@pytest.mark.parametrize("precision, dtype", [("double", np.float64),
                                              ("single", np.float32)])
def test_contract_shapes_and_dtypes(precision, dtype):
    import torch
    c, fields, out = made(precision)
    assert set(out) == {"program", "reference"}
    sset = out["program"]["sset"]
    nt, npr, B, ny = fields["kpoints"].shape
    names = [s.name for s in sset.specs]
    assert names == ABSORBERS + ["H2", "He"]
    assert [s.name for s in sset.specs if s.absorbing] == ABSORBERS
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    for spec, dat in zip(sset.specs, sset.data):
        assert dat.opacity_pretab.dtype == tdt
        assert dat.opacity_pretab.device.type == "cpu"
        if spec.absorbing:
            assert tuple(dat.opacity_pretab.shape) == (nt, npr, B, ny)
        if spec.source_for_vmr == "FastChem":
            assert tuple(dat.vmr_pretab.shape) == (nt, npr)
    ref = out["reference"]
    assert [r[0] for r in ref["species"]] == names
    assert sorted(ref["species_kpoints"]) == sorted(ABSORBERS)
    for name, k in ref["species_kpoints"].items():
        assert k.dtype == np.float64 and k.shape == (nt, npr, B, ny)
        assert np.isfinite(k).all() and (k > 0).all()
    assert sorted(ref["species_rayleigh"]) == ["H2", "He"]
    for name, v in ref["species_vmr"].items():
        assert np.ndim(v) == 0 or (v.shape == (nt, npr)
                                   and v.dtype == np.float64), name


def test_program_vmr_table_is_the_chemistry_at_the_nodes():
    c, fields, out = made()
    sset, ref = out["program"]["sset"], out["reference"]
    for spec, dat in zip(sset.specs, sset.data):
        want = ref["species_vmr"][spec.name]
        if spec.source_for_vmr == "FastChem":
            assert np.array_equal(dat.vmr_pretab.numpy(), want), spec.name
        else:
            assert np.all(dat.vmr_profile_lay.numpy() == want), spec.name


def test_each_absorber_gives_its_share_at_its_largest_vmr():
    """The scale rule: at its largest VMR along the start profile, an
    absorber's k-table times vmr m / mu has the premixed table's
    geometric mean times its share."""
    c, fields, out = made()
    cfg = c.config
    rows = onthefly.species_rows(cfg)
    largest, mu = onthefly.start_profile_vmr(cfg, rows)
    log_pre = np.log(fields["kpoints"]).mean()
    total = cfg["opacity_share_total"]
    for name, k in out["reference"]["species_kpoints"].items():
        contrib = largest[name] * onthefly.WEIGHT[name] / mu
        got = np.log(k).mean() + np.log(contrib) - log_pre
        want = np.log(total * cfg["opacity_shares"][name])
        assert got == pytest.approx(want, abs=1e-10), name
    assert sum(cfg["opacity_shares"].values()) == pytest.approx(1.0)
