"""Every per-layer reader on a record of the kind the traced run makes: a
number in the cells the manifest lists it for, nothing to read elsewhere,
and no share above 100%."""

import pytest

from benchmark import run
from benchmark.core import cell as cell_mod
from benchmark.core.drive import Call

STATS = dict(graphs=3, replays=40, eager=16, reads=50, redos=0,
             iterations=700, past_stop=10, capture_s=0.8, eager_s=1.0,
             replay_s=0.03, read_s=1.1, adjust_reads=30, adjust_read_s=0.1,
             rounds=None, idle_launches={})
PROFILE = dict(window_s=4.0, busy_s=1.2, device_s=1.3,
               kernels=dict(noniso_sweep=(0.12, 700), thomas_solve=(0.07,
                                                                    680)),
               missing=[], attempts=1, events=10, reduce_s=1.0)


def record(name):
    c = cell_mod.load(name)
    calls = [Call(members=list(range(c.traffic["batch"])), wall_s=3.0,
                  run_wall_s=2.9, rad_s=1.0, conv_s=1.8, flux_solves=719,
                  stats=dict(radiation=STATS, convection=STATS))]
    prof = PROFILE
    if c.traffic["batch"] > 1:      # 8 planets: the sweep takes 8 x longer
        prof = dict(PROFILE, kernels=dict(noniso_sweep=(0.88, 719)))
    return c, run.record(c.config, c.traffic, calls, prof)


def test_stats_hold_every_field_of_the_programs_stats():
    from helios_tpu_torch.rce import graphs
    assert set(STATS) == set(graphs.Stats().as_dict())


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cell_mod.manifest()["workloads"]])
def test_readers_in_their_cells(name):
    c, rec = record(name)
    assert rec["config"] is c.config
    listed = {m["name"] for m in c.per_layer}
    for metric in cell_mod.manifest()["per_layer"]:
        v = cell_mod.reader(metric["name"])(rec)
        if metric["name"] in listed:
            assert v is not None and v > 0, metric["name"]
            if metric["unit"] == "%":
                assert v <= 100.0, metric["name"]
        elif metric["name"].split(".")[0] != "noniso_sweep_roofline":
            assert v is None, (metric["name"], name)


def test_roofline_is_bound_over_time_per_call():
    _, rec = record("flagship.single")
    v = cell_mod.reader("noniso_sweep_roofline.run")(rec)
    assert v == pytest.approx(100 * 0.0272e-3 / (0.12 / 700), rel=2e-3)
    _, rec = record("flagship_matrix.single")
    assert cell_mod.reader("noniso_sweep_roofline.run")(rec) is None
    v = cell_mod.reader("thomas_roofline.run")(rec)
    assert v == pytest.approx(100 * 0.0310e-3 / (0.07 / 680), rel=2e-3)
