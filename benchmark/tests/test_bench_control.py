"""The control, the program's own float32 path at each planet's reported
state, comes out not correct by the configuration's limits; the same
report in float64 comes out correct (the control's gap is its
precision's).  On the card at the cells' size: ``python3
benchmark/control.py --workload <cell>``."""

import pytest
import torch

from benchmark.tests.conftest import tiny


@pytest.mark.parametrize("name", ["flagship.single", "flagship_matrix.single"])
def test_float32_control_is_not_correct(name):
    from benchmark import control
    torch.set_num_threads(2)
    c = tiny(name)
    res = control.readings(c, "cpu")
    limits = c.config["limits"]
    fails = lambda r: any(not r[k] <= v for k, v in limits.items())
    assert res["control"] and all(fails(r) for r in res["control"])
    assert not any(fails(r) for r in res["sound"] + res["forward64"])
    for s, x in zip(res["sound"], res["control"]):
        assert x["flux_gap"] > 1e3 * s["flux_gap"]
