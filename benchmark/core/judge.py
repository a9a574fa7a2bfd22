"""Whether what the timed path produced is correct: every planet the
window solved, judged by the configuration's plain reference against the
limits in the configuration file."""

from __future__ import annotations

from typing import List

import torch

from benchmark.core.cell import reference


def judge(cfg: dict, traffic: dict, table: dict, reports: List[dict],
          device) -> dict:
    """{number: {"value", "limit"}}: the worst reading of each of the
    reference's numbers over the reports, and ``failed``, the planets
    that did not converge or ended non-finite (limit 0).  The reference
    runs in float64 with TF32 off.  ``table`` is what the reference reads
    as its table: the premixed table's fields, and beside them the
    ``reference`` arrays of a configuration's inputs
    (``drive.Program.reference_table``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference(cfg)
    limits = cfg["limits"]
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    grids = {}
    for rep in reports:
        d = ref.deployment(cfg["helios"], traffic["members"][rep["member"]])
        if not (rep["converged"] and rep["finite"]):
            failed += 1
        key = (d["T_star"], d["energy_correction"])
        if key not in grids:
            grids[key] = ref.planck_table(d, table, device)
        got = ref.check_planet(d, table, rep, device, grids[key])
        for name in limits:
            if not got[name] <= worst[name]:    # NaN is the worst there is
                worst[name] = got[name]
    checks = {name: dict(value=worst[name], limit=limits[name])
              for name in limits}
    checks["failed"] = dict(value=failed, limit=0)
    return checks


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
