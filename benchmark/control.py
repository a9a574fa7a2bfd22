"""The lower and upper readings of a cell's correctness numbers.

    python3 benchmark/control.py --workload <cell> [--device cuda]

Solves every planet of the cell's mix once through the timed path, in the
mix's calls, and judges each as a run does (the lower readings).  Then the
control: at each planet's reported state, the program's own
``precision="single"`` path computes the fluxes it would report there (the
forward model in float32 at the temperatures rounded to float32, its flux
solve repeated from the last one until it no longer changes, as the loops
carry it), and the reference judges that report (the upper readings).
The same repeated solve in float64 is printed beside it: it reads as the
timed path does, so the control's gap is its precision's.  The benchmark's
runs do not run this; ``benchmark/tests/test_control.py`` runs it small on
the CPU."""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SOLVES = 100        # repeated flux solves of the control's report


def forward_report(prog, rep, device):
    """What the program ``prog`` would report for planet ``rep`` at its
    state in ``prog``'s precision: its final temperatures in that
    precision, the layers it reported convective, and the fluxes of the
    program's forward model there."""
    import torch

    from helios_tpu_torch import pipeline
    from helios_tpu_torch.forward import (compute_cells, integrate_flux_flat,
                                          solve_fluxes, zero_fluxes)
    from helios_tpu_torch.ops import interp as interp_ops

    phys, arrays, _ = pipeline.prepare_model(prog.cfgs[rep["member"]],
                                             prog.table, device=device)
    dt = arrays.p_lay.dtype
    T = torch.as_tensor(rep["T_lay"], device=device).to(dt)
    cache = compute_cells(phys, arrays, T,
                          interp_ops.interface_temperatures(T),
                          prog.program.get("sset"))
    flux = zero_fluxes(phys, arrays, T)
    for _ in range(SOLVES):
        flux = solve_fluxes(phys, arrays, cache, T, flux)
    tot = integrate_flux_flat(phys, arrays, flux, cache.F_dir)
    h = lambda x: x.detach().double().cpu().numpy()
    L = phys.nlayer
    return dict(rep, T_lay=h(T), F_up_tot=h(tot.F_up_tot),
                F_down_tot=h(tot.F_down_tot),
                F_up_band_toa=h(tot.F_up_band[L]))


def readings(cell, device: str) -> dict:
    """{"sound": [...], "forward64": [...], "control": [...]}, one entry
    of the reference's numbers per planet."""
    from benchmark.core import drive
    from benchmark.core.cell import reference

    ref = reference(cell.config)
    out = {"sound": [], "forward64": [], "control": []}
    with tempfile.TemporaryDirectory() as tmpdir:
        prog = drive.Program(cell.config, cell.traffic, device, tmpdir)
        table = prog.reference_table
        n = len(prog.members)
        reports = []
        for k in range(0, n, prog.batch):
            reports += prog.solve(list(range(k, min(n, k + prog.batch)))
                                  ).reports
        del prog
        programs = {key: drive.Program(cell.config, cell.traffic, device,
                                       tmpdir, precision=prec)
                    for key, prec in (("forward64", None),
                                      ("control", "single"))}
        for rep in reports:
            d = ref.deployment(cell.config["helios"],
                               cell.traffic["members"][rep["member"]])
            grid = ref.planck_table(d, table, device)
            judge = lambda r: dict(
                ref.check_planet(d, table, r, device, grid),
                member=rep["member"], converged=rep["converged"])
            out["sound"].append(judge(rep))
            for key, prog in programs.items():
                out[key].append(judge(forward_report(prog, rep, device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark.core import cell as cell_mod
    cell = cell_mod.load(args.workload)
    t = time.perf_counter()
    res = readings(cell, args.device)
    for key, rows in res.items():
        for name in cell.config["limits"]:
            vals = [r[name] for r in rows]
            print(f"{args.workload} {key} {name}: min {min(vals)!r} max "
                  f"{max(vals)!r}")
    print(json.dumps(dict(workload=args.workload, seconds=time.perf_counter()
                          - t, limits=cell.config["limits"], **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
