"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``): importing torch, building or loading the CUDA
kernels (``helios_tpu_torch/_build/`` inside the checkout), making the
opacity table and the configurations, and one warm call of the cell's own
shapes.  The window then runs whole rounds of the mix (every planet once,
in an order drawn from the seed) until ``--seconds`` have passed.  With
``--trace 1`` one more call runs under torch.profiler and the per-layer
metrics are printed instead of the end-to-end ones.  Once the window has
closed, every planet it solved is judged by the configuration's plain
reference; the numbers compared and their limits end standard error and
the result line.  Without a CUDA card, or with fewer than the cell asks
for, the run exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "helios_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (helios_tpu_torch is not helios_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def metrics_e2e(cell, calls, setup_s):
    """The end-to-end metrics over the window's calls."""
    wall = sum(c.wall_s for c in calls)
    planets = sum(len(c.members) for c in calls)
    converged = sum(r["converged"] and r["finite"]
                    for c in calls for r in c.reports)
    values = dict(setup_s=setup_s, run_seconds=wall / planets,
                  planets_per_hour=3600.0 * converged / wall)
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in cell.end_to_end}


def record(cfg, traffic, calls, prof):
    """What the readers of the per-layer metrics read."""
    from benchmark.core.cell import reference
    h, t = cfg["helios"], cfg["table"]
    batch = int(traffic["batch"])
    return dict(
        kind="single" if batch == 1 else "grid", config=cfg,
        calls=[dict(wall_s=c.wall_s, run_wall_s=c.run_wall_s, rad_s=c.rad_s,
                    conv_s=c.conv_s, flux_solves=c.flux_solves,
                    planets=len(c.members), stats=c.stats) for c in calls],
        shape=dict(L=reference(cfg).deployment(h, {})["nlayer"],
                   B=int(t["nbin"]), Y=int(t["ny"]), P=batch,
                   passes=3 * (h["scattering"] == "yes") + 1,
                   method=h["flux_calc_method"],
                   size=8 if h["precision"] == "double" else 4),
        profile=prof)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, tmpdir: str) -> dict:
    """One run of ``cell``; returns the result line's object.  Also used
    by the tests on the CPU (``device="cpu"``, no profile)."""
    import torch

    from benchmark.core import drive, judge

    if device == "cuda":
        from helios_tpu_torch.kernels import _build
        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    prog = drive.Program(cell.config, cell.traffic, device, tmpdir)
    n = len(prog.members)
    # warm-up: one call of the cell's shapes, the same for every seed
    prog.solve(list(range(prog.batch)))
    setup_s = time.perf_counter() - t_start

    calls = []
    t0 = time.perf_counter()
    for calls_of_round in drive.rounds(seed, n, prog.batch):
        for members in calls_of_round:
            calls.append(prog.solve(members))
        if time.perf_counter() - t0 >= seconds:
            break
    prof = None
    if trace:
        from benchmark.core import profile
        first = next(drive.rounds(seed + 1, n, prog.batch))[0]
        call, prof = profile.traced_call(lambda: prog.solve(first))
        calls_traced = [call]
    else:
        calls_traced = []
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    reports = [r for c in calls + calls_traced for r in c.reports]
    table = prog.reference_table
    del prog, calls_traced
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = judge.judge(cell.config, cell.traffic, table, reports, device)
    t_judge = time.perf_counter() - t_judge
    if trace:
        from benchmark.core.cell import readers
        rec = record(cell.config, cell.traffic, calls, prof)
        read = readers(cell)
        metrics = {}
        for m in cell.per_layer:
            v = read[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        metrics = metrics_e2e(cell, calls, setup_s)
    out = dict(correct=judge.correct(checks), attempted=len(reports),
               failed=checks["failed"]["value"], metrics=metrics)
    if device == "cuda":
        out["device"] = dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=cell.chips, memory_peak_bytes=peak)
        if prof is not None:
            out["device"].update(busy_s=prof["busy_s"],
                                 window_s=prof["window_s"])
            out["breakdown"] = prof["breakdown"]
    out["checks"] = checks
    out["_window"] = dict(calls=len(calls),
                          wall_s=sum(c.wall_s for c in calls),
                          call_walls=[c.wall_s for c in calls],
                          judge_s=t_judge,
                          elapsed_s=time.perf_counter() - t_start)
    if prof is not None:
        out["_trace"] = {k: v for k, v in prof.items() if k != "breakdown"}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.core import cell as cell_mod
    cell = cell_mod.load(args.workload)

    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    tmpdir = tempfile.mkdtemp(prefix="helios_bench_")
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    out["device"]["power_limit"] = card.split(",")[-1].strip()
    extra = {k: out.pop(k) for k in ("_window", "_trace") if k in out}
    print(f"window: {json.dumps(extra)}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["checks"] = checks              # the numbers compared come last
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
