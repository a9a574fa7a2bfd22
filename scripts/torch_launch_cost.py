"""Time every kernel wrapper of helios_tpu_torch at the short calls of the
loops, for the package found in the working directory, on one CUDA card.

    python3 scripts/torch_launch_cost.py [--rounds 3] [--out FILE]

Run it from the root of a checkout (the package is imported from the
working directory), so that two versions of the launch path compare on one
card: from the root of each checkout in turn, in one session.  For each
wrapper at the shapes of ``chip_smoke.py`` phase 3 (the fixed-order Gauss
sum [106, 385, 20] fp64 and ``torch.sum`` beside it, the iso sweep at 4
passes and the non-iso sweep at 4 passes on 105 x 7700, the Thomas solve at
422 x 7700, the Random Overlap mix of 40425 x 20 cells, and one flux
integration of 106 x 7700 fluxes through ``forward._band_totals``) it
prints the CUDA-event median of 20 back-to-back calls and the host time of
one call (``time.perf_counter_ns`` over 10 batches of 100 calls, no sync
inside a batch, the median batch), over ``--rounds`` rounds (the median
round), then the card's name and power limit and one JSON line.  Needs a
CUDA card and nvcc.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def event_ms(fn, reps=20, per_event=20):
    """Median CUDA-event time of one fn() over reps samples of per_event
    back-to-back calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_event):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_event)
    return statistics.median(times)


def host_us(fn, n=1000, batch=100):
    """Host microseconds of one fn(): the median of n / batch batches, the
    card drained between batches."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(n // batch):
        t = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        per_call.append((time.perf_counter_ns() - t) / batch / 1e3)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def calls():
    """{name: fn()} of the wrappers at the loops' short calls."""
    from helios_tpu_torch import forward
    from helios_tpu_torch.kernels.ordered import ordered_sum
    from helios_tpu_torch.kernels.ro import ro_mix
    from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
    from helios_tpu_torch.kernels.thomas import thomas_solve

    rng = np.random.default_rng(0)
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s),
                                         dtype=torch.float64, device="cuda")
    L, B, Y = 105, 385, 20
    S = B * Y
    x = mk(1.0, 1e4, L + 1, B, Y)
    lay = lambda: [mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S)]
    src = lambda: mk(1e2, 1e4, L, S)
    rows = [mk(0.0, 1e3, S), mk(0.0, 0.4, S), mk(1e2, 1e4, S),
            mk(0.0, 1e3, S)]
    iso = lay() + [src(), src()] + rows + [mk(0.0, 1e3, L + 1, S)]
    noniso = (lay() + [src(), src()] + lay() + [src(), src()] + rows
              + [mk(0.0, 1e3, L + 1, S), mk(0.0, 1e3, L, S)])
    n = 4 * (L + 1) - 2
    b = mk(2.0, 3.0, n, S)
    c, d = mk(-0.5, 0.5, n, S), mk(-1.0, 1.0, n, S)
    mixed = torch.sort(mk(1e-30, 1e-20, L * B, Y), dim=1).values
    new = torch.sort(mk(1e-30, 1e-20, L * B, Y), dim=1).values
    g_w, g_y = mk(0.01, 0.1, Y), torch.sort(mk(0.0, 1.0, Y)).values
    m = SimpleNamespace(gauss_weight=mk(0.01, 0.1, Y),
                        delta_lambda=mk(1e-7, 1e-5, B))
    flux = SimpleNamespace(F_down=mk(0.0, 1e6, L + 1, S),
                           F_up=mk(0.0, 1e6, L + 1, S))
    F_dir = mk(0.0, 1e6, L + 1, S)
    return {
        "ordered_sum gauss sum": lambda: ordered_sum(x, -1),
        "torch.sum gauss sum": lambda: torch.sum(x, -1),
        "iso_sweep 4 passes": lambda: iso_sweep(*iso, n_passes=4),
        "noniso_sweep 4 passes": lambda: noniso_sweep(*noniso, n_passes=4),
        "thomas_solve n=422": lambda: thomas_solve(b, c, d),
        "ro_mix 40425 x 20": lambda: ro_mix(mixed, new, g_w, g_y),
        "flux integration": lambda: forward._band_totals(m, flux, F_dir),
    }


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_launch_cost: CUDA is not available", file=sys.stderr)
        return 1
    from helios_tpu_torch.kernels import _build
    _build.build_all()
    fns = calls()
    rounds = []
    for _ in range(args.rounds):
        rounds.append({k: dict(ms=event_ms(f), host_us=host_us(f))
                       for k, f in fns.items()})
    res = {k: {q: statistics.median(r[k][q] for r in rounds)
               for q in ("ms", "host_us")} for k in fns}
    for k, v in res.items():
        print(f"{os.getcwd()}: {k}: {v['ms']:.4f} ms back to back, "
              f"{v['host_us']:.2f} us of host time per call", flush=True)
    line = json.dumps(dict(tree=os.getcwd(), card=nvidia_smi_line(),
                           results=res))
    print(nvidia_smi_line())
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
