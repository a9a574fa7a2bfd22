"""Where a one-planet run's loop iterations go on one CUDA card: the
convection iteration's host wall, device time and kernels, the adjustment
rounds each convective adjustment needs, and the flagship's walls on one
device against two spectral slices, in turns.

    python3 scripts/torch_loop_profile.py [--out FILE]

Run it from the root of a checkout.  It drives ``chip_smoke.py``'s
workloads with the per-iteration loops (``rce.graphs.PER_ITERATION``,
where the checkout has it): path a (the flagship), f (clouds and the
zenith-corrected beam), h (a rocky surface with a physical timestep) and
m's table convection (a real-gas kappa / c_p table), counting the rounds
of every convective adjustment (the corrections before the final fudged
one); the flagship's convection iterations 10..30 after the radiation
loop, host wall unprofiled and device busy time and kernels under
torch.profiler; and path a against path p (2 slices of the card) in the
order a, p, p, a.  Prints the card's name and power limit and one JSON
line.  Needs a CUDA card and nvcc.
"""

import argparse
import collections
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs                                   # noqa: E402
from helios_tpu_torch.rce import convect                  # noqa: E402

ROUNDS = collections.Counter()


@contextlib.contextmanager
def counted_rounds():
    """Count, per convective adjustment, its correction rounds (the calls
    of conv_correct without fudge factors) into ROUNDS."""
    adjust, correct = convect.convective_adjustment, convect.conv_correct
    now = {"n": 0}

    def counting_correct(*args, **kw):
        if kw.get("fudge_per_zone") is None:
            now["n"] += 1
        return correct(*args, **kw)

    def counting_adjust(*args, **kw):
        now["n"] = 0
        out = adjust(*args, **kw)
        ROUNDS[now["n"]] += 1
        return out

    convect.convective_adjustment = counting_adjust
    convect.conv_correct = counting_correct
    try:
        yield
    finally:
        convect.convective_adjustment = adjust
        convect.conv_correct = correct


def per_iteration():
    """The per-iteration loops where the checkout has a graphed one."""
    try:
        from helios_tpu_torch.rce import graphs
    except ImportError:
        return contextlib.nullcontext()
    return graphs.loops(graphs.PER_ITERATION)


def rounds_of(label, fn):
    ROUNDS.clear()
    with counted_rounds():
        out = fn()
    dist = dict(sorted(ROUNDS.items()))
    cs.log(f"{label}: adjustment rounds per adjustment {dist} "
           f"({sum(ROUNDS.values())} adjustments)")
    return out, {str(k): v for k, v in dist.items()}


def conv_breakdown(out, thermo, n=20):
    """Convection iterations 10..10+n after the flagship's radiation loop:
    host wall per iteration unprofiled, then device busy and kernels per
    iteration under the profiler; with the adjustment rounds of the
    window."""
    from torch.profiler import ProfilerActivity, profile
    from helios_tpu_torch.rce import loop

    run = lambda s, k: loop.convection_loop(
        out.phys, out.arrays, thermo, out.rad, max_steps=k, state0=s)
    s = run(None, 0)
    s = run(s, 10)
    torch.cuda.synchronize()
    ROUNDS.clear()
    with counted_rounds():
        t = time.perf_counter()
        s1 = run(s, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    rounds = sum(k * v for k, v in ROUNDS.items())
    cs.check(s1.steps - s.steps == n, "conv breakdown: the loop stopped")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(s, n)
        torch.cuda.synchronize()
    device_us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
        count += e.count
    busy_ms = device_us / 1e3 / n
    res = dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=count / n,
               rounds_per_iteration=rounds / n,
               host_reads_per_iteration=1 + (rounds + n) / n)
    cs.log(f"flagship convection iteration (steps {s.steps}..{s1.steps}): "
           f"wall {wall_ms:.3f} ms; device busy {busy_ms:.3f} ms (idle "
           f"{100 * (1 - busy_ms / wall_ms):.1f}%) in {count / n:.0f} "
           f"kernels; {rounds / n:.2f} adjustment rounds per iteration")
    return res


def walls(out):
    return dict(wall_s=out.wall_seconds, rad_it=out.rad.it,
                conv_it=out.conv.it, conv_steps=out.conv.steps,
                rad_ms=out.rad_seconds / out.rad.it * 1e3,
                conv_ms=out.conv_seconds / out.conv.steps * 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_profile: CUDA is not available", file=sys.stderr)
        return 1
    from helios_tpu_torch import pipeline
    cs.environment()
    cs.build()
    res = {}
    with per_iteration(), tempfile.TemporaryDirectory() as tmpdir:
        cfg, table = cs.flagship(tmpdir)
        a, res["rounds_a"] = rounds_of("path a", lambda: pipeline.run(
            cfg, table, write_output=False, device=cs.DEVICE))
        res["conv_breakdown_a"] = conv_breakdown(
            a, pipeline.make_thermo(cfg, device=cs.DEVICE))
        cfg_p, _ = cs.flagship(tmpdir, n_spectral_shards=2)
        runs = []
        for which in ("a", "p", "p", "a"):
            if which == "a":
                o = pipeline.run(cfg, table, write_output=False,
                                 device=cs.DEVICE)
            else:
                o = pipeline.run(cfg_p, table, write_output=False,
                                 device=[cs.DEVICE] * 2)
            w = walls(o)
            cs.check(np.array_equal(o.T_lay.cpu().numpy(),
                                    a.T_lay.cpu().numpy()),
                     f"path {which}: not bit for bit path a")
            runs.append(dict(path=which, **w))
            cs.log(f"path {which}: wall {w['wall_s']:.3f} s, "
                   f"{w['rad_it']} + {w['conv_it']} it, radiation "
                   f"{w['rad_ms']:.3f} ms/it, convection {w['conv_ms']:.3f} "
                   "ms/it")
        res["a_vs_p"] = runs
        _, res["rounds_f"] = rounds_of("path f", lambda: cs.cloudy_path(
            tmpdir, {}))
        _, res["rounds_h"] = rounds_of("path h", lambda: cs.rocky_path({}))
        water = cs.write_water_table(os.path.join(tmpdir, "water_atmo.dat"))
        _, res["rounds_m"] = rounds_of(
            "path m (table convection)",
            lambda: cs.table_convection_path(tmpdir, water, {}, a))
    res["card"] = cs.nvidia_smi_line()
    print(res["card"], flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        cs.PATH_LOOPS.close()   # the last path's runners, before shutdown
    sys.exit(code)
