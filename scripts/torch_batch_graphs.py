"""A batch's loops on one CUDA card, graphed against per iteration: the
benchmark's flagship configuration under its grid8 mix (8 planets, surface
albedo 0.0, 0.1, ..., 0.7) as one ``run_ensemble`` with the default loops
(each iteration a replayed CUDA graph, one read per chunk), the same batch
inside ``graphs.loops(graphs.PER_ITERATION)``, and each member alone
through ``pipeline.run``.  Every member's final states of both loops (T,
fluxes, cells, totals, counters and flags) are compared bit for bit
between the graphed batch and the other two; the batches' loop Stats
(graphs, replays, eager iterations, reads, redos, the adjustment rounds'
histogram, host seconds) and walls are printed.

    python3 scripts/torch_batch_graphs.py [--repeat N] [--out FILE]

Run it from the root of a checkout; ``--repeat`` graphed batches (default
2; the first follows a warm-up batch).  Prints the card's name and power
limit and one JSON line (also written to ``--out``); exits 1 when a member
differs.  Needs a CUDA card and nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())

from benchmark.core import cell as cell_mod                 # noqa: E402
from benchmark.core.drive import Program                    # noqa: E402
from helios_tpu_torch import pipeline                       # noqa: E402
from helios_tpu_torch.kernels import _build                 # noqa: E402
from helios_tpu_torch.parallel import ensemble              # noqa: E402
from helios_tpu_torch.rce import graphs                     # noqa: E402

DEVICE = "cuda"


def differences(got, want, label=""):
    """The dotted names of the fields in which two loop states differ (a
    tensor not bit for bit, a counter or flag not equal)."""
    out = []
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        name = f"{label}{f}"
        if hasattr(w, "_fields"):
            out += differences(g, w, name + ".")
        elif isinstance(w, torch.Tensor):
            if (g.shape != w.shape or g.dtype != w.dtype
                    or not torch.equal(g.to(w.device), w)):
                out.append(name)
        elif bool(g != w):
            out.append(name)
    return out


def member_differences(a, b):
    """Where two runs of one planet differ: both loops' final states and
    the final T and flux totals."""
    out = differences(a.rad, b.rad, "rad.")
    if (a.conv is None) != (b.conv is None):
        return out + ["conv"]
    if b.conv is not None:
        out += differences(a.conv, b.conv, "conv.")
    out += differences(a.totals, b.totals, "totals.")
    if not torch.equal(a.T_lay, b.T_lay):
        out.append("T_lay")
    return out


def batch(prog, settings=None):
    """One run_ensemble of every member; (outputs, wall s, Stats dicts)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graphs.loops(settings) as lp:
        outs = ensemble.run_ensemble(prog.cfgs,
                                     tables=[prog.table] * len(prog.cfgs),
                                     write_output=False, device=DEVICE)
        torch.cuda.synchronize()
        stats = {k: st.as_dict() for k, st in lp.stats.items()}
    return outs, time.perf_counter() - t0, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    _build.build_all()
    cell = cell_mod.load("flagship.grid8")
    prog = Program(cell.config, cell.traffic, DEVICE, tempfile.mkdtemp())

    batch(prog)                                   # warm-up
    graphed = []
    for _ in range(args.repeat):
        torch.cuda.reset_peak_memory_stats()
        outs, wall, stats = batch(prog)
        graphed.append(dict(wall_s=wall, stats=stats,
                            peak_bytes=torch.cuda.max_memory_allocated()))
        print(f"graphed batch: {wall:.3f} s; " + json.dumps(stats),
              flush=True)
    per, per_wall, per_stats = batch(prog, graphs.PER_ITERATION)
    print(f"per-iteration batch: {per_wall:.3f} s", flush=True)

    members, bad = [], 0
    for k, cfg in enumerate(prog.cfgs):
        mine = outs[k]
        with graphs.loops():
            solo = pipeline.run(cfg, prog.table, write_output=False,
                                device=DEVICE)
        row = dict(member=k, surf_albedo=cfg.surf_albedo,
                   rad_it=mine.rad.it, conv_it=mine.conv.it,
                   conv_steps=mine.conv.steps,
                   against_per_iteration=member_differences(mine, per[k]),
                   against_alone=member_differences(mine, solo))
        bad += bool(row["against_per_iteration"] or row["against_alone"])
        members.append(row)
        print(json.dumps(row), flush=True)

    line = dict(card=card, ok=bad == 0, members=members, graphed=graphed,
                per_iteration=dict(wall_s=per_wall, stats=per_stats))
    text = json.dumps(line)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
