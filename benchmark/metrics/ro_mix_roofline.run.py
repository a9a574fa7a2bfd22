"""ro_mix's share of its roofline in the traced solve: the frozen bound
of one call (benchmark/frozen/costs.py) at the mean of its two shapes, L
x B cells (the layers) and (L + 1) x B (the interfaces), ny Gauss points,
over the profiler's device time per call, in percent.  The bound is
taken with no cell of negligible overlap: at ny = 20 it is the bytes'
whatever their count.  Nothing to read where ro_mix did not run."""

from benchmark.frozen import costs


def read(rec):
    p, s = rec["profile"], rec["shape"]
    if rec["kind"] != "single" or not p or "ro_mix" not in p["kernels"]:
        return None
    sec, calls = p["kernels"]["ro_mix"]
    cells = s["P"] * (2 * s["L"] + 1) * s["B"] / 2.0
    bound = costs.ro_mix(cells, s["Y"], 0, s["size"])["bound_s"]
    return 100.0 * bound / (sec / calls)
