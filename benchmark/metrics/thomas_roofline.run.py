"""thomas_solve's share of its roofline in the traced solve: the frozen
bound of one call (n = 4 (L+1) - 2 rows, B x Y columns; 3.35 TB/s, 34
TFLOP/s fp64) over the profiler's device time per call, in percent."""

from benchmark.frozen import costs


def read(rec):
    p, s = rec["profile"], rec["shape"]
    if (rec["kind"] != "single" or not p or s["method"] != "matrix"
            or "thomas_solve" not in p["kernels"]):
        return None
    sec, calls = p["kernels"]["thomas_solve"]
    n = 4 * (s["L"] + 1) - 2
    bound = costs.thomas_solve(n, s["P"] * s["B"] * s["Y"],
                               s["size"])["bound_s"]
    return 100.0 * bound / (sec / calls)
