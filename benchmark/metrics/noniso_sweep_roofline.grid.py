"""noniso_sweep's share of its roofline in the traced batch: the
frozen bound of one call at its shape (L layers, P x B x Y columns, 3
scat + 1 passes; 3.35 TB/s, 34 TFLOP/s fp64) over the profiler's device
time per call, in percent.  Nothing to read where the sweep did not run
with that many passes (the matrix method's one-pass fallback)."""

from benchmark.frozen import costs


def read(rec):
    p, s = rec["profile"], rec["shape"]
    if (rec["kind"] != "grid" or not p or s["method"] != "iteration"
            or "noniso_sweep" not in p["kernels"]):
        return None
    sec, calls = p["kernels"]["noniso_sweep"]
    bound = costs.noniso_sweep(s["L"], s["P"] * s["B"] * s["Y"],
                               s["passes"], s["size"])["bound_s"]
    return 100.0 * bound / (sec / calls)
