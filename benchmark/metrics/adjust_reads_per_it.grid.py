"""Blocking reads of the batch's convective adjustments per convection
iteration: graphs.Stats adjust_reads (one per correction round of each
unbounded adjustment and one more) over the convection loop's
iterations, the window's batches.  Nothing to read where the Stats carry
no adjust_reads or no convection iteration ran."""


def read(rec):
    if rec["kind"] != "grid":
        return None
    st = [x["stats"]["convection"] for x in rec["calls"]
          if "convection" in x["stats"]]
    if not st or any("adjust_reads" not in s for s in st):
        return None
    its = sum(s["iterations"] for s in st)
    return sum(s["adjust_reads"] for s in st) / its if its else None
