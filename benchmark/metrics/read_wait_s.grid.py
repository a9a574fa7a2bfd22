"""Host seconds per batch spent in blocking device reads, waiting for the
device included: graphs.Stats read_s (the span helios.read: each
iteration's read and the convection loop's entry read) and adjust_read_s
(helios.adjust_read: one per round of each unbounded adjustment) over
both loops, the mean over the window's batches.  Nothing to read where
the Stats carry neither."""


def read(rec):
    if rec["kind"] != "grid" or not rec["calls"]:
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    if not st or any("read_s" not in s or "adjust_read_s" not in s
                     for s in st):
        return None
    return (sum(s["read_s"] + s["adjust_read_s"] for s in st)
            / len(rec["calls"]))
