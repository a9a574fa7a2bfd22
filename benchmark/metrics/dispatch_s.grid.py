"""Host seconds per batch spent issuing the batch's iterations, its
waits taken out: graphs.Stats eager_s (the span helios.iteration) less
adjust_read_s (the adjustments' blocking reads inside it) over both
loops, the mean over the window's batches.  Nothing to read where the
Stats carry no adjust_read_s."""


def read(rec):
    if rec["kind"] != "grid" or not rec["calls"]:
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    if not st or any("adjust_read_s" not in s for s in st):
        return None
    return (sum(s["eager_s"] - s["adjust_read_s"] for s in st)
            / len(rec["calls"]))
