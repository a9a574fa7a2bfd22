"""Host seconds per solve spent in the loops' device reads, waiting for
the device included: graphs.Stats read_s (the span helios.read: each
chunk's read and the convection loop's entry read) over both loops, the
mean over the window's solves.  Nothing to read where the Stats carry no
read_s."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    if not st or any("read_s" not in s for s in st):
        return None
    return sum(s["read_s"] for s in st) / len(rec["calls"])
