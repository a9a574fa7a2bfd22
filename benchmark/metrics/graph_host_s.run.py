"""Host seconds of the device loop's own work per solve: graph captures
and eager iterations (graphs.Stats capture_s + eager_s over both loops),
the mean over the window's solves."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    c = rec["calls"]
    return sum(st["capture_s"] + st["eager_s"] for x in c
               for st in x["stats"].values()) / len(c)
