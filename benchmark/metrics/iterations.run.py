"""Loop iterations (flux solves: radiation + convection) per planet,
the mean over the window's solves."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    c = rec["calls"]
    return sum(x["flux_solves"] for x in c) / len(c)
