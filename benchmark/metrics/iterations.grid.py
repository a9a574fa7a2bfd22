"""Batched flux solves per batch (the slowest member's radiation
iterations and convection steps), the mean over the window's batches."""


def read(rec):
    if rec["kind"] != "grid" or not rec["calls"]:
        return None
    c = rec["calls"]
    return sum(x["flux_solves"] for x in c) / len(c)
