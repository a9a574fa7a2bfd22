"""Share of the device loop's runner lookups that took over a runner kept
from an earlier solve, with its graphs, a fraction: graphs.Stats
cache_hits over cache_hits + cache_misses, both loops, the window's
solves.  Nothing to read where the Stats lack the fields (a program that
keeps no runner across solves), where no lookup was counted, or for a
batch."""


def read(rec):
    if rec["kind"] != "single":
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    if not st or any("cache_hits" not in s for s in st):
        return None
    hits = sum(s["cache_hits"] for s in st)
    total = hits + sum(s["cache_misses"] for s in st)
    return hits / total if total else None
