"""ro_mix launches per on-the-fly mixing pass over the window:
graphs.Stats mix_launches over mixes, both loops (a replay counts what
its graph holds): one per absorber after the first, fewer only where
absorbers are mixed in fewer launches.  Nothing to read where the Stats
count no mixing pass."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    mixes = sum(s.get("mixes", 0) for s in st)
    if not mixes:
        return None
    return sum(s.get("mix_launches", 0) for s in st) / mixes
