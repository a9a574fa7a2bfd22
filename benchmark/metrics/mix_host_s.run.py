"""Host seconds per solve of on-the-fly opacity mixing: graphs.Stats
mix_s (the span helios.mix around each chem.mixed_opacities call, inside
graph captures and eager iterations) over both loops, the mean over the
window's solves.  Nothing to read where the Stats count no mixing pass
(a premixed run, or a program without the mixing's fields)."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    if not any(s.get("mixes") for s in st):
        return None
    return sum(s.get("mix_s", 0.0) for s in st) / len(rec["calls"])
