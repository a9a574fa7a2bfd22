"""Launches of the convective adjustment's kernel per convection
iteration: graphs.Stats adjust_launches of the convection loop (counted
live and, by a replay, as many as its graph holds) over its iterations
run and replayed past the stop, the window's solves.  1.0 where every
adjustment is one launch; above it where a chunk was redone with
unbounded rounds (one launch per round and one more).  Nothing to read
where the Stats carry no adjust_launches (a program without the kernel)
or no convection iteration ran."""


def read(rec):
    if rec["kind"] != "single":
        return None
    st = [x["stats"]["convection"] for x in rec["calls"]
          if "convection" in x["stats"]]
    if not st or any("adjust_launches" not in s for s in st):
        return None
    its = sum(s["iterations"] + s["past_stop"] for s in st)
    return sum(s["adjust_launches"] for s in st) / its if its else None
