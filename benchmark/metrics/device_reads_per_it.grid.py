"""Device reads per loop iteration of a batch (graphs.Stats reads over
iterations, both loops, the window's batches)."""


def read(rec):
    if rec["kind"] != "grid":
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    its = sum(s["iterations"] for s in st)
    return sum(s["reads"] for s in st) / its if its else None
