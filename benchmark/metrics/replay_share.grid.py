"""Share of a batch's loop iterations that ran as replayed CUDA graphs, a
fraction: graphs.Stats replays over replays + eager (the eager iterations
include each key's first run and the iterations of redone chunks), both
loops, the window's batches.  0.0 where the batch ran every iteration
eagerly; nothing to read where no iteration ran."""


def read(rec):
    if rec["kind"] != "grid":
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    replays = sum(s["replays"] for s in st)
    total = replays + sum(s["eager"] for s in st)
    return replays / total if total else None
