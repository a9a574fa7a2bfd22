"""Host seconds per solve spent issuing CUDA graph replays: graphs.Stats
replay_s (the span helios.replay) over both loops, the mean over the
window's solves.  Nothing to read where the Stats carry no replay_s."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    st = [s for x in rec["calls"] for s in x["stats"].values()]
    if not st or any("replay_s" not in s for s in st):
        return None
    return sum(s["replay_s"] for s in st) / len(rec["calls"])
