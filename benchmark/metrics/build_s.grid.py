"""Model build and results per batch: run_ensemble's wall less its
radiation and convection loops, the mean over the window's batches."""


def read(rec):
    if rec["kind"] != "grid" or not rec["calls"]:
        return None
    c = rec["calls"]
    return sum(x["run_wall_s"] - x["rad_s"] - x["conv_s"] for x in c) / len(c)
