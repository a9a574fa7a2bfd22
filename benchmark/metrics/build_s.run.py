"""Model build and result per solve: the run's wall less its radiation
and convection loops (RunOutput.wall_seconds - rad_seconds -
conv_seconds), the mean over the window's solves of one planet."""


def read(rec):
    if rec["kind"] != "single" or not rec["calls"]:
        return None
    c = rec["calls"]
    return sum(x["run_wall_s"] - x["rad_s"] - x["conv_s"] for x in c) / len(c)
