"""The device's idle share of the traced solve: 1 - the union of its
operations' intervals over the solve's wall, in percent."""


def read(rec):
    p = rec["profile"]
    if rec["kind"] != "single" or not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
