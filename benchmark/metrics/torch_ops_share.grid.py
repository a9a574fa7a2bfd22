"""The share of the device's busy time, in the traced batch, spent in
operations other than the program's six CUDA kernels (torch's own
kernels, copies and fills), in percent of the device time summed over
operations."""


def read(rec):
    p = rec["profile"]
    if rec["kind"] != "grid" or not p or not p["device_s"]:
        return None
    port = sum(s for s, _ in p["kernels"].values())
    return 100.0 * (1.0 - port / p["device_s"])
