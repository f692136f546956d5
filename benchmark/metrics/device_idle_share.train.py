"""Share of the traced calls' wall span in which no operation ran on the
device: 1 − (union of device operation intervals) / span, in %."""


def read(run):
    t = run["trace"]
    if run["kind"] != "train" or not t or not t.get("span_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
