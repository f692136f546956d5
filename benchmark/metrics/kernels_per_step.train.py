"""Device kernels in the trace per optimizer step."""


def read(run):
    t = run["trace"]
    if run["kind"] != "train" or not t or not t.get("kernels"):
        return None
    return t["kernels"] / t["calls"]
