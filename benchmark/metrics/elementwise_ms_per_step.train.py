"""Device ms per optimizer step of the kernels whose kind is elementwise
(elementwise and copy kernels, by name)."""


def read(run):
    t = run["trace"]
    if run["kind"] != "train" or not t or "kernel_s_by_kind" not in t:
        return None
    return 1e3 * t["kernel_s_by_kind"].get("elementwise", 0.0) / t["calls"]
