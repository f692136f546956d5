"""The hash encodes' least time per step (benchmark/counts.py: the bytes of
points, features, upstream gradients and distinct table rows at the HBM
rate) over the device time per step of the kernels that do that work, %."""

KERNELS = ("hashgrid_encode_kernel", "hashgrid_encode_bwd_kernel")


def read(run):
    t = run["trace"]
    if run["kind"] != "train" or not t or "kernel_s_by_name" not in t:
        return None
    spent = sum(s for n, s in t["kernel_s_by_name"].items() if any(k in n for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * t["work"]["encode_least_s_per_call"] * t["calls"] / spent
