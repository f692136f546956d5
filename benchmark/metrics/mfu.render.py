"""Model FLOPs of the window's calls (the MLPs at the configured widths,
benchmark/counts.py) over the window's seconds times the bf16 dense peak
of an H100 (989e12 FLOP/s at 700 W), %. Read in the traced run, from its
own window, which runs before and without the profiler."""

from benchmark.counts import BF16_FLOPS


def read(run):
    t, w = run["trace"], run["window"]
    if run["kind"] != "render" or not t or not w["calls"]:
        return None
    return 100.0 * t["work"]["model_flops_per_call"] * w["calls"] / (w["seconds"] * BF16_FLOPS)
