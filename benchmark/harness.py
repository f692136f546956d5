"""One run of one cell: set-up, the measured window, the optional trace,
the check against the reference, and the metrics.

Everything that belongs to one cell is found by name: the cell's
configuration and traffic in ``BENCHMARK.json``; the configuration's file
it names; ``traffic/<traffic>.json`` (whose ``kind`` names the driver in
``drivers/<kind>.py``); ``workloads/<cell>.json`` (the limits of the
compared numbers and how many calls the trace covers); and
``metrics/<metric>.py`` for every metric, whose ``read(run)`` returns the
value or None where the run has nothing for it to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark import devtrace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "avr_tpu")


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, m: Optional[dict] = None) -> dict:
    """The cell's entry, with its configuration, traffic and limits loaded."""
    m = m or manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    return {
        **entry,
        "config_file": _json(ROOT / conf["file"]),
        "traffic_file": _json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "cell_file": _json(HERE / "workloads" / f"{name}.json"),
    }


def metrics_of(name: str, m: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    e2e = [x for x in m["end_to_end"] if "workloads" not in x or name in x["workloads"]]
    if not trace:
        return e2e
    mine = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if (name in x["workloads"] if "workloads" in x else x["moves"] in mine)]


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(name: str, seed: int, seconds: float, trace: bool, device, started: float,
        config: Optional[dict] = None) -> dict:
    """The result of one run (``config`` replaces the cell's configuration,
    for runs at a small size)."""
    m = manifest()
    c = cell(name, m)
    cfg = config or c["config_file"]["config"]
    traffic = c["traffic_file"]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    clock = time.perf_counter
    cuda = device.type == "cuda"
    if cuda:
        from avr_torch.ops import _build

        _build.build_all()
        torch.cuda.set_device(device)
        torch.zeros((), device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    session = driver.Session(cfg, traffic, seed, device)
    session.warm_up()
    setup_s = clock() - started
    window = session.window(seconds, clock)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    record = {"cell": name, "kind": session.kind, "setup_s": setup_s, "peak_bytes": peak, "window": window,
              "trace": None}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": device_name(device), "count": 1,
           "memory_peak_bytes": peak}
    if trace:
        session.traced = []
        summary = devtrace.capture(session.traced_call, int(c["cell_file"]["trace_calls"]))
        summary["work"] = session.work()
        record["trace"] = summary
        dev["busy_s"] = summary.get("busy_s", 0.0)
        dev["window_s"] = summary.get("span_s", 0.0)
    session.release()
    limits = c["cell_file"]["limits"]
    numbers = session.check(limits)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = all(x["value"] == x["value"] and x["value"] <= x["limit"] for x in checks.values())
    metrics = {}  # a run on the CPU (the tests' small runs) reports no device metric
    for x in metrics_of(name, m, trace) if cuda else []:
        value = reader(x["name"])(record)
        if value is not None:
            metrics[x["name"]] = {"value": value, "unit": x["unit"]}
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace and record["trace"].get("device_ops"):
        result["breakdown"] = {"device_ops": devtrace.top_ops(record["trace"]),
                               "idle_gaps": record["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def check_lines(result: dict) -> str:
    return "\n".join(f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in result["checks"].items())
