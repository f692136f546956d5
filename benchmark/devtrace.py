"""The device trace of a few whole steps or requests, reduced to what the
per-layer metrics read.

``capture`` runs a function under ``torch.profiler``, each call inside a
``benchmark.step`` span, and synchronises at the end. ``reduce`` turns
the chrome trace into: the span from the first step span's start to the
last device operation's end; the union of the device operations'
intervals (busy time, overlaps counted once); kernel counts and seconds
by kind (``KINDS``, from the kernel's name) and by name; and the longest
idle gaps of the device, each named by the innermost host operation
running at its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

# Device kernels grouped by kind: the first kind with a key in the
# lower-cased kernel name.
KINDS = (
    ("port", ("hashgrid_encode_kernel", "hashgrid_encode_bwd_kernel", "scatter_add_rows_kernel")),
    ("matmul", ("nvjet", "gemm")),
    ("fft", ("fft",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "copy")),
)
SPAN = "benchmark.step"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, keys in KINDS if any(s in low for s in keys)), "other")


def _profile(fn: Callable[[int], None], calls: int, host_ops: bool) -> Tuple[List[dict], float]:
    """Chrome-trace events of fn(0..calls−1), each call in a SPAN, and the
    host's seconds from the first call to the synchronise after the last."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = ([ProfilerActivity.CUDA] if cuda else []) + ([ProfilerActivity.CPU] if host_ops or not cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            with record_function(SPAN):
                fn(i)
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, wall


def capture(fn: Callable[[int], None], calls: int) -> dict:
    """The reduced trace of ``calls`` calls of fn, traced on the device
    alone (host operations recorded would slow a host-bound call several
    fold): busy time, kernels by kind and name, and the wall span by the
    host's clock from the first call to the synchronise after the last.
    Then one more call traced with its host operations, whose idle gaps
    are named. A trace that holds no device operation is returned as it
    is, and the metrics that read it find nothing."""
    events, wall = _profile(fn, calls, host_ops=False)
    out = reduce(events, calls)
    if out["device_ops"]:
        out["span_s"] = wall
        events, _ = _profile(lambda i: fn(calls + i), 1, host_ops=True)
        out["idle_gaps"] = reduce(events, 1).get("idle_gaps", [])
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events: List[dict], calls: int) -> dict:
    """Times in seconds; trace timestamps are microseconds."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SPAN and e.get("cat") != "gpu_user_annotation"]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST_CATS and e.get("name") != SPAN]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    out = {"calls": calls, "device_ops": len(dev), "kernels": len(kernels)}
    if not dev:
        return out
    ends = [e["ts"] + e["dur"] for e in dev + spans]
    start = min(e["ts"] for e in (spans or dev))
    end = max(ends)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name: Dict[str, float] = {}
    by_kind: Dict[str, float] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
        k = kind_of(e["name"])
        by_kind[k] = by_kind.get(k, 0.0) + e["dur"] / 1e6
    gaps = []
    edges = [(start, start)] + busy + [(end, end)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            gaps.append((b - a, (a + b) / 2))
    gaps.sort(reverse=True)
    named = []
    for length, mid in gaps[:10]:
        over = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(over, key=lambda e: e["dur"])["name"] if over else "(no host op)"
        named.append([name, length / 1e6])
    out.update(
        span_s=(end - start) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s_by_kind=by_kind,
        kernel_s_by_name=by_name,
        idle_gaps=named,
    )
    return out


def top_ops(summary: dict, n: int = 10) -> List[list]:
    by_name = summary.get("kernel_s_by_name", {})
    return [[name[:200], s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
