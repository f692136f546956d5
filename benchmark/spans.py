"""The program's own spans (``avr_torch.utils.profiling``) on the device
trace: device idle time split by the step's phases, and device time by the
span that launched it.

``_profile`` traces calls on the device alone, as ``devtrace`` traces them,
with the program's tracer on for that pass only, and keeps the trace's
``baseTimeNanoseconds``; a program without the tracer records no span.

Spans are kept on ``time.time_ns()``; the chrome trace's ``ts`` is
(time_ns − ``baseTimeNanoseconds``) / 1000, so a span maps onto the trace by
that subtraction, and no host operation needs recording.

``split`` reads:
  * idle by phase: the idle intervals of the device inside the span that
    ``devtrace.reduce`` takes (the complement of the same union of device
    intervals), each cut by its overlap with the phase spans ``render``,
    ``criterion``, ``backward`` and ``optimizer``; idle under none of them
    is ``outside``;
  * device time by span: each kernel joined by ``args.correlation`` to the
    ``cuda_runtime`` (or ``cuda_driver``) event that launched it, its
    duration given to the shortest span, on any thread, that holds the
    launch: so a kernel of a checkpointed chunk recomputed in the backward
    goes to ``render.chunk``, not to ``backward``. Kernels are also counted
    by the phase span that holds their launch.

Run as a script it measures one cell on the card: the tracer's cost (calls
untraced, then traced on the device alone, spans off against on, in turns),
and the split of the traced calls, as one JSON line:

    python -m benchmark.spans --workload <cell> --seed <n> [--out FILE]
    python -m benchmark.spans --probe    # launch events and the span clock
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import devtrace

PHASES = ("render", "criterion", "backward", "optimizer")
OUTSIDE = "outside"
NO_SPAN = "(no span)"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from avr_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "drain") and hasattr(profiling, "enable") else None


def _profile(fn: Callable[[int], None], calls: int, spans: bool) -> Tuple[dict, float, list, dict]:
    """The chrome trace (events and ``baseTimeNanoseconds``) of
    fn(0..calls−1) traced on the device alone, each call in a
    ``devtrace.SPAN`` as ``devtrace`` traces it; the host's seconds from the
    first call to the synchronise after the last; and, with ``spans``, the
    program's spans and counters of the pass."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof_mod = tracer() if spans else None
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    sync()
    if prof_mod is not None:
        prof_mod.drain()
        prof_mod.enable()
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                with record_function(devtrace.SPAN):
                    fn(i)
            sync()
            wall = time.perf_counter() - t0
    finally:
        if prof_mod is not None:
            prof_mod.disable()
    recorded, counts = prof_mod.drain() if prof_mod is not None else ([], {})
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace, wall, recorded, counts


def _on_trace(spans: List[dict], base_ns: int) -> List[Tuple[str, float, float]]:
    """(name, start, end) of each closed span in trace microseconds."""
    return [(s["name"], (s["start_ns"] - base_ns) / 1e3, (s["end_ns"] - base_ns) / 1e3)
            for s in spans if s["end_ns"] is not None]


def split(events: List[dict], spans: List[dict], base_ns: int) -> dict:
    """Idle by phase and device time by span (seconds, summed over the
    traced calls), from a device-only trace's events and the program's
    spans of the same pass."""
    x = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in x if e.get("cat") in devtrace._DEVICE_CATS]
    steps = [e for e in x if e.get("name") == devtrace.SPAN and e.get("cat") != "gpu_user_annotation"]
    if not dev:
        return {}
    start = min(e["ts"] for e in (steps or dev))
    end = max(e["ts"] + e["dur"] for e in dev + steps)
    busy = devtrace._union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    edges = [(start, start)] + busy + [(end, end)]
    idle = [(a, b) for (_, a), (b, _) in zip(edges[:-1], edges[1:]) if b > a]

    mapped = _on_trace(spans, base_ns)
    phase_ivs = {p: sorted((a, b) for n, a, b in mapped if n == p) for p in PHASES}
    idle_by = dict.fromkeys(PHASES + (OUTSIDE,), 0.0)
    for a, b in idle:
        covered = 0.0
        for p, ivs in phase_ivs.items():
            for c, d in ivs:
                o = min(b, d) - max(a, c)
                if o > 0:
                    idle_by[p] += o
                    covered += o
        idle_by[OUTSIDE] += (b - a) - covered

    launch = {e["args"]["correlation"]: e["ts"] for e in x
              if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    names = [n for n, _, _ in mapped]
    s0 = np.array([a for _, a, _ in mapped], dtype=np.float64)
    s1 = np.array([b for _, _, b in mapped], dtype=np.float64)
    length = s1 - s0
    is_phase = np.array([n in PHASES for n in names], dtype=bool)
    device_s: Dict[str, float] = {}
    kind_s: Dict[str, Dict[str, float]] = {}
    kernels_by: Dict[str, int] = {}
    phase_s: Dict[str, float] = {}
    phase_kernels: Dict[str, int] = {}
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    launched = 0
    for k in kernels:
        t = launch.get(k.get("args", {}).get("correlation"))
        if t is None:
            continue
        launched += 1
        held = (s0 <= t) & (t <= s1)
        name = names[int(np.argmin(np.where(held, length, np.inf)))] if held.any() else NO_SPAN
        device_s[name] = device_s.get(name, 0.0) + k["dur"] / 1e6
        by_kind = kind_s.setdefault(name, {})
        kind = devtrace.kind_of(k["name"])
        by_kind[kind] = by_kind.get(kind, 0.0) + k["dur"] / 1e6
        kernels_by[name] = kernels_by.get(name, 0) + 1
        in_phase = held & is_phase
        phase = names[int(np.argmax(in_phase))] if in_phase.any() else OUTSIDE
        phase_s[phase] = phase_s.get(phase, 0.0) + k["dur"] / 1e6
        phase_kernels[phase] = phase_kernels.get(phase, 0) + 1
    wall: Dict[str, float] = {}
    for n, a, b in mapped:
        wall[n] = wall.get(n, 0.0) + (b - a) / 1e6
    return {
        "idle_s": sum(b - a for a, b in idle) / 1e6,
        "idle_s_by_phase": {p: v / 1e6 for p, v in idle_by.items()},
        "device_s_by_span": device_s,
        "kind_s_by_span": kind_s,
        "kernels_by_span": kernels_by,
        "device_s_by_phase": phase_s,
        "kernels_by_phase": phase_kernels,
        "span_wall_s": wall,
        "kernels": len(kernels),
        "kernels_launched": launched,
        "kernel_s": sum(k["dur"] for k in kernels) / 1e6,
    }


# -- what the per-layer metrics would read from a run's record ---------------

def phase_idle_ms(run: dict, phase: str) -> Optional[float]:
    """Device idle ms per traced step under ``phase`` (a training run)."""
    t = run.get("trace") or {}
    ph = t.get("phases")
    if run.get("kind") != "train" or not ph:
        return None
    return 1e3 * ph["idle_s_by_phase"][phase] / t["calls"]


def span_device_ms(run: dict, span: str, kind: str) -> Optional[float]:
    """Device ms per traced call of the kernels launched under ``span`` (a
    run of ``kind``); None where no kernel could be joined to its launch."""
    t = run.get("trace") or {}
    ph = t.get("phases")
    if run.get("kind") != kind or not ph or not ph["kernels_launched"]:
        return None
    return 1e3 * ph["device_s_by_span"].get(span, 0.0) / t["calls"]


# -- measuring a cell on the card ----------------------------------------------

def _timed(fn: Callable[[int], None], calls: int, sync: Callable[[], None]) -> float:
    """Host seconds per call of ``calls`` calls, synchronised at the end."""
    sync()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    sync()
    return (time.perf_counter() - t0) / calls


def measure(name: str, seed: int) -> dict:
    """One cell on the card: set-up and warm-up as the benchmark makes them;
    the tracer's cost untraced and under the device-only trace (off, on, on,
    off); the split of each traced pass with spans on; the benchmark's
    readers on the traced passes with spans off and on."""
    from avr_torch.ops import _build
    from benchmark import harness

    prof_mod = tracer()
    c = harness.cell(name)
    traffic = c["traffic_file"]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    _build.build_all()
    torch.cuda.set_device(device)
    session = driver.Session(c["config_file"]["config"], traffic, seed, device)
    session.warm_up()
    session.traced = []
    calls = int(c["cell_file"]["trace_calls"])
    per_layer = [x["name"] for x in harness.metrics_of(name, harness.manifest(), True)
                 if not x["name"].startswith("mfu")]  # mfu reads the window, not the trace

    def call(i: int) -> None:
        session.traced_call(i)

    untraced = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 3:
        if mode == "on":
            prof_mod.enable()
        untraced[mode].append(_timed(call, max(calls, 5), sync))
        prof_mod.disable()
        prof_mod.drain()
    passes = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        session.traced = []
        trace, wall, recorded, counts = _profile(call, calls, spans=mode == "on")
        events = trace["traceEvents"]
        summary = devtrace.reduce(events, calls)
        entry = {"wall_s_per_call": wall / calls, "trace_span_s": summary.get("span_s"),
                 **{k: summary.get(k) for k in ("device_ops", "kernels", "busy_s", "kernel_s_by_kind")}}
        if summary["device_ops"]:
            summary["span_s"] = wall  # as devtrace.capture gives it
        ph = split(events, recorded, int(trace["baseTimeNanoseconds"])) if mode == "on" else {}
        summary["phases"] = {**ph, "counts": counts} if ph else None
        summary["work"] = session.work()
        run = {"kind": session.kind, "trace": summary}
        entry["readers"] = {m: harness.reader(m)(run) for m in per_layer}
        if mode == "on":
            entry.update(spans=len(recorded), counts=counts, phases=summary["phases"], new_metrics={
                **{f"{p}_idle_ms": phase_idle_ms(run, p) for p in PHASES + (OUTSIDE,)},
                "signal_device_ms": span_device_ms(run, "render.chunk", session.kind),
                "attenuation_device_ms": span_device_ms(run, "render.attenuation", session.kind),
                "context_device_ms": span_device_ms(run, "render.context", session.kind),
            })
        passes[mode].append(entry)
    session.release()
    return {"cell": name, "seed": seed, "calls": calls,
            "device": torch.cuda.get_device_name(device),
            "untraced_s_per_call": untraced, "traced": passes}


def probe() -> dict:
    """On the card: does a device-only trace hold a launch event for every
    kernel, and does a span around a ``torch.cuda._sleep`` hold its launch
    once ``baseTimeNanoseconds`` is subtracted?"""
    prof_mod = tracer()
    x = torch.ones(1 << 20, device="cuda")

    def fn(i: int) -> None:
        with prof_mod.span("sleep"):
            torch.cuda._sleep(1_000_000)  # launches spin_kernel
        (x * 2).sum()

    fn(0)
    trace, _, recorded, _ = _profile(fn, 3, spans=True)
    base = int(trace["baseTimeNanoseconds"])
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    sleeps = [k for k in kernels if "spin_kernel" in k["name"]]
    spans = _on_trace([s for s in recorded if s["name"] == "sleep"], base)
    held = []
    for k in sleeps:
        t = launch.get(k["args"].get("correlation"))
        held.append(t is not None and any(a <= t["ts"] <= b for _, a, b in spans))
    cost = {}
    for mode in ("off", "on", "off", "on"):
        (prof_mod.enable if mode == "on" else prof_mod.disable)()
        t0 = time.perf_counter()
        for _ in range(20_000):
            with prof_mod.span("empty"):
                pass
        cost.setdefault(mode, []).append((time.perf_counter() - t0) / 20_000 * 1e6)
        prof_mod.disable()
        prof_mod.drain()
    return {"device": torch.cuda.get_device_name(0), "span_us": cost, "kernels": len(kernels),
            "kernels_with_launch": sum(k.get("args", {}).get("correlation") in launch for k in kernels),
            "launch_names": sorted({launch[k["args"]["correlation"]]["name"] for k in kernels
                                    if k.get("args", {}).get("correlation") in launch}),
            "sleep_kernels": len(sleeps), "sleep_spans": len(spans), "sleep_launch_in_span": held}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--probe", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 2
    if tracer() is None:
        print("benchmark.spans: the program has no tracer", file=sys.stderr)
        return 2
    result = probe() if args.probe else measure(args.workload, args.seed)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
