"""The program's spans on a hand-made device trace: idle split by phase
with ``outside`` for the rest, device time given to the shortest span that
holds the launch, the readers, and the span clock on a CPU profiler pass."""

from __future__ import annotations

import pytest
import torch

from benchmark import devtrace, spans

BASE = 1_000_000_000  # baseTimeNanoseconds of the hand-made trace


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, a_us, b_us, sid, parent=None, tid=1):
    return {"name": name, "id": sid, "start_ns": BASE + int(a_us * 1e3), "end_ns": BASE + int(b_us * 1e3),
            "tid": tid, "parent": parent, "call": 0}


# one step of 100 µs: render 0–40 (a chunk 10–30), criterion 40–50,
# backward 50–80 (a recompute chunk 55–65 on another thread), optimizer 80–95
SPANS = [
    _span("step", 0, 100, 0),
    _span("render", 0, 40, 1, 0),
    _span("render.signal", 8, 40, 2, 1),
    _span("render.chunk", 10, 30, 3, 2),
    _span("criterion", 40, 50, 4, 0),
    _span("backward", 50, 80, 5, 0),
    _span("render.chunk", 55, 65, 6, None, tid=2),
    _span("optimizer", 80, 95, 7, 0),
]
EVENTS = [
    _x(devtrace.SPAN, "user_annotation", 0.0, 100.0),
    _x("cudaLaunchKernel", "cuda_runtime", 5.0, 1.0, corr=1),   # render, outside the chunk
    _x("cudaLaunchKernel", "cuda_runtime", 12.0, 1.0, corr=2),  # the chunk
    _x("cudaLaunchKernel", "cuda_runtime", 58.0, 1.0, corr=3),  # the recompute, inside backward
    _x("cudaLaunchKernel", "cuda_runtime", 70.0, 1.0, corr=4),  # backward itself
    _x("cudaLaunchKernel", "cuda_runtime", 85.0, 1.0, corr=5),  # optimizer
    _x("cudaLaunchKernel", "cuda_runtime", 97.0, 1.0, corr=6),  # in the step, in no phase
    _x("elementwise_kernel", "kernel", 6.0, 4.0, corr=1),       # 6–10
    _x("elementwise_kernel", "kernel", 14.0, 20.0, corr=2),     # 14–34
    _x("elementwise_kernel", "kernel", 60.0, 10.0, corr=3),     # 60–70
    _x("nvjet_tst", "kernel", 70.0, 5.0, corr=4),               # 70–75
    _x("vectorized_elementwise_kernel", "kernel", 86.0, 4.0, corr=5),  # 86–90
    _x("reduce_kernel", "kernel", 97.5, 1.5, corr=6),           # 97.5–99
    _x("Memset (Device)", "gpu_memset", 45.0, 2.0),             # 45–47, no launch joined
    _x("elementwise_kernel", "kernel", 99.0, 1.0, corr=99),     # 99–100, its launch missing
]


def test_idle_split_by_phase_adds_up_to_the_trace_idle():
    s = spans.split(EVENTS, SPANS, BASE)
    t = devtrace.reduce(EVENTS, calls=1)
    # busy: 6–10, 14–34, 45–47, 60–75, 86–90, 97.5–100 → 47.5 µs of 100
    assert t["busy_s"] == pytest.approx(47.5e-6)
    assert s["idle_s"] == pytest.approx(t["span_s"] - t["busy_s"])
    idle = {k: round(v * 1e6, 6) for k, v in s["idle_s_by_phase"].items()}
    # render 0–6, 10–14, 34–40; criterion 40–45, 47–50; backward 50–60, 75–80;
    # optimizer 80–86, 90–95; outside 95–97.5
    assert idle == {"render": 16.0, "criterion": 8.0, "backward": 15.0, "optimizer": 11.0, "outside": 2.5}
    assert sum(s["idle_s_by_phase"].values()) == pytest.approx(s["idle_s"])


def test_device_time_goes_to_the_shortest_span_holding_the_launch():
    s = spans.split(EVENTS, SPANS, BASE)
    us = {k: round(v * 1e6, 6) for k, v in s["device_s_by_span"].items()}
    # the recompute kernel goes to render.chunk (shorter than backward, another thread)
    assert us == {"render": 4.0, "render.chunk": 30.0, "backward": 5.0, "optimizer": 4.0, "step": 1.5}
    assert s["kernels_by_span"] == {"render": 1, "render.chunk": 2, "backward": 1, "optimizer": 1, "step": 1}
    assert s["kind_s_by_span"]["render.chunk"] == pytest.approx({"elementwise": 30e-6})
    assert s["kind_s_by_span"]["backward"] == pytest.approx({"matmul": 5e-6})
    assert s["kind_s_by_span"]["step"] == pytest.approx({"reduce": 1.5e-6})
    phase = {k: round(v * 1e6, 6) for k, v in s["device_s_by_phase"].items()}
    assert phase == {"render": 24.0, "backward": 15.0, "optimizer": 4.0, "outside": 1.5}
    assert s["kernels_by_phase"] == {"render": 2, "backward": 2, "optimizer": 1, "outside": 1}
    assert s["kernels"] == 7 and s["kernels_launched"] == 6
    assert s["kernel_s"] == pytest.approx(45.5e-6)
    assert s["span_wall_s"]["render.chunk"] == pytest.approx(30e-6)
    assert s["span_wall_s"]["step"] == pytest.approx(100e-6)


def test_reduce_is_unchanged_by_the_launch_events():
    plain = [e for e in EVENTS if e["cat"] != "cuda_runtime"]
    assert devtrace.reduce(EVENTS, 1) == devtrace.reduce(plain, 1)


@pytest.mark.parametrize("kind,trials", [("train", 1), ("train", 4)], ids=["train", "pop"])
def test_readers(kind, trials):
    t = devtrace.reduce(EVENTS, calls=2)
    t["phases"] = spans.split(EVENTS, SPANS, BASE)
    run = {"kind": kind, "trace": t, "window": {"calls": 2, "seconds": 1e-4, "trials_per_call": trials}}
    assert spans.phase_idle_ms(run, "optimizer") == pytest.approx(11e-3 / 2)
    assert spans.phase_idle_ms(run, "render") == pytest.approx(16e-3 / 2)
    assert spans.span_device_ms(run, "render.chunk", "train") == pytest.approx(30e-3 / 2)
    assert spans.span_device_ms(run, "render.chunk", "render") is None
    assert spans.phase_idle_ms({**run, "kind": "render"}, "render") is None
    assert spans.span_device_ms({**run, "kind": "render"}, "render.attenuation", "render") == 0.0


def test_readers_find_nothing_without_spans_or_launches():
    t = devtrace.reduce(EVENTS, calls=1)
    t["phases"] = None
    assert spans.phase_idle_ms({"kind": "train", "trace": t}, "render") is None
    assert spans.span_device_ms({"kind": "train", "trace": t}, "render.chunk", "train") is None
    no_launch = [e for e in EVENTS if e["cat"] != "cuda_runtime"]
    t["phases"] = spans.split(no_launch, SPANS, BASE)
    assert t["phases"]["kernels_launched"] == 0
    assert spans.span_device_ms({"kind": "train", "trace": t}, "render.chunk", "train") is None
    assert spans.phase_idle_ms({"kind": "train", "trace": t}, "backward") == pytest.approx(15e-3)


def test_a_cpu_pass_records_the_programs_spans_on_the_trace_clock():
    """``_profile`` turns the program's tracer on for its pass only; each
    span, mapped by ``baseTimeNanoseconds``, holds its call's op."""
    from avr_torch.utils import profiling

    def fn(i):
        with profiling.span("work"):
            torch.ones(64, 64).sum()

    trace, wall, recorded, counts = spans._profile(fn, 2, spans=True)
    assert not profiling._on and profiling.drain() == ([], {})
    assert wall > 0 and [s["name"] for s in recorded] == ["work", "work"]
    mapped = spans._on_trace(recorded, int(trace["baseTimeNanoseconds"]))
    sums = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("name") == "aten::sum"]
    assert sums
    for e in sums:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b for _, a, b in mapped)
    _, _, off, _ = spans._profile(fn, 1, spans=False)
    assert off == []

