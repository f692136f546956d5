"""Spans, counters and memory observability (port of ``avr_tpu/utils/profiling.py``).

  * ``span(name)`` — a named interval of host time around a phase of the
    work, recorded only while the tracer is on (``enable``/``disable``);
  * ``count(name, n)`` — always-on integer counters in one registry;
  * ``drain()`` — the spans recorded and the counters, both cleared;
  * ``device_memory_stats()`` — per-CUDA-device allocated, peak, reserved
    and total memory, from ``torch.cuda.memory_stats``;
  * ``log_memory(tag)`` — the reference's log_gpu_memory equivalent;
  * ``memory_snapshot(path)`` — JSON dump of the per-device stats and the
    largest live CUDA tensors (the memory_check runner's snapshot).

A span is kept on ``time.time_ns()``: the clock of ``torch.profiler``'s
chrome trace, whose ``ts`` is (time_ns − ``baseTimeNanoseconds``) / 1000,
so spans land on a device trace recorded without host operations. Off (the
default) ``span`` checks one module flag and returns a shared no-op, so it
stays on the hot path; a ``torch.profiler`` annotation costs tens of times
more even with no profiler running. On, each span records its name,
start and end, the thread's native id, its parent (the innermost span still
open on the same thread) and its call: the outermost span open on any
thread when it opened, itself when none was, so the spans that autograd's
device threads open during a backward share the call of the step that runs
it.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

_on = False
_spans: List["_Span"] = []
_ids = itertools.count()
_local = threading.local()  # .stack: the spans open on this thread, innermost last; .tid
_calls: List["_Span"] = []  # the outermost spans open, on any thread
_counts: Dict[str, int] = defaultdict(int)


def _forget_thread() -> None:
    """In a forked child: its thread has another id and no span open."""
    vars(_local).clear()


os.register_at_fork(after_in_child=_forget_thread)


class _Span:
    __slots__ = ("name", "id", "start_ns", "end_ns", "tid", "parent", "call")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()  # a system call: once per thread
        self.id = next(_ids)
        self.tid = _local.tid
        self.parent = stack[-1].id if stack else None
        if stack:
            self.call = stack[-1].call
        elif _calls:
            self.call = _calls[-1].call
        else:
            self.call = self.id
            _calls.append(self)
        stack.append(self)
        _spans.append(self)
        self.end_ns = None
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _local.stack.pop()
        if _calls and _calls[-1] is self:
            _calls.pop()
        return False

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager timing the block as span ``name`` while the tracer
    is on; a shared no-op while it is off."""
    return _Span(name) if _on else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (on or off)."""
    _counts[name] += n


def counters() -> Dict[str, int]:
    """The counters as they stand, without clearing them."""
    return dict(_counts)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Tuple[List[dict], Dict[str, int]]:
    """The spans recorded since the last drain, in order of their start,
    each a dict (``name``, ``id``, ``start_ns``, ``end_ns``, ``tid``,
    ``parent``, ``call``; ``end_ns`` None while open), and the counters;
    both are cleared."""
    spans = [s.as_dict() for s in _spans]
    _spans.clear()
    counts = dict(_counts)
    _counts.clear()
    return spans, counts


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory stats in MB, under the JAX package's key names;
    empty when there is no CUDA device."""
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0) / 1e6,
            "bytes_reserved": s.get("reserved_bytes.all.current", 0) / 1e6,
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory / 1e6,
        }
    return out


def log_memory(tag: str = "", logger=None) -> str:
    """One-line device memory report (reference/renderer.py:5-10 analog)."""
    parts = [
        f"{dev}: in_use={s['bytes_in_use']:.1f}MB peak={s['peak_bytes_in_use']:.1f}MB "
        f"reserved={s['bytes_reserved']:.1f}MB limit={s['bytes_limit']:.0f}MB"
        for dev, s in device_memory_stats().items()
    ]
    msg = f"[{tag}] " + "; ".join(parts) if parts else f"[{tag}] (no memory stats)"
    if logger is not None:
        logger.info(msg)
    return msg


def live_tensors_summary(top_k: int = 20):
    """Largest live CUDA tensors: [(shape, dtype, MB)], descending."""
    rows = []
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            rows.append((str(tuple(obj.shape)), str(obj.dtype), obj.element_size() * obj.nelement() / 1e6))
    rows.sort(key=lambda r: -r[2])
    return rows[:top_k]


def memory_snapshot(path: Optional[str] = None) -> Dict:
    """JSON-able snapshot: per-device stats + biggest live CUDA tensors
    (reference/avr_runner_memory_check.py:33-40 analog)."""
    snap = {
        "ts": time.time(),
        "devices": device_memory_stats(),
        "largest_live_arrays": [
            {"shape": s, "dtype": d, "mb": round(mb, 2)} for s, d, mb in live_tensors_summary()
        ],
    }
    if path:
        with open(path, "w") as f:
            json.dump(snap, f, indent=2)
    return snap
