"""Profiling and memory observability (port of ``avr_tpu/utils/profiling.py``).

  * ``device_memory_stats()`` — per-CUDA-device allocated, peak, reserved
    and total memory, from ``torch.cuda.memory_stats``;
  * ``log_memory(tag)`` — the reference's log_gpu_memory equivalent;
  * ``memory_snapshot(path)`` — JSON dump of the per-device stats and the
    largest live CUDA tensors (the memory_check runner's snapshot);
  * ``trace(logdir)`` — context manager around ``torch.profiler`` writing a
    chrome trace of host and device activity;
  * ``annotate(name)`` — named profiler span for phase attribution.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where there
    is a device) and write ``trace.json`` (chrome/Perfetto) and
    ``kernels.txt`` (time by op) into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


def annotate(name: str):
    """Named span inside a trace."""
    return torch.profiler.record_function(name)
