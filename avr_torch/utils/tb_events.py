"""TensorBoard event-file reader for the reporting layer (a copy of
``avr_tpu/utils/tb_events.py``; no repair).

The reference's report scripts consume TensorBoard event files directly
(reference/plot_loss.py:1-35, plot_eval.py:268-330,
plot_min_DoA_optuna.py:13-45 — all via
`tensorboard.backend.event_processing.event_accumulator`). This module
provides the same capability so the plotting functions can run over ANY
logdir: ones written by this repo's MetricsWriter (metrics.jsonl and/or
tensorboardX events) and ones produced by TB-only reference runs.

`read_scalar_curves` is the unified entry point: it accepts a
metrics.jsonl path, a tfevents file path, or a directory (using
metrics.jsonl when present, else the event files) and always returns the
same `{tag: [(step, value), ...]}` mapping the plot functions consume.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from typing import Dict, List, Tuple

Curves = Dict[str, List[Tuple[int, float]]]


def find_event_files(path: str) -> List[str]:
    """All tfevents files under `path` (a file, a dir, or a dir tree —
    the reference points at one file, plot_loss.py:6; tensorboardX runs
    may shard across several), sorted by mtime."""
    if os.path.isfile(path):
        return [path]
    hits = sorted(
        glob.glob(os.path.join(path, "**", "*tfevents*"), recursive=True),
        key=os.path.getmtime,
    )
    return hits


def read_tb_scalars(path: str) -> Curves:
    """tag → [(step, value), ...] from TensorBoard event file(s).

    Mirrors the reference's EventAccumulator usage (plot_loss.py:9-25):
    all scalar tags are loaded in full (size_guidance 0 = no reservoir
    subsampling) and merged across event files, sorted by step.
    """
    from tensorboard.backend.event_processing import event_accumulator

    out: Curves = defaultdict(list)
    files = find_event_files(path)
    if not files:
        raise FileNotFoundError(f"no tfevents file under {path}")
    for f in files:
        ea = event_accumulator.EventAccumulator(
            f, size_guidance={event_accumulator.SCALARS: 0}
        )
        ea.Reload()
        for tag in ea.Tags().get("scalars", []):
            for ev in ea.Scalars(tag):
                out[tag].append((int(ev.step), float(ev.value)))
    return {k: sorted(v) for k, v in out.items()}


def read_scalar_curves(path: str) -> Curves:
    """Unified scalar-curve loader: metrics.jsonl, tfevents, or logdir.

    Directories prefer metrics.jsonl (lossless, always written by
    MetricsWriter) and fall back to event files (reference-produced
    logdirs have only those).
    """
    if os.path.isdir(path):
        jsonl = os.path.join(path, "metrics.jsonl")
        if os.path.exists(jsonl):
            return _read_jsonl(jsonl)
        return read_tb_scalars(path)
    base = os.path.basename(path)
    if base.endswith(".jsonl"):
        return _read_jsonl(path)
    if "tfevents" in base:
        return read_tb_scalars(path)
    raise ValueError(
        f"{path}: expected a metrics.jsonl, a tfevents file, or a logdir"
    )


def _read_jsonl(path: str) -> Curves:
    from avr_torch.utils.plotting import read_metrics_jsonl

    return read_metrics_jsonl(path)


def accumulate_tags(curves: Curves, prefix: str, exclude_exact: bool = True) -> Dict[int, float]:
    """{step: sum over tags starting with prefix} — the reference's
    accumulate_tags (plot_loss.py:17-25; the bare aggregate tag itself,
    e.g. 'train_loss', is excluded so it isn't double-counted,
    plot_loss.py:13)."""
    acc: Dict[int, float] = defaultdict(float)
    for tag, pts in curves.items():
        if not tag.startswith(prefix):
            continue
        if exclude_exact and tag == prefix.rstrip("/"):
            continue
        for step, v in pts:
            acc[step] += v
    return dict(acc)
