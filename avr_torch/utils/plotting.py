"""Figure generation for validation and reporting (host-side matplotlib;
a copy of ``avr_tpu/utils/plotting.py``, no repair). Importing this module
needs matplotlib; the runner imports it only when it draws.

Mirrors reference/utils/logger.py:45-124 (per-sample 6-panel prediction
figure + annotated energy figure) and the report scripts' aggregations
(plot_loss.py — loss-curve sums by tag prefix; plot_eval.py:268-473 —
loss + per-checkpoint DoA error panels). All functions take numpy data
and write PNGs; the metrics source is the runner's metrics.jsonl (or a
TensorBoard event dir when tensorboardX wrote one).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_prediction_figure(
    pred_sig: np.ndarray,
    ori_sig: np.ndarray,
    pred_time: np.ndarray,
    ori_time: np.ndarray,
    position_rx: np.ndarray,
    position_tx: np.ndarray,
    mode_set: str,
    save_path: str,
) -> None:
    """6 panels: real/imag spectra, waveform, geometry, |·|, phase
    (reference/utils/logger.py:89-124)."""
    pred_sig = np.asarray(pred_sig).flatten()
    ori_sig = np.asarray(ori_sig).flatten()
    fig = plt.figure(figsize=(16, 12))
    plt.suptitle(f"{mode_set} set")
    panels = [
        (231, "Real", np.real(pred_sig), np.real(ori_sig)),
        (234, "Imaginary", np.imag(pred_sig), np.imag(ori_sig)),
        (232, "Waveform", np.asarray(pred_time).flatten(), np.asarray(ori_time).flatten()),
        (233, "Magnitude", np.abs(pred_sig), np.abs(ori_sig)),
        (236, "Phase", np.angle(pred_sig), np.angle(ori_sig)),
    ]
    for pos, title, p, o in panels:
        plt.subplot(pos)
        plt.title(title)
        plt.plot(p)
        plt.plot(o, alpha=0.5)
        if title == "Magnitude":
            plt.ylim(0)
    plt.subplot(235)
    plt.title("Geometry")
    plt.scatter(position_rx[0], position_rx[1], c="b", label="rx")
    plt.scatter(position_tx[0], position_tx[1], c="r", label="tx")
    plt.legend()
    plt.grid(True)
    plt.axis("equal")
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close(fig)


def plot_inference_figure(
    ori_time_sig: np.ndarray,
    pred_time_sig: np.ndarray,
    metrics: Dict[str, float],
    save_path: Optional[str] = None,
) -> None:
    """Waveform overlay with the metric annotations
    (reference/utils/logger.py:45-86)."""
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(ori_time_sig, c="b")
    ax.plot(pred_time_sig, c="r", alpha=0.8)
    lim = float(np.max(np.abs(ori_time_sig))) or 1.0
    ax.set_ylim(-lim, lim)
    ax.set_xticks([])
    ax.set_yticks([])
    lines = [
        ("Angle err", metrics.get("Angle"), "{:.2f}"),
        ("Amp. err", metrics.get("Amplitude"), "{:.3f}"),
        ("Env. err", metrics.get("Envelope"), "{:.3f}"),
        ("T60 err", None if metrics.get("T60") is None else metrics["T60"] * 100, "{:.2f}%"),
        ("C50 err", metrics.get("C50"), "{:.2f} db"),
        ("EDT err", metrics.get("EDT"), "{:.3f} s"),
    ]
    y = 0.40
    for label, val, fmt in lines:
        if val is not None:
            ax.text(0.65, y, f"{label}: {fmt.format(val)}",
                    transform=ax.transAxes, fontsize=18, verticalalignment="top")
        y -= 0.06
    plt.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path, dpi=150, pad_inches=0)
    plt.close(fig)


# ----------------------------------------------------------------------
# metrics.jsonl readers + report figures
# ----------------------------------------------------------------------
def read_metrics_jsonl(path: str) -> Dict[str, List[Tuple[int, float]]]:
    """tag → [(step, value), ...] sorted by step."""
    out: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            out[d["tag"]].append((int(d["step"]), float(d["value"])))
    return {k: sorted(v) for k, v in out.items()}


def sum_curves_by_prefix(
    curves: Dict[str, List[Tuple[int, float]]], prefix: str
) -> List[Tuple[int, float]]:
    """Sum all curves whose tag starts with prefix, aligned on step
    (reference/plot_loss.py:13-35 sums loss tags by prefix)."""
    acc: Dict[int, float] = defaultdict(float)
    for tag, pts in curves.items():
        if tag.startswith(prefix):
            for step, v in pts:
                acc[step] += v
    return sorted(acc.items())


def _load_curves(metrics_source: str) -> Dict[str, List[Tuple[int, float]]]:
    """metrics.jsonl path, tfevents path, or logdir → tag curves
    (reference logdirs carry only TB event files; see utils/tb_events)."""
    from avr_torch.utils.tb_events import read_scalar_curves

    return read_scalar_curves(metrics_source)


def plot_loss_curves(
    metrics_source: str, save_path: str, prefixes: Sequence[str] = ("train_loss",)
) -> None:
    curves = _load_curves(metrics_source)
    fig, ax = plt.subplots(figsize=(10, 6))
    for prefix in prefixes:
        pts = (
            curves.get(prefix)
            if prefix in curves
            else sum_curves_by_prefix(curves, prefix)
        )
        if pts:
            steps, vals = zip(*pts)
            ax.plot(steps, vals, label=prefix)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_loss_by_epoch(
    log_path: str,
    save_path: str,
    train_prefix: str = "train_loss/",
    test_prefix: str = "test_loss/",
) -> None:
    """Train/test loss sums vs epoch — reference/plot_loss.py:13-49
    exactly: per-prefix scalar tags are summed per step, steps are
    normalized to epochs by the first logged step, one blue train curve
    and one orange test curve. Works over TB event files (including the
    reference's own logdirs) or metrics.jsonl."""
    from avr_torch.utils.tb_events import accumulate_tags

    curves = _load_curves(log_path)
    train_acc = accumulate_tags(curves, train_prefix)
    # our writer logs per-term train losses under train_loss_terms/
    if not train_acc and train_prefix == "train_loss/":
        train_acc = accumulate_tags(curves, "train_loss_terms/")
    test_acc = accumulate_tags(curves, test_prefix)
    if not train_acc:
        raise ValueError(f"no scalars under {train_prefix!r} in {log_path}")
    train_steps, train_values = zip(*sorted(train_acc.items()))
    first_step = min(train_steps) or 1
    fig = plt.figure(figsize=(10, 5))
    plt.plot([s / first_step for s in train_steps], train_values,
             label="Train Loss", color="blue")
    if test_acc:
        test_steps, test_values = zip(*sorted(test_acc.items()))
        plt.plot([s / first_step for s in test_steps], test_values,
                 label="Test Loss", color="orange")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title("Train/Test Loss over Epochs")
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close(fig)


def plot_loss_and_doa(
    metrics_source: str,
    doa_errors_by_iter: Dict[int, float],
    save_path: str,
    loss_prefixes: Sequence[str] = ("train_loss", "test_loss/"),
) -> None:
    """Loss curves + per-checkpoint DoA error in one figure
    (reference/plot_eval.py:268-473)."""
    curves = _load_curves(metrics_source)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 9), sharex=True)
    for prefix in loss_prefixes:
        pts = (
            curves.get(prefix)
            if prefix in curves
            else sum_curves_by_prefix(curves, prefix)
        )
        if pts:
            steps, vals = zip(*pts)
            ax1.plot(steps, vals, label=prefix)
    ax1.set_yscale("log")
    ax1.set_ylabel("loss")
    ax1.legend()
    ax1.grid(True, alpha=0.3)
    if doa_errors_by_iter:
        its = sorted(doa_errors_by_iter)
        ax2.plot(its, [doa_errors_by_iter[i] for i in its], "o-")
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("mean DoA error (deg)")
    ax2.grid(True, alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_doa_scatter(
    results: Dict[str, Dict[str, list]], save_path: str, error_key: str = "pred_vs_gt_error"
) -> None:
    """Per-algorithm error scatter/box summary
    (reference/plot_DoA_detail_scatter.py family)."""
    algos = [a for a in results if any(e is not None for e in results[a][error_key])]
    fig, ax = plt.subplots(figsize=(2 + 1.5 * max(len(algos), 1), 6))
    data, labels = [], []
    for a in algos:
        errs = [e for e in results[a][error_key] if e is not None]
        if errs:
            data.append(errs)
            labels.append(a)
    if data:
        ax.boxplot(data, tick_labels=labels)
        for i, errs in enumerate(data):
            ax.scatter(np.full(len(errs), i + 1) + np.random.uniform(-0.1, 0.1, len(errs)),
                       errs, alpha=0.5, s=12)
    ax.set_ylabel(f"{error_key} (deg)")
    ax.grid(True, axis="y", alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150)
    plt.close(fig)
