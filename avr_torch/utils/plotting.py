"""The runner's per-sample validation figure (host-side matplotlib): a copy
of ``plot_prediction_figure`` from ``avr_tpu/utils/plotting.py``, after
reference/utils/logger.py:89-124. The report figures of that module are
not ported yet. Importing this module needs matplotlib; the runner
imports it only when it draws.
"""

from __future__ import annotations

import os

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
