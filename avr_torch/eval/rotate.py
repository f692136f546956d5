"""Rotation-sweep DoA evaluation of a trained field (port of
``avr_tpu/eval/rotate.py``: ``rotate_group_eval`` is numpy and copied as
it is; ``make_render_fn`` renders through the port's runner).

Re-design of reference/eval_rotate_doa_avr.py:64-239: each 8-microphone
group of the eval set is rigidly rotated about its transmitter's xy
position in `deg_step` increments; every in-bounds rotation is re-rendered
with the trained model, NormMUSIC estimates the arrival direction, and the
per-group mean angular error is reported (CSV) along with a flat npz of
all rendered spectra (same keys as the reference dump).

Deltas from the reference: all 8 microphones of a rotation render in ONE batched
call (the reference loops a bs=1 render per mic), and rotations are
batched up to `rotations_per_batch` at a time.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from avr_torch.eval import doa as doa_lib


def rotate_group_eval(
    render_fn,
    dataset,
    xyz_min,
    xyz_max,
    fs: int,
    seq_len: int,
    deg_step: float = 30.0,
    group_size: int = 8,
    n_fft: int = 512,
    mic_radius: float = 0.0365,
    out_dir: Optional[str] = None,
    algo: str = "NormMUSIC",
) -> Dict[str, np.ndarray]:
    """Run the rotation sweep.

    render_fn(pos_rx [B,3], pos_tx [B,3], ch_idx [B] or None) →
    complex64 [B, F] rendered spectra (batched; the runner provides one).
    dataset: a loaders.Dataset eval split with group-ordered rows.
    Returns the flat result dict (also written to disk when out_dir set).
    """
    xyz_min = np.asarray(xyz_min, np.float32)
    xyz_max = np.asarray(xyz_max, np.float32)
    deltas = [k * deg_step for k in range(int(360 // deg_step))]

    summary_lines = ["unit_id,used_rotations,mean_err_deg\n"]
    flat_spec, flat_rx, flat_tx = [], [], []
    all_pred, all_true = [], []

    n_groups = len(dataset) // group_size
    for g in range(n_groups):
        idx = np.arange(g * group_size, (g + 1) * group_size)
        rx = dataset.pos_rx[idx].astype(np.float64)
        tx0 = dataset.pos_tx[idx][0].astype(np.float64)
        ch = dataset.ch_idx[idx] if dataset.ch_idx is not None else None
        tx_xy = tx0[:2]

        radii = np.linalg.norm(rx[:, :2] - tx_xy, axis=1)
        theta0 = np.degrees(np.arctan2(rx[:, 1] - tx_xy[1], rx[:, 0] - tx_xy[0])) % 360

        used, pred_deg, true_deg = [], [], []
        for d in deltas:
            ang = np.deg2rad((theta0 + d) % 360)
            rot = np.stack(
                [
                    tx_xy[0] + radii * np.cos(ang),
                    tx_xy[1] + radii * np.sin(ang),
                    rx[:, 2],
                ],
                axis=1,
            ).astype(np.float32)
            if not np.all((rot >= xyz_min) & (rot <= xyz_max)):
                continue
            used.append(d)

            spec = np.asarray(
                render_fn(rot, np.tile(tx0[None, :].astype(np.float32), (group_size, 1)), ch)
            ).astype(np.complex64)  # [M, F]
            time_sig = np.fft.irfft(spec, n=seq_len, axis=-1).real
            X = doa_lib.stft_frames(time_sig, n_fft)

            mic_center = rot[:, :2].mean(axis=0)
            mic_xy = doa_lib.circular_2d_array(mic_center, group_size, mic_radius)
            sp = doa_lib.doa_spectrum(X, mic_xy, fs, n_fft, algo)
            pred_deg.append(int(doa_lib.estimate_azimuth_deg(sp)) % 360)
            true_deg.append(
                int(
                    math.degrees(
                        math.atan2(tx0[1] - mic_center[1], tx0[0] - mic_center[0])
                    )
                    % 360
                )
            )
            flat_spec.extend(spec)
            flat_rx.extend(rot)
            flat_tx.extend([tx0.astype(np.float32)] * group_size)

        if used:
            errs = [doa_lib.angular_error_deg(p, t) for p, t in zip(pred_deg, true_deg)]
            summary_lines.append(f"{g},{len(used)},{float(np.mean(errs)):.4f}\n")
            all_pred.extend(pred_deg)
            all_true.extend(true_deg)
        else:
            summary_lines.append(f"{g},0,NaN\n")

    result = {
        "pred_sig": np.stack(flat_spec) if flat_spec else np.zeros((0, 1), np.complex64),
        "position_rx": np.stack(flat_rx) if flat_rx else np.zeros((0, 3), np.float32),
        "position_tx": np.stack(flat_tx) if flat_tx else np.zeros((0, 3), np.float32),
        "pred_deg": np.asarray(all_pred, np.int16),
        "true_deg": np.asarray(all_true, np.int16),
        "fs": np.int32(fs),
        "n_fft": np.int32(n_fft),
        "mic_radius": np.float32(mic_radius),
        "group_size": np.int32(group_size),
        "deg_step": np.float32(deg_step),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(os.path.join(out_dir, "val_rotate_pred.npz"), **result)
        with open(os.path.join(out_dir, "summary.csv"), "w") as f:
            f.writelines(summary_lines)
        errs = [
            doa_lib.angular_error_deg(p, t) for p, t in zip(all_pred, all_true)
        ]
        with open(os.path.join(out_dir, "overall.txt"), "w") as f:
            f.write(
                f"n_rotations={len(errs)} mean_err_deg="
                f"{float(np.mean(errs)) if errs else float('nan'):.4f}\n"
            )
    return result


def make_render_fn(runner, dirs=None):
    """Batched spectra renderer from a trained AVRRunner: the fixed eval
    directions (or ``dirs`` [R, 3]), no gradients, complex64 [B, F] out."""
    if dirs is None:
        dirs = runner.eval_directions()
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=runner.device)

    def render_fn(pos_rx, pos_tx, ch_idx=None, rot_tx=None):
        batch = {"pos_rx": np.asarray(pos_rx, np.float32), "pos_tx": np.asarray(pos_tx, np.float32)}
        if ch_idx is not None:
            batch["ch_idx"] = np.asarray(ch_idx, np.int32)
        if rot_tx is not None:
            batch["rot_tx"] = np.asarray(rot_tx, np.float32)
        return runner.render_batch(batch, dirs)

    return render_fn
