"""Room-acoustics evaluation metrics (host-side numpy); port of
``avr_tpu/metrics.py``, whose numpy functions are copied as they are.

Port of reference/utils/metric.py semantics: FFT phase error, smoothed
amplitude error, Hilbert-envelope error, T60/EDT from the backward energy
integral, C50 clarity, and a 3-resolution STFT metric. These run on
validation outputs on the host (like the reference, which computes them
in numpy on CPU — avr_runner.py:260), so numpy/scipy are fine here.
The 3-resolution STFT metric runs the port's loss on CPU fp32 tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from avr_torch.losses import MRSTFT_METRIC, multi_resolution_stft_loss


class IRMetrics(NamedTuple):
    angle_error: float
    amp_error: float
    env_error: float
    t60_error: float
    edt_error: float
    c50_error: float
    multi_stft: float

    def as_dict(self) -> Dict[str, float]:
        return dict(zip(self._fields, self))


def _hilbert_envelope(x: np.ndarray) -> np.ndarray:
    """|analytic signal| via the FFT one-sided spectrum doubling."""
    n = x.shape[-1]
    Xf = np.fft.fft(x, axis=-1)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    return np.abs(np.fft.ifft(Xf * h, axis=-1))


def _box_smooth(x: np.ndarray, window: int) -> np.ndarray:
    """scipy.ndimage.convolve1d(x, ones(window)) semantics: 'reflect'
    boundary, origin at the window center (reference/utils/metric.py:38)."""
    # ndimage's convolution origin for even-length kernels sits one sample
    # right of the naive center: out[i] covers x[i−(w−1)//2 .. i+w//2].
    pad_left = (window - 1) // 2
    pad_right = window // 2
    # ndimage "reflect" duplicates the edge sample == np.pad "symmetric".
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)], mode="symmetric")
    kernel = np.ones(window)
    out = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="valid"), -1, xp)
    return out


def t60_edt(
    energy_db: np.ndarray, init_db=-5.0, end_db=-25.0, factor=3.0, fs=48000
) -> Tuple[np.ndarray, np.ndarray]:
    """T60 (−5→−25 dB fit ×3) and EDT (−10 dB time ×6) per row.

    (reference/utils/metric.py:77-136; least-squares fit over the samples
    between the nearest-to-init and nearest-to-end dB points.)
    """
    t60_all, edt_all = [], []
    for energy in energy_db:
        n10 = int(np.abs(energy - (-10.0)).argmin())
        edt_all.append(n10 / fs * 6.0)

        init_sample = int(np.abs(energy - init_db).argmin())
        end_sample = int(np.abs(energy - end_db).argmin())
        lo, hi = min(init_sample, end_sample), max(init_sample, end_sample)
        x = np.arange(lo, hi + 1) / fs
        y = energy[lo : hi + 1]
        if len(x) < 2 or np.ptp(x) == 0:
            t60_all.append(np.nan)
            continue
        slope, intercept = np.polyfit(x, y, 1)
        if slope == 0:
            t60_all.append(np.nan)
            continue
        t60_all.append(factor * ((end_db - intercept) / slope - (init_db - intercept) / slope))
    return np.asarray(t60_all), np.asarray(edt_all)


def backward_energy_db(ir: np.ndarray) -> np.ndarray:
    """Schroeder-style backward integral, 0 dB at t=0
    (reference/utils/metric.py:48-52)."""
    e = 10.0 * np.log10(np.cumsum(ir[:, ::-1] ** 2 + 1e-9, axis=-1)[:, ::-1])
    return e - e[:, :1]


def metric_cal(ori_ir: np.ndarray, pred_ir: np.ndarray, fs=48000, window=32) -> IRMetrics:
    """Full metric bundle for (batched) time-domain IRs.

    Mirrors reference/utils/metric.py:8-74 (the reference additionally
    returns the raw energy curves; call backward_energy_db for those).
    """
    ori_ir = np.atleast_2d(np.asarray(ori_ir, np.float64))
    pred_ir = np.atleast_2d(np.asarray(pred_ir, np.float64))

    multi_stft = float(
        multi_resolution_stft_loss(
            torch.as_tensor(ori_ir[:, None, :], dtype=torch.float32),
            torch.as_tensor(pred_ir[:, None, :], dtype=torch.float32),
            MRSTFT_METRIC,
        )
    )

    fft_ori = np.fft.fft(ori_ir, axis=-1)
    fft_pred = np.fft.fft(pred_ir, axis=-1)
    ang_o, ang_p = np.angle(fft_ori), np.angle(fft_pred)
    angle_error = float(
        np.mean(np.abs(np.cos(ang_o) - np.cos(ang_p)))
        + np.mean(np.abs(np.sin(ang_o) - np.sin(ang_p)))
    )

    amp_ori = _box_smooth(np.abs(fft_ori), window)
    amp_pred = _box_smooth(np.abs(fft_pred), window)
    amp_error = float(np.mean(np.abs(amp_ori - amp_pred) / amp_ori))

    ori_env = _hilbert_envelope(ori_ir)
    pred_env = _hilbert_envelope(pred_ir)
    env_error = float(
        np.mean(np.abs(ori_env - pred_env) / np.max(ori_env, axis=1, keepdims=True))
    )

    ori_energy = backward_energy_db(ori_ir)
    pred_energy = backward_energy_db(pred_ir)
    ori_t60, ori_edt = t60_edt(ori_energy, fs=fs)
    pred_t60, pred_edt = t60_edt(pred_energy, fs=fs)
    t60_error = float(np.nanmean(np.abs(ori_t60 - pred_t60) / ori_t60))
    edt_error = float(np.nanmean(np.abs(ori_edt - pred_edt)))

    s50 = int(0.05 * fs)
    e_oe = np.sum(ori_ir[:, :s50] ** 2, axis=-1)
    e_ol = np.sum(ori_ir[:, s50:] ** 2, axis=-1)
    e_pe = np.sum(pred_ir[:, :s50] ** 2, axis=-1)
    e_pl = np.sum(pred_ir[:, s50:] ** 2, axis=-1)
    c50_error = float(
        np.mean(np.abs(10 * np.log10(e_oe / e_ol) - 10 * np.log10(e_pe / e_pl)))
    )

    return IRMetrics(
        angle_error, amp_error, env_error, t60_error, edt_error, c50_error, multi_stft
    )
