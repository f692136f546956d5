"""White-noise playback DoA evaluation pipelines (a copy of
``avr_tpu/eval/whitenoise.py``: numpy and scipy, pandas inside
``run_whitenoise_eval``; no repair).

Re-design of reference/whitenoise_long_doa.py and
whitenoise_bandpass_doa.py: seeded white noise is convolved with each
8-channel predicted/GT IR group (frequency-domain convolution), STFT'd
under a grid of (nfft, hop, window) conditions, and a sliding window of
`T_use` frames is swept across the signal with a DoA estimate per window;
per-window angles are aggregated with circular statistics. The bandpass
variant additionally sweeps Butterworth-4 band edges (sosfiltfilt) and
noise lengths. Results are cached per condition as pickles (resume-safe:
existing files are reused unless force=True — the reference's
cache-keyed-by-existence contract, whitenoise_long_doa.py:259-291) and a
ranked summary CSV is produced.
"""

from __future__ import annotations

import itertools
import math
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from avr_torch.eval import doa as doa_lib


# -------------------- circular statistics --------------------
def angular_error_deg(a: float, b: float) -> float:
    return abs((a - b + 180.0) % 360.0 - 180.0)


def circ_mean_deg(angles_deg: Sequence[float]) -> Tuple[float, float]:
    """(circular mean [deg 0..360), resultant length R∈[0,1])."""
    if len(angles_deg) == 0:
        return float("nan"), 0.0
    a = np.deg2rad(np.asarray(angles_deg))
    C, S = float(np.cos(a).sum()), float(np.sin(a).sum())
    mu = (math.degrees(math.atan2(S, C)) + 360.0) % 360.0
    return mu, math.hypot(C, S) / len(angles_deg)


def circ_stats_deg(angles_deg: Sequence[float]) -> Tuple[float, float, float]:
    """(circular mean, circular variance 1−R, circular std [deg])."""
    mu, R = circ_mean_deg(angles_deg)
    std = (
        math.degrees(math.sqrt(max(0.0, -2.0 * math.log(max(R, 1e-12)))))
        if R > 0
        else float("nan")
    )
    return mu, 1.0 - R, std


# -------------------- synthesis --------------------
def convolve_noise_with_group(
    group_spec: np.ndarray, seconds: float, fs: int, seed: int
) -> np.ndarray:
    """Seeded white noise through each channel's IR: [M, F] → [M, T_long].

    FFT-based linear convolution (the reference uses scipy fftconvolve on
    the irfft'd IRs — whitenoise_long_doa.py:95-104).
    """
    rng = np.random.default_rng(seed)
    n_long = int(seconds * fs)
    noise = rng.standard_normal(n_long).astype(np.float32)
    ir = np.fft.irfft(group_spec, axis=-1).real  # [M, T_ir]
    t_ir = ir.shape[-1]
    n_out = n_long + t_ir - 1
    nfft = 1 << (n_out - 1).bit_length()
    out = np.fft.irfft(
        np.fft.rfft(noise, nfft)[None, :] * np.fft.rfft(ir, nfft, axis=-1), nfft, axis=-1
    )[:, :n_out]
    return out.astype(np.float32)


def bandpass_sos(low_hz: float, high_hz: float, fs: int, order: int = 4):
    from scipy.signal import butter

    return butter(order, [low_hz, high_hz], btype="bandpass", fs=fs, output="sos")


def apply_bandpass(x: np.ndarray, low_hz: float, high_hz: float, fs: int) -> np.ndarray:
    from scipy.signal import sosfiltfilt

    return sosfiltfilt(bandpass_sos(low_hz, high_hz, fs), x, axis=-1).astype(np.float32)


def stft_condition(y: np.ndarray, nfft: int, hop: int, win: str) -> np.ndarray:
    """[M, T] → [M, F, frames]; win ∈ {"hann", "none"}."""
    if win == "hann":
        w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(nfft) / nfft))
    else:
        w = np.ones(nfft)
    n_frames = 1 + (y.shape[-1] - nfft) // hop
    if n_frames < 1:
        raise ValueError("signal shorter than one frame")
    idx = np.arange(n_frames)[:, None] * hop + np.arange(nfft)[None, :]
    return np.fft.rfft(y[..., idx] * w, axis=-1).swapaxes(-1, -2).astype(np.complex64)


# -------------------- sliding-window DoA --------------------
def sliding_window_doa(
    X: np.ndarray,
    mic_xy: np.ndarray,
    fs: int,
    nfft: int,
    t_use: int,
    algo: str = "NormMUSIC",
    max_windows: int = 0,
    slide_hop_frames: Optional[int] = None,
) -> Tuple[List[float], int]:
    """DoA per sliding block of `t_use` STFT frames.

    Returns (list of degrees, n_windows_available). `slide_hop_frames`
    sets the window stride in frames — the reference's overlapping
    schedule `range(0, T - T_use + 1, hop)`
    (whitenoise_long_doa.py:133-155,191); None/0 means non-overlapping
    (hop = t_use, the reference default). `max_windows` <= 0 sweeps
    every window; a positive cap truncates, and the caller is expected
    to surface used-vs-available.
    """
    n_frames = X.shape[-1]
    hop = int(slide_hop_frames) if slide_hop_frames else t_use
    if n_frames < t_use:
        starts = np.empty(0, dtype=int)
    else:
        starts = np.arange(0, n_frames - t_use + 1, hop)
    n_win = len(starts)
    if max_windows > 0:
        starts = starts[:max_windows]
    out = []
    for s in starts:
        sp = doa_lib.doa_spectrum(X[..., s : s + t_use], mic_xy, fs, nfft, algo)
        out.append(doa_lib.estimate_azimuth_deg(sp))
    return out, int(n_win)


# -------------------- pipeline --------------------
@dataclass
class WhitenoiseConfig:
    """Schema of whitenoise_config/whitenoise_long_config.yml."""

    npz: str
    outdir: str
    fs: int = 16000
    seeds: List[int] = field(default_factory=lambda: [0])
    long_noise_seconds: float = 100.0
    stft_grid: List[Dict[str, Any]] = field(
        default_factory=lambda: [{"nfft": 512, "hop": 256, "win": "hann"}]
    )
    T_use_list: List[int] = field(default_factory=lambda: [16, 64, 256])
    # window stride in STFT frames for the long-noise framing; None =
    # non-overlapping (hop = T_use) like the reference default
    # (whitenoise_long_doa.py:65,191)
    slide_hop_frames: Optional[int] = None
    algo_name: str = "NormMUSIC"
    mic_radius: float = 0.0365
    force: bool = False
    # bandpass variant extras (reference/whitenoise_bandpass_doa.py)
    bands_hz: Optional[List[Tuple[float, float]]] = None
    band_names: Optional[List[str]] = None
    noise_seconds_list: Optional[List[float]] = None
    # time-domain segmentation sweep: when segments_ms is set, the signal
    # is cut into Tseg_ms frames with the given overlap factors and DoA
    # runs per time segment (the bandpass script's framing) instead of
    # per T_use-STFT-frame window (the long script's framing).
    segments_ms: Optional[List[float]] = None
    overlap_factors: Optional[List[float]] = None
    # runtime caps — 0 = unlimited (the reference sweeps every window /
    # segment). When set, truncation is logged and every summary row
    # records windows_used vs windows_available.
    max_segments: int = 0
    max_windows: int = 0

    @classmethod
    def from_yaml(cls, path: str) -> "WhitenoiseConfig":
        """Load either this schema or the reference's YAML schemas.

        Accepts the reference key spellings (whitenoise_bandpass_doa.py:
        55-71): ``bands`` ({name, low, high} dicts) → bands_hz/band_names,
        ``noise_seconds`` → noise_seconds_list; unknown keys (e.g.
        ``which``) are ignored.
        """
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        if "bands" in raw and "bands_hz" not in raw:
            raw["bands_hz"] = [
                (float(b["low"]), float(b["high"])) for b in raw["bands"]
            ]
            raw["band_names"] = [
                str(b.get("name", f"bp_{b['low']:g}_{b['high']:g}"))
                for b in raw["bands"]
            ]
        if "noise_seconds" in raw and "noise_seconds_list" not in raw:
            raw["noise_seconds_list"] = raw["noise_seconds"]
        known = {k: v for k, v in raw.items() if k in cls.__dataclass_fields__}
        return cls(**known)


def run_whitenoise_eval(cfg: WhitenoiseConfig) -> "object":
    """Long-noise (and optionally bandpass) sliding-window DoA sweep.

    Returns a pandas DataFrame ranked by mean |error| vs the GT-signal
    estimate; caches each (seed, stft, T_use[, band, length]) condition
    as its own pickle under cfg.outdir.
    """
    import pandas as pd

    os.makedirs(cfg.outdir, exist_ok=True)
    data = np.load(os.path.expanduser(cfg.npz))
    groups = list(doa_lib.iter_groups(data))

    bands = cfg.bands_hz or [None]
    band_names = cfg.band_names or [
        None if b is None else f"band{b[0]:g}-{b[1]:g}" for b in bands
    ]
    lengths = cfg.noise_seconds_list or [cfg.long_noise_seconds]
    rows = []
    if cfg.segments_ms:
        # bandpass-script framing: time segments of Tseg_ms with overlap,
        # DoA per segment (reference/whitenoise_bandpass_doa.py:109-167)
        framings = [
            ("seg", t, ov)
            for t, ov in itertools.product(
                cfg.segments_ms, cfg.overlap_factors or [0.5]
            )
        ]
    else:
        framings = [("T", t, None) for t in cfg.T_use_list]
    for seed, stft_c, (fkind, fval, fov), (band, bname), seconds in (
        itertools.product(
            cfg.seeds, cfg.stft_grid, framings, zip(bands, band_names), lengths
        )
    ):
        tag = (
            f"seed{seed}_nfft{stft_c['nfft']}_hop{stft_c['hop']}_{stft_c['win']}"
            + (f"_T{fval}" if fkind == "T" else f"_seg{fval:g}ms_ov{fov:g}")
            + f"_len{seconds:g}"
            + (f"_{bname}" if band else "")
            # every knob that changes the numbers goes into the cache key
            # so stale pickles are never silently reused
            + f"_{cfg.algo_name}_r{cfg.mic_radius:g}"
            + (f"_cap{cfg.max_segments}" if fkind == "seg" and cfg.max_segments > 0
               else "")
            + (f"_cap{cfg.max_windows}" if fkind == "T" and cfg.max_windows > 0
               else "")
            + (f"_shop{cfg.slide_hop_frames}"
               if fkind == "T" and cfg.slide_hop_frames else "")
        )
        cache = os.path.join(cfg.outdir, f"results_{tag}.pkl")
        if os.path.exists(cache) and not cfg.force:
            with open(cache, "rb") as f:
                cond = pickle.load(f)
        else:
            if fkind == "seg":
                cond = _run_condition_segmented(
                    groups, cfg, seed, stft_c, fval, fov, band, seconds
                )
            else:
                cond = _run_condition(
                    groups, cfg, seed, stft_c, fval, band, seconds
                )
            with open(cache, "wb") as f:
                pickle.dump(cond, f)
        rows.append({"tag": tag, **cond["summary"]})

    df = pd.DataFrame(rows).sort_values("mean_pred_vs_gt").reset_index(drop=True)
    df.to_csv(os.path.join(cfg.outdir, "summary_ranked.csv"), index=False)
    return df


def seg_hop_samples(fs: int, tseg_ms: float, overlap: float) -> Tuple[int, int]:
    """Segment length / hop in samples from (Tseg_ms, overlap factor)
    (reference/whitenoise_bandpass_doa.py:109-112)."""
    L = int(round(tseg_ms * 1e-3 * fs))
    H = max(1, int(round(L * (1.0 - overlap))))
    return L, H


def _segment_doa(y, mic_xy, cfg, stft_c, tseg_ms, overlap):
    """(one DoA estimate per time segment, n segments available)."""
    L, H = seg_hop_samples(cfg.fs, tseg_ms, overlap)
    T = y.shape[-1]
    starts = list(range(0, max(T - L + 1, 0), H))
    angles = []
    for i, s in enumerate(starts):
        if cfg.max_segments > 0 and i >= cfg.max_segments:
            break
        frame = y[..., s : s + L]
        if frame.shape[-1] < stft_c["nfft"]:
            continue
        X = stft_condition(frame, stft_c["nfft"], stft_c["hop"], stft_c["win"])
        sp = doa_lib.doa_spectrum(X, mic_xy, cfg.fs, stft_c["nfft"], cfg.algo_name)
        angles.append(doa_lib.estimate_azimuth_deg(sp))
    return angles, len(starts)


def _condition_over_groups(groups, cfg, seed, band, seconds, angle_fn):
    """Shared per-group loop of every condition runner.

    angle_fn(y [M, T], mic_xy) -> list of per-window/segment DoA degrees
    is the only part that differs between the long-noise (T_use STFT
    windows) and bandpass (Tseg time segments) framings.
    """
    per_group = []
    errs_gt, errs_true = [], []
    n_empty = 0
    windows_used = windows_available = 0
    for pred_group, ori_group, rx_pos, tx_pos in groups:
        mic_center = rx_pos[:, :2].mean(axis=0)
        mic_xy = doa_lib.circular_2d_array(
            mic_center, rx_pos.shape[0], cfg.mic_radius
        )
        true_deg = (
            math.degrees(
                math.atan2(tx_pos[1] - mic_center[1], tx_pos[0] - mic_center[0])
            )
            % 360
        )
        angles = {}
        for name, spec in (("pred", pred_group), ("gt", ori_group)):
            y = convolve_noise_with_group(spec, seconds, cfg.fs, seed)
            if band is not None:
                y = apply_bandpass(y, band[0], band[1], cfg.fs)
            win_angles, n_avail = angle_fn(y, mic_xy)
            if not win_angles:
                n_empty += 1
            windows_used += len(win_angles)
            windows_available += n_avail
            mu, var, std = circ_stats_deg(win_angles)
            angles[name] = {
                "mean": mu, "var": var, "std": std,
                "n_windows": len(win_angles), "n_windows_available": n_avail,
                "windows": win_angles,
            }
        e_gt = angular_error_deg(angles["pred"]["mean"], angles["gt"]["mean"])
        e_true = angular_error_deg(angles["pred"]["mean"], true_deg)
        errs_gt.append(e_gt)
        errs_true.append(e_true)
        per_group.append({"true_deg": true_deg, **angles,
                          "err_pred_vs_gt": e_gt, "err_pred_vs_true": e_true})
    import warnings

    if n_empty:
        # e.g. segments longer than the synthesized signal, or segments
        # shorter than one STFT frame — the condition is meaningless
        warnings.warn(
            f"{n_empty} signal(s) produced zero DoA windows for this "
            "condition (segment/window longer than the signal?) — its "
            "summary contains NaN",
            stacklevel=3,
        )
    if windows_used < windows_available:
        # never silent: a max_windows/max_segments cap (or too-short
        # segments) dropped windows, so circular stats cover a subset
        warnings.warn(
            f"DoA condition evaluated {windows_used} of "
            f"{windows_available} available windows (max_windows/"
            "max_segments cap or sub-frame segments) — statistics cover "
            "a subset of the signal",
            stacklevel=3,
        )
    return {
        "per_group": per_group,
        "summary": {
            "mean_pred_vs_gt": float(np.mean(errs_gt)),
            "median_pred_vs_gt": float(np.median(errs_gt)),
            "mean_pred_vs_true": float(np.mean(errs_true)),
            "n_groups": len(per_group),
            "n_empty_signals": n_empty,
            "windows_used": windows_used,
            "windows_available": windows_available,
        },
    }


def _run_condition_segmented(
    groups, cfg: WhitenoiseConfig, seed, stft_c, tseg_ms, overlap, band, seconds
):
    """Bandpass-script condition: noise → (bandpass) → time segments →
    per-segment full-STFT DoA → circular stats
    (reference/whitenoise_bandpass_doa.py:218-341)."""
    return _condition_over_groups(
        groups, cfg, seed, band, seconds,
        lambda y, mic_xy: _segment_doa(y, mic_xy, cfg, stft_c, tseg_ms, overlap),
    )


def _run_condition(groups, cfg: WhitenoiseConfig, seed, stft_c, t_use, band, seconds):
    def angle_fn(y, mic_xy):
        X = stft_condition(y, stft_c["nfft"], stft_c["hop"], stft_c["win"])
        return sliding_window_doa(
            X, mic_xy, cfg.fs, stft_c["nfft"], t_use, cfg.algo_name,
            max_windows=cfg.max_windows,
            slide_hop_frames=cfg.slide_hop_frames,
        )

    return _condition_over_groups(groups, cfg, seed, band, seconds, angle_fn)
