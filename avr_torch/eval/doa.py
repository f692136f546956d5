"""Direction-of-arrival estimation — native implementations (a copy of
``avr_tpu/eval/doa.py``, numpy and scipy only).

The reference delegates DoA to pyroomacoustics
(reference/plot_eval.py:27,101-105: MUSIC/NormMUSIC/SRP/CSSM/WAVES/TOPS/
FRIDA over a 360-point azimuth grid) and evaluates rendered 8-microphone
IR groups with it. This module implements the wideband DoA estimators
natively in numpy so the framework is self-contained:

  * MUSIC — per-bin narrowband MUSIC pseudospectra summed over bins;
  * NormMUSIC — per-bin max-normalized pseudospectra (more robust);
  * SRP — steered response power with PHAT weighting;
  * CSSM — coherent signal-subspace: focusing matrices align all bins to
    the center bin, MUSIC on the focused covariance;
  * WAVES — weighted average of focused signal subspaces, MUSIC on the
    joint subspace matrix;
  * TOPS — test of orthogonality of projected subspaces.

  * FRIDA — finite-rate-of-innovation DoA for the circular array via
    phase-mode (circular-harmonic) annihilating filters: snapshots are
    projected onto phase modes b_n ∝ jⁿ J_n(kr) e^{-jnθ}, Bessel-
    equalized so each bin yields a K-exponential sequence in n, Cadzow-
    denoised, and a total-least-squares annihilating filter stacked over
    all bins gives source azimuths as polynomial roots (grid-free). This
    is the circular-array FRI formulation of Pan et al.'s FRIDA; the
    pyroomacoustics version solves the same annihilation with an
    alternating minimization over raw visibilities.

`run_doa_on_npz` / `run_delay_and_sum_on_npz` mirror the reference's
evaluation flow and pickle schema exactly (plot_eval.py:18-266): rows are
grouped into 8-mic circular arrays (idealized circle of radius 0.0365 m,
φ₀=π/2, centered at the group's mean xy), the true angle comes from the
transmitter position, and per-group pred/gt/true angles plus the three
pairwise circular errors are recorded per algorithm.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ALGO_NAMES = ("MUSIC", "NormMUSIC", "SRP", "CSSM", "WAVES", "TOPS", "FRIDA")
SOUND_SPEED = 343.8


def angular_error_deg(est_deg: float, ref_deg: float) -> float:
    """Circular distance in degrees (reference/plot_eval.py:15-16)."""
    d = abs(est_deg - ref_deg)
    return min(d, 360.0 - d)


def circular_2d_array(center, m: int = 8, radius: float = 0.0365, phi0: float = np.pi / 2):
    """Idealized circular mic layout [2, M] (pra.beamforming semantics)."""
    phi = phi0 + 2 * np.pi * np.arange(m) / m
    return np.stack(
        [center[0] + radius * np.cos(phi), center[1] + radius * np.sin(phi)]
    )


def stft_frames(y: np.ndarray, n_fft: int = 512, hop: Optional[int] = None) -> np.ndarray:
    """Hann-windowed centered STFT: [M, T] → [M, F, frames]."""
    hop = hop or n_fft // 4
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    pad = n_fft // 2
    yp = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = 1 + (yp.shape[-1] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = yp[..., idx] * w
    return np.fft.rfft(frames, axis=-1).swapaxes(-1, -2).astype(np.complex64)


def _steering(mic_xy: np.ndarray, freqs: np.ndarray, grid_rad: np.ndarray, c: float):
    """Array manifold a[k, f, m] = exp(+j2πf (pₘ·u(θ_k))/c).

    A far-field source at azimuth θ reaches mics with time ADVANCE
    (p·u)/c (closer mics receive earlier), so the manifold carries the
    positive sign; beamformers multiply by its conjugate.
    """
    u = np.stack([np.cos(grid_rad), np.sin(grid_rad)], axis=-1)  # [K, 2]
    centered = mic_xy - mic_xy.mean(axis=1, keepdims=True)
    adv = (u @ centered) / c  # [K, M]
    return np.exp(2j * np.pi * freqs[None, :, None] * adv[:, None, :])


def _covariances(X: np.ndarray) -> np.ndarray:
    """Per-bin spatial covariance: X [M, F, T] → R [F, M, M]."""
    Xf = X.transpose(1, 0, 2)  # [F, M, T]
    return np.einsum("fmt,fnt->fmn", Xf, Xf.conj()) / X.shape[-1]


def _noise_projector(R: np.ndarray, num_src: int) -> np.ndarray:
    """E_n E_nᴴ for each covariance in a stack [..., M, M]."""
    w, v = np.linalg.eigh(R)  # ascending eigenvalues
    En = v[..., : R.shape[-1] - num_src]
    return En @ En.conj().swapaxes(-1, -2)


def _select_bins(n_fft: int, fs: float, freq_range) -> np.ndarray:
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    lo, hi = freq_range
    bins = np.nonzero((freqs >= lo) & (freqs <= hi))[0]
    return bins if len(bins) else np.arange(1, len(freqs))


def doa_spectrum(
    X: np.ndarray,
    mic_xy: np.ndarray,
    fs: float,
    n_fft: int,
    algo: str = "NormMUSIC",
    num_src: int = 1,
    freq_range: Tuple[float, float] = (500.0, 4000.0),
    c: float = SOUND_SPEED,
    n_grid: int = 360,
) -> np.ndarray:
    """Azimuth spatial spectrum [n_grid] for STFT frames X [M, F, frames]."""
    grid = np.deg2rad(np.arange(n_grid) * (360.0 / n_grid))
    bins = _select_bins(n_fft, fs, freq_range)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)[bins]
    A = _steering(mic_xy, freqs, grid, c)  # [K, B, M]
    M = X.shape[0]

    if algo in ("MUSIC", "NormMUSIC"):
        R = _covariances(X)[bins]  # [B, M, M]
        P = _noise_projector(R, num_src)  # [B, M, M]
        denom = np.einsum("kbm,bmn,kbn->kb", A.conj(), P, A).real
        pseudo = 1.0 / np.maximum(denom, 1e-12)  # [K, B]
        if algo == "NormMUSIC":
            pseudo = pseudo / np.maximum(pseudo.max(axis=0, keepdims=True), 1e-12)
        return pseudo.sum(axis=1)

    if algo == "SRP":
        Xb = X[:, bins, :]  # [M, B, T]
        Xw = Xb / np.maximum(np.abs(Xb), 1e-12)  # PHAT whitening
        # frame-energy weighting: bare per-element PHAT gives every
        # late-reverberation frame the same total weight as the
        # direct-path frame, so on impulse-response inputs the sum over
        # frames locks onto wall reflections (measured: 143-160° errors
        # on image-source rooms even at absorption 0.9). Weighting each
        # frame by its share of the broadband energy keeps PHAT's
        # per-bin phase normalization but restores the direct path's
        # dominance; anechoic stationary signals (≈equal-energy frames)
        # are unaffected.
        w_t = (np.abs(Xb) ** 2).sum(axis=(0, 1))  # [T]
        w_t = w_t / np.maximum(w_t.sum(), 1e-12)
        beams = np.einsum("kbm,mbt->kbt", A.conj(), Xw)
        return ((np.abs(beams) ** 2) * w_t[None, None, :]).sum(axis=(1, 2))

    if algo in ("CSSM", "WAVES"):
        return _coherent_spectrum(X, A, bins, num_src, algo)

    if algo == "TOPS":
        return _tops_spectrum(X, A, bins, num_src)

    if algo == "FRIDA":
        mic_r = float(
            np.linalg.norm(
                (mic_xy - mic_xy.mean(axis=1, keepdims=True))[:, 0]
            )
        )
        az = _frida_azimuths(X, mic_r, fs, n_fft, bins, num_src, c)
        # grid-free estimates rendered as narrow peaks so the common
        # argmax readout applies
        grid_deg = np.arange(n_grid) * (360.0 / n_grid)
        spec = np.zeros(n_grid)
        for j, th in enumerate(az):
            d = np.abs(grid_deg - math.degrees(th) % 360)
            d = np.minimum(d, 360.0 - d)
            spec += (1.0 - 0.1 * j) * np.exp(-0.5 * (d / 1.5) ** 2)
        return spec

    raise NotImplementedError(f"DoA algorithm {algo!r} is not implemented")


def _phase_modes(vec: np.ndarray, n_max: int) -> np.ndarray:
    """Project one M-mic snapshot/eigenvector onto phase modes
    n = -n_max..n_max for the φ₀=π/2 circular layout."""
    m = len(vec)
    phi = np.pi / 2 + 2 * np.pi * np.arange(m) / m
    n = np.arange(-n_max, n_max + 1)
    basis = np.exp(-1j * n[:, None] * phi[None, :]) / m
    return basis @ vec  # [2·n_max+1]


def _longest_run(mask: np.ndarray) -> Tuple[int, int]:
    """[start, end) of the longest run of True values."""
    best = (0, 0)
    i = 0
    while i < len(mask):
        if mask[i]:
            j = i
            while j < len(mask) and mask[j]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        else:
            i += 1
    return best


def _cadzow(seq: np.ndarray, k: int, n_iter: int = 10) -> np.ndarray:
    """Cadzow denoising: alternate rank-k truncation of the Toeplitz
    lift of `seq` with Toeplitz (anti-diagonal-average) projection."""
    L = len(seq)
    rows, cols = L - k, k + 1
    if rows < cols:
        return seq
    s = seq.copy()
    for _ in range(n_iter):
        T = np.stack([s[i : i + cols][::-1] for i in range(rows)])
        U, sv, Vh = np.linalg.svd(T, full_matrices=False)
        T = (U[:, :k] * sv[:k]) @ Vh[:k]
        # average along anti-diagonals back to a sequence
        acc = np.zeros(L, np.complex128)
        cnt = np.zeros(L)
        for i in range(rows):
            for j in range(cols):
                acc[i + cols - 1 - j] += T[i, j]
                cnt[i + cols - 1 - j] += 1
        s = acc / np.maximum(cnt, 1)
    return s


def _frida_azimuths(
    X: np.ndarray,
    mic_radius: float,
    fs: float,
    n_fft: int,
    bins: np.ndarray,
    num_src: int,
    c: float,
    bessel_floor: float = 0.05,
) -> List[float]:
    """FRI azimuth recovery on phase-mode sequences (see module docs).

    Returns up to `num_src` azimuths in radians, strongest first.
    """
    from scipy.special import jv

    M = X.shape[0]
    n_max = M // 2 - 1  # spatial aliasing limit for an M-mic UCA
    n = np.arange(-n_max, n_max + 1)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)[bins]
    R = _covariances(X)[bins]  # [B, M, M]
    w, v = np.linalg.eigh(R)

    rows = []
    for b, f in enumerate(freqs):
        kr = 2 * np.pi * f * mic_radius / c
        bes = jv(n, kr) * (1j ** n)  # mode gains jⁿ J_n(kr)
        usable = np.abs(jv(n, kr)) > bessel_floor
        # Bessel-equalization blows up noise where J_n(kr) ≈ 0; keep the
        # longest CONTIGUOUS span of usable modes (a gap would break the
        # exponential-sequence structure the annihilation relies on).
        lo, hi = _longest_run(usable)
        if hi - lo < num_src + 1:
            continue
        for s_i in range(num_src):
            lam = max(float(w[b, -1 - s_i]), 0.0)
            if lam <= 0:
                continue
            vec = v[b, :, -1 - s_i] * np.sqrt(lam)
            seq = (_phase_modes(vec, n_max) / bes)[lo:hi]
            seq = _cadzow(seq, num_src)
            # Toeplitz rows of the annihilation system c₀·s[i+K]+…=0
            for i in range(len(seq) - num_src):
                rows.append(seq[i : i + num_src + 1][::-1])
    if not rows:
        return []
    T = np.stack(rows)
    # TLS annihilating filter: smallest right singular vector
    _, _, Vh = np.linalg.svd(T, full_matrices=False)
    coeffs = Vh[-1].conj()
    roots = np.roots(coeffs)
    if len(roots) == 0:
        return []
    # project roots to the unit circle; sequence model is e^{-jnθ} for
    # ascending n, so root angle = -θ... with rows reversed the filter
    # annihilates z_k = e^{-jθ_k}; recover θ = -angle(z).
    order = np.argsort(np.abs(np.abs(roots) - 1.0))
    return [float((-np.angle(z)) % (2 * np.pi)) for z in roots[order][:num_src]]


def _focused_stats(X, A, bins, num_src):
    """Focusing matrices aligning each bin's steering manifold to the
    center bin's (rotational signal-subspace focusing, as in CSSM/WAVES)."""
    R = _covariances(X)[bins]  # [B, M, M]
    b0 = len(bins) // 2
    A0 = A[:, b0, :]  # [K, M] reference-bin steering
    focused = []
    for b in range(len(bins)):
        # T_b = argmin ||A0 − T A_b||_F s.t. T unitary (Procrustes)
        U, _, Vh = np.linalg.svd(A0.conj().T @ A[:, b, :])
        Tb = U @ Vh
        focused.append(Tb @ R[b] @ Tb.conj().T)
    return np.asarray(focused), b0


def _coherent_spectrum(X, A, bins, num_src, algo):
    focused, b0 = _focused_stats(X, A, bins, num_src)
    A0 = A[:, b0, :]
    if algo == "CSSM":
        Rc = focused.mean(axis=0)
        P = _noise_projector(Rc, num_src)
    else:  # WAVES: weighted joint signal-subspace matrix
        vecs = []
        for Rf in focused:
            w, v = np.linalg.eigh(Rf)
            sig = v[:, -num_src:] * np.sqrt(np.maximum(w[-num_src:], 0.0))
            vecs.append(sig)
        Z = np.concatenate(vecs, axis=1)  # [M, B·num_src]
        U, _s, _ = np.linalg.svd(Z)
        En = U[:, num_src:]
        P = En @ En.conj().T
    denom = np.einsum("km,mn,kn->k", A0.conj(), P, A0).real
    return 1.0 / np.maximum(denom, 1e-12)


def _tops_spectrum(X, A, bins, num_src):
    R = _covariances(X)[bins]
    # Reference signal subspace from the FOCUSED mean covariance
    # (CSSM-style frequency smoothing) instead of the single center
    # bin's: under coherent multipath (room IRs — the inputs every
    # evaluation in this codebase feeds the estimator) a single bin's
    # top eigenvector is a direct+reflection mixture and translating it
    # across bins is invalid (measured 99-176° flips); frequency
    # smoothing decorrelates the paths. Anechoic behaviour unchanged
    # (the smoothed subspace equals the per-bin one there).
    focused, b0 = _focused_stats(X, A, bins, num_src)
    w0, v0 = np.linalg.eigh(focused.mean(axis=0))
    F0 = v0[:, -num_src:]  # reference signal subspace
    K = A.shape[0]
    score = np.zeros(K)
    for k in range(K):
        D_rows = []
        for b in range(len(bins)):
            if b == b0:
                continue
            # project reference subspace to bin b via steering phase ratio
            phi = A[k, b, :] / A[k, b0, :]
            Fb = phi[:, None] * F0
            # original-TOPS spurious-peak suppression (Yoon et al. 2006,
            # eq. 22): project the hypothesized steering direction OUT of
            # the translated subspace, P(θ,b) = I − aaᴴ/‖a‖². Without it
            # signal-subspace estimation error (strong under coherent
            # multipath) leaks into D and the minimum singular value
            # dips at wrong angles (measured 148-178° flips on
            # image-source rooms).
            a = A[k, b, :][:, None]  # [M, 1]
            Fb = Fb - a @ (a.conj().T @ Fb) / (a.conj().T @ a).real.item()
            wb, vb = np.linalg.eigh(R[b])
            Wn = vb[:, : R.shape[-1] - num_src]
            D_rows.append(Fb.conj().T @ Wn)
        D = np.concatenate(D_rows, axis=1)
        smin = np.linalg.svd(D, compute_uv=False)[-1]
        score[k] = 1.0 / max(smin, 1e-12)
    return score


def estimate_azimuth_deg(spectrum: np.ndarray) -> float:
    return float(np.argmax(spectrum) * (360.0 / len(spectrum)))


# ----------------------------------------------------------------------
# npz-driven evaluation (consumes the runner's val_iter*.npz dumps)
# ----------------------------------------------------------------------
def _empty_results(names: Sequence[str]) -> Dict[str, Dict[str, list]]:
    keys = (
        "true_deg", "pred_deg", "gt_deg",
        "pred_vs_gt_error", "pred_vs_true_error", "gt_vs_true_error",
    )
    return {a: {k: [] for k in keys} for a in names}


def _record(res, algo, true_deg, pred_deg, gt_deg):
    r = res[algo]
    r["true_deg"].append(true_deg)
    r["pred_deg"].append(pred_deg)
    r["gt_deg"].append(gt_deg)
    r["pred_vs_gt_error"].append(
        None if pred_deg is None or gt_deg is None
        else angular_error_deg(pred_deg, gt_deg)
    )
    r["pred_vs_true_error"].append(
        None if pred_deg is None else angular_error_deg(pred_deg, true_deg)
    )
    r["gt_vs_true_error"].append(
        None if gt_deg is None else angular_error_deg(gt_deg, true_deg)
    )


def iter_groups(data, m: int = 8):
    """Yield per-group slices of an npz dump (pred, ori, rx, tx)."""
    pred_sig, ori_sig = data["pred_sig"], data["ori_sig"]
    rx, tx = data["position_rx"], data["position_tx"]
    for g in range(pred_sig.shape[0] // m):
        i = np.arange(g * m, (g + 1) * m)
        yield pred_sig[i], ori_sig[i], rx[i], tx[i][0]


def run_doa_on_npz(
    npz_path: str,
    fs: int = 16000,
    n_fft: int = 512,
    mic_radius: float = 0.0365,
    algo_names: Optional[Sequence[str]] = None,
    save_path: Optional[str] = None,
) -> Dict[str, Dict[str, list]]:
    """Wideband DoA over every 8-mic group of a val npz
    (reference/plot_eval.py:18-132; same pickle schema)."""
    algo_names = list(algo_names or ALGO_NAMES)
    data = np.load(npz_path)
    results = _empty_results(algo_names)

    for pred_group, ori_group, rx_pos, tx_pos in iter_groups(data):
        mic_center = rx_pos[:, :2].mean(axis=0)
        mic_xy = circular_2d_array(mic_center, rx_pos.shape[0], mic_radius)
        true_deg = math.degrees(
            math.atan2(tx_pos[1] - mic_center[1], tx_pos[0] - mic_center[0])
        ) % 360

        pred_time = np.fft.irfft(pred_group, axis=-1).real
        ori_time = np.fft.irfft(ori_group, axis=-1).real
        X_pred = stft_frames(pred_time, n_fft)
        X_ori = stft_frames(ori_time, n_fft)

        for algo in algo_names:
            try:
                sp = doa_spectrum(X_pred, mic_xy, fs, n_fft, algo)
                so = doa_spectrum(X_ori, mic_xy, fs, n_fft, algo)
                _record(results, algo, true_deg,
                        estimate_azimuth_deg(sp), estimate_azimuth_deg(so))
            except Exception:
                _record(results, algo, true_deg, None, None)

    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(results, f)
    return results


def run_delay_and_sum_on_npz(
    npz_path: str,
    fs: int = 16000,
    mic_radius: float = 0.0365,
    n_fft: int = 512,
    angle_resolution: float = 1.0,
    beta: float = 100.0,
    save_path: Optional[str] = None,
    c: float = SOUND_SPEED,
) -> Dict[str, Dict[str, list]]:
    """Frequency-domain DAS beamforming with soft-argmax and argmax
    readouts (reference/plot_eval.py:134-266). Note the reference uses a
    UNIT-radius idealized mic circle here (plot_eval.py:183-184) — the
    same quirk as the training-time DAS loss; preserved."""
    data = np.load(npz_path)
    angles = np.arange(0.0, 360.0, angle_resolution)
    angles_rad = np.deg2rad(angles)
    results = _empty_results(["NormDAS_soft-argmax", "NormDAS_argmax"])

    m = 8
    mic_phi = np.linspace(np.pi / 2, np.pi / 2 + 2 * np.pi, m + 1)[:-1]
    mic_pos = np.stack([np.cos(mic_phi), np.sin(mic_phi)], axis=-1)  # unit circle
    mic_pos = mic_pos - mic_pos.mean(axis=0)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    u = np.stack([np.cos(angles_rad), np.sin(angles_rad)], axis=-1)  # [K, 2]
    delays = (u @ mic_pos.T) / c  # [K, M]
    steering = np.exp(-2j * np.pi * delays[:, :, None] * freqs[None, None, :])

    def das_power(group_sig):
        time_sig = np.fft.irfft(group_sig, axis=-1).real
        X = np.fft.rfft(time_sig[:, :n_fft] if time_sig.shape[-1] >= n_fft
                        else np.pad(time_sig, ((0, 0), (0, n_fft - time_sig.shape[-1]))),
                        axis=-1)
        beam = np.einsum("mf,kmf->kf", X, steering) / m
        p = np.abs(beam) ** 2
        p = p / (p.sum(axis=0, keepdims=True) + 1e-8)
        return p.sum(axis=-1)  # [K]

    def softmax(x):
        e = np.exp(x - x.max())
        return e / e.sum()

    for pred_group, ori_group, rx_pos, tx_pos in iter_groups(data):
        mic_center = rx_pos[:, :2].mean(axis=0)
        true_deg = math.degrees(
            math.atan2(tx_pos[1] - mic_center[1], tx_pos[0] - mic_center[0])
        ) % 360
        p_pred, p_gt = das_power(pred_group), das_power(ori_group)

        w_pred, w_gt = softmax(beta * p_pred), softmax(beta * p_gt)
        _record(results, "NormDAS_soft-argmax", true_deg,
                float(np.sum(w_pred * angles)) % 360,
                float(np.sum(w_gt * angles)) % 360)
        _record(results, "NormDAS_argmax", true_deg,
                float(angles[np.argmax(p_pred)]) % 360,
                float(angles[np.argmax(p_gt)]) % 360)

    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(results, f)
    return results


def summarize(results: Dict[str, Dict[str, list]]) -> Dict[str, Dict[str, float]]:
    """Mean/median/std of each algorithm's pred-vs-gt and pred-vs-true
    errors (the Optuna objective uses mean pred_vs_gt —
    reference/optuna_avr_runner.py:113-124)."""
    out = {}
    for algo, r in results.items():
        clean = [e for e in r["pred_vs_gt_error"] if e is not None]
        clean_t = [e for e in r["pred_vs_true_error"] if e is not None]
        # gt_vs_true is the pipeline-health metric: DoA of the MEASURED
        # spectra against the geometric angle. Large values point at the
        # data/dump/array-geometry path, not the model.
        clean_g = [e for e in r.get("gt_vs_true_error", []) if e is not None]
        out[algo] = {
            "mean_pred_vs_gt": float(np.mean(clean)) if clean else float("nan"),
            "median_pred_vs_gt": float(np.median(clean)) if clean else float("nan"),
            "std_pred_vs_gt": float(np.std(clean)) if clean else float("nan"),
            "mean_pred_vs_true": float(np.mean(clean_t)) if clean_t else float("nan"),
            "mean_gt_vs_true": float(np.mean(clean_g)) if clean_g else float("nan"),
            "n": len(clean),
        }
    return out
