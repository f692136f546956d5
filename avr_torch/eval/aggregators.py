"""Offline aggregation and reporting over evaluation result trees (a copy
of ``avr_tpu/eval/aggregators.py``: ``study_report`` takes the port's
``hpo.study.Study``, ``experiment_report`` reads the port's ``AVRConfig``
and draws with the port's plotting; no repair).

Re-designs the reference's family of white-noise / DoA post-processing
scripts as library functions over the pipelines' pickle/npz outputs:

  * frame_error_table / plot_frame_errors  — per-window DoA error grids
    (reference/whitenoise_frame_errors.py, whitenoise_long_frame_scatter.py);
  * circular_median_summary                — robust per-condition medians
    (reference/whitenoise_result_tmp.py partial-summary CSV);
  * compare_stft_conditions                — DoA accuracy across a
    win×n_fft×hop grid directly on val npz dumps
    (reference/doa_compare_stft_conditions.py:67-177);
  * plot_band_response                     — |H(f)| inspection of IR
    groups (reference/inspect_bandpass.py);
  * study_report                           — trial-wise objective curve +
    best-trial table for an HPO study
    (reference/plot_min_DoA_optuna.py:200-276).
"""

from __future__ import annotations

import itertools
import math
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from avr_torch.eval import doa as doa_lib
from avr_torch.eval import whitenoise as wn


# ----------------------------------------------------------------------
# White-noise condition pickles → frame-level tables and figures
# ----------------------------------------------------------------------
def frame_error_table(cond_pickle: str) -> "object":
    """Per-group per-window angles/errors of one condition pickle
    → tidy DataFrame (group, window, pred_deg, err_vs_mean_gt)."""
    import pandas as pd

    with open(cond_pickle, "rb") as f:
        cond = pickle.load(f)
    rows = []
    for g, rec in enumerate(cond["per_group"]):
        gt_mean = rec["gt"]["mean"]
        for wi, ang in enumerate(rec["pred"]["windows"]):
            rows.append(
                {
                    "group": g,
                    "window": wi,
                    "pred_deg": ang,
                    "err_vs_gt_mean": wn.angular_error_deg(ang, gt_mean),
                    "err_vs_true": wn.angular_error_deg(ang, rec["true_deg"]),
                }
            )
    return pd.DataFrame(rows)


def plot_frame_errors(cond_pickles: Sequence[str], save_path: str) -> None:
    """Grid of per-window error traces, one panel per condition."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(cond_pickles)
    cols = min(3, max(n, 1))
    rows_n = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows_n, cols, figsize=(5 * cols, 3.2 * rows_n),
                             squeeze=False)
    for i, pkl in enumerate(cond_pickles):
        ax = axes[i // cols][i % cols]
        df = frame_error_table(pkl)
        for g, grp in df.groupby("group"):
            ax.plot(grp["window"], grp["err_vs_gt_mean"], alpha=0.6, label=f"g{g}")
        ax.set_title(os.path.basename(pkl)[:40], fontsize=8)
        ax.set_xlabel("window")
        ax.set_ylabel("err (deg)")
        ax.grid(alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=130)
    plt.close(fig)


def plot_frame_scatter(cond_pickle: str, save_path: str) -> None:
    """Window-angle scatter vs GT/true per group
    (whitenoise_long_frame_scatter.py analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = frame_error_table(cond_pickle)
    fig, ax = plt.subplots(figsize=(10, 5))
    for g, grp in df.groupby("group"):
        ax.scatter(grp["window"] + g * 0.1, grp["pred_deg"], s=10, alpha=0.6,
                   label=f"group {g}")
    ax.set_xlabel("window")
    ax.set_ylabel("pred angle (deg)")
    ax.set_ylim(0, 360)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=130)
    plt.close(fig)


def circular_median_summary(outdir: str) -> "object":
    """Scan an outdir of results_*.pkl and produce a per-condition
    circular-median summary CSV (robust variant of summary_ranked)."""
    import pandas as pd

    rows = []
    for name in sorted(os.listdir(outdir)):
        if not (name.startswith("results_") and name.endswith(".pkl")):
            continue
        with open(os.path.join(outdir, name), "rb") as f:
            cond = pickle.load(f)
        errs = [g["err_pred_vs_gt"] for g in cond["per_group"]]
        pred_means = [g["pred"]["mean"] for g in cond["per_group"]]
        mu, var, std = wn.circ_stats_deg(pred_means)
        rows.append(
            {
                "tag": name[len("results_"):-len(".pkl")],
                "median_err": float(np.median(errs)) if errs else float("nan"),
                "mean_err": float(np.mean(errs)) if errs else float("nan"),
                "circ_mean_pred": mu,
                "circ_var_pred": var,
                "n_groups": len(errs),
            }
        )
    df = pd.DataFrame(rows).sort_values("median_err").reset_index(drop=True)
    df.to_csv(os.path.join(outdir, "summary_circular_median.csv"), index=False)
    return df


# ----------------------------------------------------------------------
# Direct STFT-condition sweep on val npz dumps
# ----------------------------------------------------------------------
def compare_stft_conditions(
    npz_paths: Sequence[str],
    fs: int = 16000,
    n_ffts: Sequence[int] = (256, 512, 1024),
    hops: Sequence[Optional[int]] = (None,),
    wins: Sequence[str] = ("hann",),
    algo: str = "NormMUSIC",
    mic_radius: float = 0.0365,
    save_csv: Optional[str] = None,
) -> "object":
    """Mean DoA error per (checkpoint, n_fft, hop, win) condition
    (reference/doa_compare_stft_conditions.py:67-177)."""
    import pandas as pd

    rows = []
    for npz_path in npz_paths:
        data = np.load(npz_path)
        for n_fft, hop, win in itertools.product(n_ffts, hops, wins):
            hop_eff = hop or n_fft // 4
            errs_gt, errs_true = [], []
            for pred_g, ori_g, rx, tx in doa_lib.iter_groups(data):
                center = rx[:, :2].mean(axis=0)
                mic_xy = doa_lib.circular_2d_array(center, rx.shape[0], mic_radius)
                true_deg = math.degrees(
                    math.atan2(tx[1] - center[1], tx[0] - center[0])
                ) % 360
                pt = np.fft.irfft(pred_g, axis=-1).real
                ot = np.fft.irfft(ori_g, axis=-1).real
                if win == "hann":
                    Xp = doa_lib.stft_frames(pt, n_fft, hop_eff)
                    Xo = doa_lib.stft_frames(ot, n_fft, hop_eff)
                else:
                    Xp = wn.stft_condition(pt, n_fft, hop_eff, "none")
                    Xo = wn.stft_condition(ot, n_fft, hop_eff, "none")
                p = doa_lib.estimate_azimuth_deg(
                    doa_lib.doa_spectrum(Xp, mic_xy, fs, n_fft, algo)
                )
                g = doa_lib.estimate_azimuth_deg(
                    doa_lib.doa_spectrum(Xo, mic_xy, fs, n_fft, algo)
                )
                errs_gt.append(doa_lib.angular_error_deg(p, g))
                errs_true.append(doa_lib.angular_error_deg(p, true_deg))
            rows.append(
                {
                    "npz": os.path.basename(npz_path),
                    "n_fft": n_fft, "hop": hop_eff, "win": win,
                    "mean_pred_vs_gt": float(np.mean(errs_gt)),
                    "mean_pred_vs_true": float(np.mean(errs_true)),
                    "n_groups": len(errs_gt),
                }
            )
    df = pd.DataFrame(rows).sort_values("mean_pred_vs_gt").reset_index(drop=True)
    if save_csv:
        os.makedirs(os.path.dirname(save_csv) or ".", exist_ok=True)
        df.to_csv(save_csv, index=False)
    return df


def plot_band_response(
    npz_path: str, save_path: str, group: int = 0, fs: int = 16000
) -> None:
    """|H(f)| of one group's predicted vs GT IRs
    (reference/inspect_bandpass.py analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(npz_path)
    groups = list(doa_lib.iter_groups(data))
    pred_g, ori_g, _, _ = groups[group]
    freqs = np.linspace(0, fs / 2, pred_g.shape[-1])
    fig, ax = plt.subplots(figsize=(10, 5))
    for m in range(pred_g.shape[0]):
        ax.semilogy(freqs, np.abs(ori_g[m]) + 1e-12, "b", alpha=0.3)
        ax.semilogy(freqs, np.abs(pred_g[m]) + 1e-12, "r", alpha=0.3)
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("|H(f)|")
    ax.set_title(f"group {group}: gt (blue) vs pred (red)")
    ax.grid(alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=130)
    plt.close(fig)


# ----------------------------------------------------------------------
# HPO study reporting
# ----------------------------------------------------------------------
def study_report(study, save_path: Optional[str] = None) -> Dict:
    """Objective-vs-trial curve + running best + best-trial params
    (reference/plot_min_DoA_optuna.py:200-276)."""
    trials = study.trials
    values = [t["value"] for t in trials]
    running_best = list(np.minimum.accumulate(values)) if values else []
    report = {
        "n_trials": len(trials),
        "best_value": study.best_value if trials else float("nan"),
        "best_params": study.best_params if trials else {},
        "values": values,
        "running_best": running_best,
    }
    if save_path and trials:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 5))
        ax.plot(values, "o", alpha=0.5, label="trial objective")
        ax.plot(running_best, "-", label="running best")
        ax.set_xlabel("trial")
        ax.set_ylabel("DoA error (deg)")
        ax.legend()
        ax.grid(alpha=0.3)
        plt.tight_layout()
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path, dpi=130)
        plt.close(fig)
    return report


def waveform_level_summary(root: str, save_dir: Optional[str] = None) -> "object":
    """Per-waveform (group) representative-angle errors across a results
    tree (reference/whitenoise_frame_eval_waveformlevel.py): for every
    condition pickle under `root`, reduce each group's window-angle
    series to a circular mean AND a circular median, compute
    |gt−true| / |pred−true| / |pred−gt| per reduction, and emit a tidy
    DataFrame plus 1x3 scatter figures per reduction."""
    import pandas as pd

    rows = []
    pkls = []
    for dirpath, _dirs, files in os.walk(root):
        pkls.extend(os.path.join(dirpath, f) for f in files
                    if f.endswith(".pkl") and f.startswith("results"))
    for pk in sorted(pkls):
        with open(pk, "rb") as f:
            cond = pickle.load(f)
        for g, rec in enumerate(cond.get("per_group", [])):
            for red in ("mean", "median"):
                out = {}
                for name in ("pred", "gt"):
                    win = [a for a in rec[name]["windows"] if a == a]
                    if not win:
                        out[name] = float("nan")
                    elif red == "mean":
                        out[name] = wn.circ_mean_deg(win)[0]
                    else:
                        s = np.sort((np.asarray(win) - rec["true_deg"] + 180) % 360)
                        out[name] = float(
                            (np.median(s) + rec["true_deg"] - 180) % 360
                        )
                rows.append({
                    "pickle": os.path.relpath(pk, root), "group": g,
                    "reduction": red,
                    "pred_deg": out["pred"], "gt_deg": out["gt"],
                    "true_deg": rec["true_deg"],
                    "gt_vs_true": wn.angular_error_deg(out["gt"], rec["true_deg"]),
                    "pred_vs_true": wn.angular_error_deg(out["pred"], rec["true_deg"]),
                    "pred_vs_gt": wn.angular_error_deg(out["pred"], out["gt"]),
                })
    df = pd.DataFrame(rows)
    if save_dir and len(df):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(save_dir, exist_ok=True)
        for red, fname in (("mean", "scatter_wave_all.png"),
                           ("median", "scatter_wave_all_median.png")):
            d = df[df["reduction"] == red]
            fig, axes = plt.subplots(1, 3, figsize=(15, 5))
            for ax, (xk, yk) in zip(axes, (("true_deg", "gt_deg"),
                                           ("true_deg", "pred_deg"),
                                           ("gt_deg", "pred_deg"))):
                ax.scatter(d[xk], d[yk], s=12, alpha=0.6)
                ax.plot([0, 360], [0, 360], "k--", lw=0.8)
                ax.set_xlabel(xk)
                ax.set_ylabel(yk)
                ax.set_xlim(0, 360)
                ax.set_ylim(0, 360)
            fig.suptitle(f"waveform-level ({red})  "
                         f"MAE pred-vs-true {d['pred_vs_true'].mean():.1f}°")
            fig.tight_layout()
            fig.savefig(os.path.join(save_dir, fname), dpi=120)
            plt.close(fig)
        df.to_csv(os.path.join(save_dir, "waveform_level.csv"), index=False)
    return df


def plot_rotate_results(npz_path: str, save_path: str) -> None:
    """Rotation-sweep visualization (reference/vis_eval_rotate_doa_avr.py):
    predicted vs true DoA over the rotation sweep plus the error
    histogram, from rotate_group_eval's val_rotate_pred.npz."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = np.load(npz_path)
    pred, true = np.asarray(z["pred_deg"], float), np.asarray(z["true_deg"], float)
    errs = np.asarray(
        [doa_lib.angular_error_deg(p, t) for p, t in zip(pred, true)]
    )
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].scatter(true, pred, s=14, alpha=0.7)
    axes[0].plot([0, 360], [0, 360], "k--", lw=0.8)
    axes[0].set_xlabel("true DoA (deg)")
    axes[0].set_ylabel("predicted DoA (deg)")
    axes[0].set_title(f"rotation sweep (deg_step={float(z['deg_step']):g})")
    axes[1].hist(errs, bins=36, range=(0, 180), color="tab:blue", alpha=0.8)
    axes[1].set_xlabel("|error| (deg)")
    axes[1].set_ylabel("count")
    axes[1].set_title(f"mean {errs.mean():.1f}°  median {np.median(errs):.1f}°")
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def experiment_report(
    config_path: str,
    algos: Sequence[str] = ("NormMUSIC",),
    save_path: Optional[str] = None,
    fs: Optional[int] = None,
) -> Dict[int, float]:
    """Config-driven training report (reference/plot_eval_with_config.py):
    from an experiment YAML, locate the logdir, run DoA over every
    val_iter*.npz checkpoint dump (pickles cached in doa_results/), and
    merge the loss curves with per-checkpoint DoA error into one figure.
    Returns {iteration: mean NormMUSIC pred-vs-gt error}."""
    import glob as _glob
    import re as _re

    from avr_torch.config import AVRConfig
    from avr_torch.utils import plotting

    cfg = AVRConfig.from_yaml(config_path)
    base = os.path.join(cfg.path.logdir, cfg.path.expname)
    npzs = sorted(_glob.glob(os.path.join(base, "val_result", "val_iter*.npz")))
    doa_dir = os.path.join(base, "doa_results")
    os.makedirs(doa_dir, exist_ok=True)
    doa_by_iter: Dict[int, float] = {}
    for p in npzs:
        it = int(_re.search(r"val_iter(\d+)", os.path.basename(p)).group(1))
        pkl = os.path.join(doa_dir, f"doa_iter{it:06d}.pkl")
        if os.path.exists(pkl):  # resume-safe caching (reference pattern)
            with open(pkl, "rb") as f:
                res = pickle.load(f)
        else:
            res = doa_lib.run_doa_on_npz(
                p, fs or cfg.render.fs, algo_names=list(algos), save_path=pkl
            )
        doa_by_iter[it] = doa_lib.summarize(res)[algos[0]]["mean_pred_vs_gt"]
    out = save_path or os.path.join(base, "loss_and_doa_plot.png")
    metrics = os.path.join(base, "metrics.jsonl")
    if os.path.exists(metrics):
        plotting.plot_loss_and_doa(metrics, doa_by_iter, out)
    return doa_by_iter


# ----------------------------------------------------------------------
# Best/last checkpoint detail scatters (plot_DoA_detail_scatter.py /
# plot_DAS_detail_scatter.py parity)
# ----------------------------------------------------------------------
def _scatter_panel(ax, x, y, xlabel, ylabel, title):
    """One pred/gt/true panel (reference/plot_DoA_detail_scatter.py:62-71:
    identity diagonal, square 0..360 axes)."""
    ax.scatter(x, y, alpha=0.5)
    ax.plot([0, 360], [0, 360], "r--")
    ax.set_xlim(0, 360)
    ax.set_ylim(0, 360)
    ax.set_aspect("equal", "box")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title, fontsize=11)


def _checkpoint_pkls(base_dir: str) -> List[str]:
    import glob

    return sorted(glob.glob(os.path.join(base_dir, "val_iter*.pkl")))


def _mean_err(rec: Dict, key: str = "pred_vs_gt_error") -> Optional[float]:
    clean = [e for e in rec[key] if e is not None]
    return float(np.mean(clean)) if clean else None


def _best_last(paths: Sequence[str], method: str):
    """[(path, mean err)] filtered to checkpoints with usable estimates;
    returns (results, best, last) like plot_DoA_detail_scatter.py:32-49."""
    results = []
    for path in paths:
        with open(path, "rb") as f:
            data = pickle.load(f)
        if method not in data:
            continue
        err = _mean_err(data[method])
        if err is not None:
            results.append((path, err))
    if not results:
        raise RuntimeError(f"Valid results not found for {method}.")
    best = min(results, key=lambda x: x[1])
    last = results[-1]
    return results, best, last


def _panel_row(axs_row, path: str, method: str, label: str, epoch: int):
    with open(path, "rb") as f:
        d = pickle.load(f)[method]
    gt = np.array(d["gt_deg"], dtype=float)
    pred = np.array(d["pred_deg"], dtype=float)
    true = np.array(d["true_deg"], dtype=float)
    errs = {k: _mean_err(d, k) for k in
            ("pred_vs_gt_error", "pred_vs_true_error", "gt_vs_true_error")}
    _scatter_panel(axs_row[0], gt, pred, "gt_deg", "pred_deg",
                   f"{label} (Epoch {epoch})\npred_vs_gt_error: "
                   f"{errs['pred_vs_gt_error']:.2f}°")
    _scatter_panel(axs_row[1], true, pred, "true_deg", "pred_deg",
                   f"{label} (Epoch {epoch})\npred_vs_true_error: "
                   f"{errs['pred_vs_true_error']:.2f}°")
    _scatter_panel(axs_row[2], true, gt, "true_deg", "gt_deg",
                   f"{label} (Epoch {epoch})\ngt_vs_true_error: "
                   f"{errs['gt_vs_true_error']:.2f}°")


def plot_doa_detail_scatter(
    logdir: str, save_path: Optional[str] = None, method: str = "NormMUSIC"
) -> str:
    """Best/last-checkpoint 2×3 pred/gt/true scatter grid over
    `<logdir>/doa_results/val_iter*.pkl` — the exact layout of
    reference/plot_DoA_detail_scatter.py:16-98 (per-epoch mean error in
    each title, identity diagonal, Best row above Last row). Returns the
    written PNG path (default `<logdir>/doa_detail_scatter.png`)."""
    import matplotlib.pyplot as plt

    paths = _checkpoint_pkls(os.path.join(logdir, "doa_results"))
    results, (best_path, _), (last_path, _) = _best_last(paths, method)
    epoch_map = {path: i + 1 for i, (path, _) in enumerate(results)}
    save_path = save_path or os.path.join(logdir, "doa_detail_scatter.png")
    fig, axs = plt.subplots(2, 3, figsize=(21, 14))
    for i, (path, label) in enumerate([(best_path, "Best"), (last_path, "Last")]):
        _panel_row(axs[i], path, method, label, epoch_map[path])
    fig.suptitle(f"DoA Results ({method}, AVR)", fontsize=22)
    plt.tight_layout(rect=[0, 0, 1, 0.95])
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close(fig)
    return save_path


def plot_das_detail_scatter(logdir: str, save_path: Optional[str] = None) -> str:
    """Best/last 4×3 grid for the two DAS readouts (soft-argmax rows 1-2,
    argmax rows 3-4) over `<logdir>/beamform_results/val_iter*.pkl` —
    reference/plot_DAS_detail_scatter.py:16-123. Returns the PNG path
    (default `<logdir>/das_detail_scatter.png`)."""
    import matplotlib.pyplot as plt

    paths = _checkpoint_pkls(os.path.join(logdir, "beamform_results"))
    save_path = save_path or os.path.join(logdir, "das_detail_scatter.png")
    fig, axs = plt.subplots(4, 3, figsize=(21, 28))
    for base_row, method, tag in (
        (0, "NormDAS_soft-argmax", "Soft"), (2, "NormDAS_argmax", "Argmax")
    ):
        results, (best_path, _), (last_path, _) = _best_last(paths, method)
        epoch_map = {path: i + 1 for i, (path, _) in enumerate(results)}
        for i, (path, label) in enumerate(
            [(best_path, f"{tag} - Best"), (last_path, f"{tag} - Last")]
        ):
            _panel_row(axs[base_row + i], path, method, label, epoch_map[path])
    fig.suptitle("DAS Results (Soft-argmax & Argmax)", fontsize=26)
    plt.tight_layout(rect=[0, 0, 1, 0.97])
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close(fig)
    return save_path
