"""Dataset loading for the four reference formats (port of
``avr_tpu/data/loaders.py``, numpy only).

Numpy re-design of reference/datasets_loader.py (WaveLoader, :10-220):
every dataset is small enough to live in host memory as flat arrays, with
targets stored as the complex64 rFFT of seq_len-sample IRs
(datasets_loader.py:55,81,107,137,167). Formats:

  * MeshRIR  — per-IR .npy + pos_mic.npy/pos_src.npy, train/test subdirs,
    48 kHz strided to fs, window starting at sample 9100/down_rate
    (datasets_loader.py:61-91);
  * Simu     — .npz files with ir/position_rx/position_tx, sorted-name
    90/10 split (:93-116);
  * Real_env — train_test_split.pkl listing .npz files with optional
    per-file ch_idx (:118-149);
  * RAF      — per-folder rir.wav + rx_pos.txt + tx_pos.txt
    (quaternion + position, axes permuted [0,2,1]) under train/ and
    test/ subdirs (:151-195). Train-time ±N(0, 0.1²) position jitter is
    applied by the sampler, not here.

The JAX package can hand the npy/wav decode to its C++ loader
(``avr_tpu/native``); the port decodes with numpy, which gives the same
arrays.
"""

from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from avr_torch.data import wav as wav_lib
from avr_torch.geometry import quaternion_to_direction


@dataclass
class Dataset:
    """In-memory dataset: rFFT targets + geometry."""

    wave: np.ndarray  # [N, F] complex64 rFFT of seq_len IRs
    pos_rx: np.ndarray  # [N, 3] float32
    pos_tx: np.ndarray  # [N, 3] float32
    rot_tx: Optional[np.ndarray] = None  # [N, 3] float32 (RAF only)
    ch_idx: Optional[np.ndarray] = None  # [N] int32 (multi-channel sets)
    dataset_type: str = "Simu"
    fs: int = 16000
    seq_len: int = 2048

    def __len__(self) -> int:
        return self.wave.shape[0]

    @property
    def has_tx_direction(self) -> bool:
        return self.rot_tx is not None

    @property
    def has_channels(self) -> bool:
        return self.ch_idx is not None


def load_dataset(
    base_folder: str,
    dataset_type: str = "MeshRIR",
    eval: bool = False,
    seq_len: int = 2048,
    fs: int = 16000,
) -> Dataset:
    """Load one split (same signature as the reference's WaveLoader)."""
    if dataset_type == "MeshRIR":
        return _load_mesh_rir(base_folder, eval, seq_len, fs)
    if dataset_type == "Simu":
        return _load_simu(base_folder, eval, seq_len, fs)
    if dataset_type == "Real_env":
        return _load_real_env(base_folder, eval, seq_len, fs)
    if dataset_type == "RAF":
        return _load_raf(base_folder, eval, seq_len, fs)
    raise ValueError(f"unsupported dataset type {dataset_type!r}")


def _pack(
    waves: List[np.ndarray],
    rx: List[np.ndarray],
    tx: List[np.ndarray],
    rot: Optional[List[np.ndarray]],
    ch: Optional[List[int]],
    dataset_type: str,
    fs: int,
    seq_len: int,
) -> Dataset:
    return Dataset(
        wave=np.stack(waves).astype(np.complex64),
        pos_rx=np.stack(rx).astype(np.float32),
        pos_tx=np.stack(tx).astype(np.float32),
        rot_tx=np.stack(rot).astype(np.float32) if rot else None,
        ch_idx=np.asarray(ch, np.int32) if ch else None,
        dataset_type=dataset_type,
        fs=fs,
        seq_len=seq_len,
    )


def _load_mesh_rir(base_folder, eval, seq_len, fs) -> Dataset:
    down = 48000 // fs
    st = int(9100 / down)  # fixed IR window start (datasets_loader.py:64-65)
    folder = os.path.join(base_folder, "test" if eval else "train")
    names = sorted(f for f in os.listdir(folder) if f.endswith(".npy"))
    paths = [os.path.join(folder, n) for n in names]
    rx_pos = np.load(os.path.join(base_folder, "pos_mic.npy"))
    tx_pos = np.load(os.path.join(base_folder, "pos_src.npy"))[0]

    audio = _batched_npy(paths, seq_len, down, st)
    waves = list(np.fft.rfft(audio, axis=-1))
    rxs = [rx_pos[int(n.split("_")[1].split(".")[0])] for n in names]
    txs = [tx_pos] * len(names)
    return _pack(waves, rxs, txs, None, None, "MeshRIR", fs, seq_len)


def _batched_npy(paths, seq_len, stride, start) -> np.ndarray:
    """Decode per-IR .npy files: [n, seq_len] float32, zero-padded."""
    out = np.zeros((len(paths), seq_len), np.float32)
    for i, p in enumerate(paths):
        a = np.load(p)[0, ::stride][start : start + seq_len]
        out[i, : len(a)] = a
    return out


def _load_simu(base_folder, eval, seq_len, fs) -> Dataset:
    names = sorted(f for f in os.listdir(base_folder) if f.endswith(".npz"))
    cut = int(0.9 * len(names))
    names = names[cut:] if eval else names[:cut]
    waves, rxs, txs = [], [], []
    for name in names:
        meta = np.load(os.path.join(base_folder, name))
        waves.append(np.fft.rfft(meta["ir"][:seq_len]))
        rxs.append(meta["position_rx"])
        txs.append(meta["position_tx"])
    return _pack(waves, rxs, txs, None, None, "Simu", fs, seq_len)


def _load_real_env(base_folder, eval, seq_len, fs) -> Dataset:
    with open(os.path.join(base_folder, "train_test_split.pkl"), "rb") as f:
        split = pickle.load(f)
    files = split["test" if eval else "train"]
    waves, rxs, txs, chs = [], [], [], []
    for fp in files:
        if not os.path.isabs(fp):
            fp = os.path.join(base_folder, fp)
        meta = np.load(fp)
        waves.append(np.fft.rfft(meta["ir"][:seq_len]))
        rxs.append(meta["position_rx"])
        txs.append(meta["position_tx"])
        if "ch_idx" in meta:
            chs.append(int(meta["ch_idx"]))
    return _pack(waves, rxs, txs, None, chs or None, "Real_env", fs, seq_len)


def _load_raf(base_folder, eval, seq_len, fs) -> Dataset:
    folders = sorted(glob.glob(os.path.join(base_folder, "test" if eval else "train", "*")))
    down = int(48000 / fs)
    wav_paths = [os.path.join(f, "rir.wav") for f in folders]
    audio_all = _batched_wav(wav_paths, seq_len, down)
    waves, rxs, txs, rots = [], [], [], []
    for i, folder in enumerate(folders):
        waves.append(np.fft.rfft(audio_all[i]))
        rxs.append(_read_numbers(os.path.join(folder, "rx_pos.txt"))[[0, 2, 1]])
        tx_info = _read_numbers(os.path.join(folder, "tx_pos.txt"))
        rots.append(np.asarray(quaternion_to_direction(tx_info[:4])))
        txs.append(tx_info[4:][[0, 2, 1]])
    return _pack(waves, rxs, txs, rots, None, "RAF", fs, seq_len)


def _batched_wav(paths, seq_len, stride) -> np.ndarray:
    """Decode WAV files: [n, seq_len] float32, zero-padded."""
    out = np.zeros((len(paths), seq_len), np.float32)
    for i, p in enumerate(paths):
        a, _sr = wav_lib.read_wav(p)
        a = a[: seq_len * stride : stride]
        out[i, : len(a)] = a
    return out


def _read_numbers(path: str) -> np.ndarray:
    vals: List[float] = []
    with open(path) as f:
        for line in f:
            vals.extend(float(v) for v in line.split(","))
    return np.asarray(vals)
