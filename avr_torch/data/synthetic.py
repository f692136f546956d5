"""Synthetic shoebox-room IR generation (image-source method); a copy of
``avr_tpu/data/synthetic.py``, numpy only.

The reference trains on external datasets (MeshRIR downloads, RAF scans,
pyroomacoustics simulations). This module generates physically-plausible
room impulse responses from scratch — a rectangular room, image-source
reflections up to a configurable order, fractional-delay sinc pulses,
1/d path loss and per-reflection absorption — and can write them to disk
in any of the four reference dataset formats, so the entire training +
DoA-evaluation stack runs self-contained (tests, demos, benchmarks).

Also builds 8-microphone circular-array scenes (radius 0.0365 m, φ₀=π/2 —
matching reference/plot_eval.py:56-64) with per-file ch_idx for the
multi-channel / DAS / DoA pipelines.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from avr_torch.data import wav as wav_lib


@dataclass
class RoomSpec:
    size: Tuple[float, float, float] = (6.0, 5.0, 3.0)
    absorption: float = 0.35  # energy absorption per wall bounce
    max_order: int = 3  # image-source reflection order
    speed: float = 343.8
    fs: int = 16000
    seq_len: int = 1600


def _images_1d(x: float, L: float, order: int):
    """Image-source coordinates and bounce counts along one axis.

    Images are at (−1)^p·x + 2nL; the reflection count along the axis is
    2|n| for the even-parity image (p=0) and |2n−1| for odd (p=1).
    Returns (positions, bounces) arrays.
    """
    pos, bnc = [], []
    for n in range(-order, order + 1):
        pos.append(2 * n * L + x)
        bnc.append(2 * abs(n))
        pos.append(2 * n * L - x)
        bnc.append(abs(2 * n - 1))
    return np.asarray(pos), np.asarray(bnc)


def simulate_ir(
    room: RoomSpec, rx: np.ndarray, tx: np.ndarray, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Impulse response rx←tx in the shoebox room: [seq_len] float32.

    Each image source contributes a Hann-windowed-sinc fractional-delay
    pulse scaled by reflection_gain^bounces / (4π d).
    """
    L = np.asarray(room.size)
    ix, bx = _images_1d(tx[0], L[0], room.max_order)
    iy, by = _images_1d(tx[1], L[1], room.max_order)
    iz, bz = _images_1d(tx[2], L[2], room.max_order)

    T = room.seq_len
    ir = np.zeros(T, np.float64)
    t_idx = np.arange(T)
    reflect_gain = np.sqrt(1.0 - room.absorption)

    for a, nx in enumerate(ix):
        for b, ny in enumerate(iy):
            for c, nz in enumerate(iz):
                n_bounce = bx[a] + by[b] + bz[c]
                if n_bounce > room.max_order:
                    continue
                d = np.linalg.norm(np.asarray([nx, ny, nz]) - rx)
                delay = d / room.speed * room.fs
                if delay >= T - 4:
                    continue
                amp = reflect_gain**n_bounce / (4 * np.pi * max(d, 0.1))
                # 8-tap Hann-windowed sinc fractional delay
                lo = max(0, int(np.floor(delay)) - 3)
                hi = min(T, int(np.floor(delay)) + 5)
                tt = t_idx[lo:hi] - delay
                ir[lo:hi] += amp * np.sinc(tt) * 0.5 * (1 + np.cos(np.pi * tt / 4.0))
    return ir.astype(np.float32)


def random_positions(
    room: RoomSpec, n: int, rng: np.random.Generator, margin: float = 0.5
) -> np.ndarray:
    lo = np.asarray([margin] * 3)
    hi = np.asarray(room.size) - margin
    return (lo + rng.uniform(size=(n, 3)) * (hi - lo)).astype(np.float32)


def circular_array(center: np.ndarray, radius: float = 0.0365, m: int = 8) -> np.ndarray:
    """8-mic circular array at φ₀=π/2 (reference/plot_eval.py:56-60)."""
    phi = np.linspace(np.pi / 2, np.pi / 2 + 2 * np.pi, m + 1)[:-1]
    offs = np.stack([radius * np.cos(phi), radius * np.sin(phi), np.zeros(m)], -1)
    return (center[None, :] + offs).astype(np.float32)


# ----------------------------------------------------------------------
# Dataset writers (reference on-disk formats)
# ----------------------------------------------------------------------
def write_simu_dataset(
    out_dir: str, room: RoomSpec, n: int, seed: int = 0
) -> None:
    """Simu format: flat .npz files (reference/datasets_loader.py:93-116)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    tx = random_positions(room, 1, rng)[0]
    rxs = random_positions(room, n, rng)
    for i, rx in enumerate(rxs):
        ir = simulate_ir(room, rx, tx)
        np.savez(
            os.path.join(out_dir, f"ir_{i:05d}.npz"),
            ir=ir, position_rx=rx, position_tx=tx,
        )


def write_real_env_dataset(
    out_dir: str, room: RoomSpec, n_groups: int, seed: int = 0, test_frac: float = 0.2
) -> None:
    """Real_env format: 8-mic circular groups + train_test_split.pkl
    (reference/datasets_loader.py:118-149). Rows within a group are the 8
    microphones (ch_idx 0..7), group order preserved in the split lists."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    tx = random_positions(room, 1, rng)[0]
    centers = random_positions(room, n_groups, rng)
    files = []
    for g, center in enumerate(centers):
        mics = circular_array(center)
        group_files = []
        for ch, rx in enumerate(mics):
            ir = simulate_ir(room, rx, tx)
            name = f"group{g:04d}_ch{ch}.npz"
            np.savez(
                os.path.join(out_dir, name),
                ir=ir, position_rx=rx, position_tx=tx, ch_idx=np.int64(ch),
            )
            group_files.append(name)
        files.append(group_files)
    n_test = max(1, int(round(test_frac * n_groups)))
    split = {
        "train": [f for grp in files[:-n_test] for f in grp],
        "test": [f for grp in files[-n_test:] for f in grp],
    }
    with open(os.path.join(out_dir, "train_test_split.pkl"), "wb") as f:
        pickle.dump(split, f)


def write_meshrir_dataset(
    out_dir: str, room: RoomSpec, n: int, seed: int = 0, test_frac: float = 0.1
) -> None:
    """MeshRIR format: 48 kHz per-IR .npy + pos files, train/test dirs
    (reference/datasets_loader.py:61-91, tools/meshrir_split.py). IRs are
    synthesized at the target fs and upsampled by zero-order hold to
    48 kHz so the loader's strided downsample recovers them."""
    rng = np.random.default_rng(seed)
    down = 48000 // room.fs
    st = int(9100 / down)
    tx = random_positions(room, 1, rng)[0]
    rxs = random_positions(room, n, rng)
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)
    np.save(os.path.join(out_dir, "pos_mic.npy"), rxs)
    np.save(os.path.join(out_dir, "pos_src.npy"), tx[None, :])
    n_test = max(1, int(round(test_frac * n)))
    for i, rx in enumerate(rxs):
        ir = simulate_ir(room, rx, tx)
        full = np.zeros((1, (st + room.seq_len) * down + 64), np.float32)
        full[0, st * down :: down][: room.seq_len] = ir
        sub = "test" if i >= n - n_test else "train"
        np.save(os.path.join(out_dir, sub, f"ir_{i:05d}.npy"), full)


def write_raf_array_dataset(
    out_dir: str,
    room: RoomSpec,
    n_train: int,
    n_test_groups: int,
    seed: int = 0,
) -> None:
    """RAF on-disk format with an ARRAY-STRUCTURED test split.

    Train samples are random single receivers (the reference RAF
    training regime, datasets_loader.py:151-195); the test split is
    ``n_test_groups`` circular 8-mic arrays written as CONSECUTIVE
    sample folders, so `run_doa_on_npz`'s 8-row grouping of the val npz
    recovers real array groups, and a RAF run can report a DoA metric
    beside the waveform metrics.
    """
    rng = np.random.default_rng(seed)
    down = int(48000 / room.fs)
    tx = random_positions(room, 1, rng)[0]
    train_rx = random_positions(room, n_train, rng)
    centers = random_positions(room, n_test_groups, rng, margin=1.0)
    test_rx = np.concatenate([circular_array(c) for c in centers])

    def _write(sub: str, i: int, rx: np.ndarray) -> None:
        folder = os.path.join(out_dir, sub, f"sample_{i:05d}")
        os.makedirs(folder, exist_ok=True)
        ir = simulate_ir(room, rx, tx)
        full = np.zeros(room.seq_len * down, np.float32)
        full[::down] = ir
        wav_lib.write_wav(os.path.join(folder, "rir.wav"), full, 48000)
        with open(os.path.join(folder, "rx_pos.txt"), "w") as f:
            f.write(",".join(str(v) for v in rx[[0, 2, 1]]))
        with open(os.path.join(folder, "tx_pos.txt"), "w") as f:
            quat = [0.0, 0.0, 0.0, 1.0]  # identity orientation
            f.write(",".join(str(v) for v in quat + list(tx[[0, 2, 1]])))

    for i, rx in enumerate(train_rx):
        _write("train", i, rx)
    for i, rx in enumerate(test_rx):
        _write("test", i, rx)


def write_raf_dataset(
    out_dir: str, room: RoomSpec, n: int, seed: int = 0, test_frac: float = 0.2
) -> None:
    """RAF format: per-folder rir.wav (48 kHz) + rx_pos.txt + tx_pos.txt
    (reference/datasets_loader.py:151-195)."""
    rng = np.random.default_rng(seed)
    down = int(48000 / room.fs)
    tx = random_positions(room, 1, rng)[0]
    rxs = random_positions(room, n, rng)
    n_test = max(1, int(round(test_frac * n)))
    for i, rx in enumerate(rxs):
        sub = "test" if i >= n - n_test else "train"
        folder = os.path.join(out_dir, sub, f"sample_{i:05d}")
        os.makedirs(folder, exist_ok=True)
        ir = simulate_ir(room, rx, tx)
        full = np.zeros(room.seq_len * down, np.float32)
        full[::down] = ir
        wav_lib.write_wav(os.path.join(folder, "rir.wav"), full, 48000)
        # positions stored in the RAF axis convention: loader permutes
        # [0,2,1], so write the inverse permutation.
        with open(os.path.join(folder, "rx_pos.txt"), "w") as f:
            f.write(",".join(str(v) for v in rx[[0, 2, 1]]))
        with open(os.path.join(folder, "tx_pos.txt"), "w") as f:
            quat = [0.0, 0.0, 0.0, 1.0]  # identity orientation
            f.write(",".join(str(v) for v in quat + list(tx[[0, 2, 1]])))
