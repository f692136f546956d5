"""Dataset preparation utilities (a copy of ``avr_tpu/data/tools.py``).

* ``meshrir_split`` — shuffle a MeshRIR download's per-IR .npy files into
  train/ and test/ subdirectories with a 90/10 split
  (reference/tools/meshrir_split.py:27-32 semantics, seeded).
* ``inspect_npy`` / ``inspect_npz`` — quick shape/stat dumps
  (reference/check_data.py analog).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Tuple

import numpy as np


def meshrir_split(
    src_folder: str,
    dest_folder: str | None = None,
    test_frac: float = 0.1,
    seed: int = 0,
    move: bool = False,
) -> Tuple[List[str], List[str]]:
    """Split ir_*.npy files into train/test subdirs; returns (train, test)."""
    dest_folder = dest_folder or src_folder
    names = sorted(
        f for f in os.listdir(src_folder)
        if f.endswith(".npy") and not f.startswith("pos_")
    )
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(names))
    n_test = max(1, int(round(test_frac * len(names))))
    test_set = {names[i] for i in order[:n_test]}

    train_dir = os.path.join(dest_folder, "train")
    test_dir = os.path.join(dest_folder, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    op = shutil.move if move else shutil.copy
    train, test = [], []
    for name in names:
        sub = test_dir if name in test_set else train_dir
        op(os.path.join(src_folder, name), os.path.join(sub, name))
        (test if name in test_set else train).append(name)
    return train, test


def inspect_npy(path: str) -> Dict:
    a = np.load(path)
    return {
        "path": path, "shape": list(a.shape), "dtype": str(a.dtype),
        "min": float(a.min()), "max": float(a.max()),
        "mean": float(a.mean()), "abs_max": float(np.abs(a).max()),
    }


def inspect_npz(path: str) -> Dict[str, Dict]:
    z = np.load(path)
    out = {}
    for k in z.files:
        a = z[k]
        info = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if a.size and np.issubdtype(a.dtype, np.number):
            info.update(abs_max=float(np.abs(a).max()))
        out[k] = info
    return out
