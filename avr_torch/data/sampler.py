"""Host-side batch sampling (a copy of ``avr_tpu/data/sampler.py``).

Replaces torch DataLoader worker processes (reference/avr_runner.py:94-96)
with simple epoch-shuffled index batching over the in-memory Dataset:
batches are dense numpy slices, which the caller moves to the device. Train-time RAF position jitter
(reference/datasets_loader.py:212-214) is applied here at draw time.

``group8`` mode yields whole 8-microphone groups (consecutive rows with
ch_idx 0..7) so the DAS losses see one coherent array per batch — the
reference instead relies on batch_size=8 with shuffle, which mixes
microphones from different groups (SURVEY.md quirks); shuffled mode
reproduces that if wanted.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from avr_torch.data.loaders import Dataset


class BatchSampler:
    def __init__(
        self,
        data: Dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        jitter: bool = False,
        jitter_std: float = 0.1,
        group8: bool = False,
        drop_last: bool = True,
    ):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.jitter = jitter and data.dataset_type == "RAF"
        self.jitter_std = jitter_std
        self.group8 = group8 and data.has_channels
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        if self.group8:
            if len(data) % 8:
                raise ValueError("group8 sampling requires a multiple-of-8 dataset")
            if batch_size % 8:
                raise ValueError("group8 sampling requires batch_size % 8 == 0")

    def __len__(self) -> int:
        n = len(self.data)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.data)
        if self.group8:
            groups = np.arange(n // 8)
            if self.shuffle:
                self._rng.shuffle(groups)
            order = (groups[:, None] * 8 + np.arange(8)[None, :]).reshape(-1)
        else:
            order = np.arange(n)
            if self.shuffle:
                self._rng.shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
            if len(idx) == 0:
                return
            yield self.gather(idx)

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        d = self.data
        rx = d.pos_rx[idx]
        tx = d.pos_tx[idx]
        if self.jitter:
            rx = rx + self._rng.normal(0, self.jitter_std, rx.shape).astype(np.float32)
            tx = tx + self._rng.normal(0, self.jitter_std, tx.shape).astype(np.float32)
        batch = {
            "wave": _c64_to_ri(d.wave[idx]),
            "pos_rx": rx,
            "pos_tx": tx,
        }
        if d.rot_tx is not None:
            batch["rot_tx"] = d.rot_tx[idx]
        if d.ch_idx is not None:
            batch["ch_idx"] = d.ch_idx[idx]
        return batch


def _c64_to_ri(x: np.ndarray) -> np.ndarray:
    """complex64 [N, F] → float32 [N, F, 2] (the renderer's output layout)."""
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
