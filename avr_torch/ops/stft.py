"""Short-time Fourier transform (port of ``avr_tpu/ops/stft.py``).

The conventions of ``torch.stft`` as the reference's loss stack used
them: centred frames with n_fft//2 reflect padding, a ``win_length <
n_fft`` window zero-padded symmetrically, periodic Hann windows, output
[..., n_freq, n_frames]. Written as framing + one batched rFFT, like the
JAX version, so both compute the same sums.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from avr_torch.ops.take import take


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Hann window, identical to torch.hann_window(win_length).

    Built once per (length, dtype, device) and shared: a train step then
    copies nothing from the host (a CUDA graph's capture refuses such a
    copy). Callers do not write into it."""
    n = np.arange(win_length)
    return torch.as_tensor(0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length)), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _frame_index(length: int, n_fft: int, hop: int, center: bool, pad_mode: str, device) -> torch.Tensor:
    """The samples of each frame, int64 [frames, n_fft], on ``device``, built
    once per shape and device as ``hann_window`` is. The padding is a static
    index map built by numpy's pad, so pads longer than the signal reflect
    repeatedly, as jnp.pad does (torch's reflect pad refuses them)."""
    src = np.arange(length)
    if center:
        src = np.pad(src, n_fft // 2, mode=pad_mode)
    n_frames = 1 + (src.shape[0] - n_fft) // hop
    return torch.as_tensor(src[np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]], device=device)


def _prepare_window(window, n_fft: int, win_length: Optional[int], dtype, device) -> torch.Tensor:
    win_length = win_length or n_fft
    if window is None:
        window = torch.ones((win_length,), dtype=dtype, device=device)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = Fn.pad(window, (left, n_fft - win_length - left))
    return window.to(dtype)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Complex STFT of real x [..., T] → [..., n_fft//2+1, frames]."""
    hop = hop_length or n_fft // 4
    win = _prepare_window(window, n_fft, win_length, x.dtype, x.device)
    idx = _frame_index(x.shape[-1], n_fft, hop, center, pad_mode, x.device)
    frames = take(x, x.dim() - 1, idx) * win  # [..., frames, n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.transpose(-1, -2)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
    center: bool = True,
) -> torch.Tensor:
    """Clamped magnitude sqrt(max(re²+im², eps)) — auraloss's convention."""
    s = stft(x, n_fft, hop_length, win_length, window, center=center)
    return torch.sqrt(torch.clamp(s.real**2 + s.imag**2, min=eps))
