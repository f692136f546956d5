"""Shared rendering math (port of ``avr_tpu/render/common.py``).

The constants depend only on the render config, so ``make_consts``
computes them once in numpy (float64, exactly as the JAX package does)
and hands float32 tensors on ``device`` to the renderer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from avr_torch.config import RenderConfig
from avr_torch.device import resolve_device


class RenderConsts(NamedTuple):
    """Static per-config rendering constants (T samples, S shells, F = T//2+1)."""

    d_vals: torch.Tensor  # [S] radial sample distances
    pts2rx: torch.Tensor  # [S] fractional delay (samples) point→receiver
    shift: torch.Tensor  # [S] int32 rounded delay, drives masks & path loss
    tail_mask: torch.Tensor  # [S, T] zero out the last `shift` samples
    pathloss: torch.Tensor  # [S, T] per-shell 1/d attenuation slice
    phase_re: torch.Tensor  # [S, F] Re e^{−j2πk·pts2rx/T}
    phase_im: torch.Tensor  # [S, F] Im e^{−j2πk·pts2rx/T}


def make_consts(rc: RenderConfig, signal_len: int, device="cuda") -> RenderConsts:
    device = resolve_device(device)
    T = int(signal_len)
    F = T // 2 + 1
    S = rc.n_samples

    d_vals = np.linspace(0.0, 1.0, S, dtype=np.float64) * (rc.far - rc.near) + rc.near
    pts2rx = rc.fs * d_vals / rc.speed
    shift = np.round(pts2rx).astype(np.int64)  # half-to-even, like torch.round

    t_rev = np.arange(T - 1, -1, -1, dtype=np.float64)[None, :]
    tail = (t_rev - shift[:, None] > 0).astype(np.float32)  # [S, T]

    # Path loss over a 2.5·T grid (extended so every shell slice is full),
    # with the near-field clamp of the first int(0.1/c·fs) samples.
    prev = int(0.1 / rc.speed * rc.fs)
    grid_len = max(int(T * 2.5), int(shift.max()) + T)
    grid = np.arange(0, grid_len, dtype=np.float64) / rc.fs * rc.speed
    pl = rc.pathloss / (grid + 1e-3)
    pl[0:prev] = pl[prev + 1]
    pl_shell = np.stack([pl[s : s + T] for s in shift]).astype(np.float32)

    # The UNROUNDED pts2rx drives the fractional-delay phase.
    k = np.arange(F, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi / T * k * pts2rx[:, None]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return RenderConsts(
        d_vals=t(d_vals.astype(np.float32)),
        pts2rx=t(pts2rx.astype(np.float32)),
        shift=t(shift, torch.int32),
        tail_mask=t(tail),
        pathloss=t(pl_shell),
        phase_re=t(np.cos(ang).astype(np.float32)),
        phase_im=t(np.sin(ang).astype(np.float32)),
    )


def compositing_weights(attn: torch.Tensor, d_vals: torch.Tensor) -> torch.Tensor:
    """Volume-rendering weights w = transmittance × alpha over the last axis.

    The last interval is 1e10 (opaque); transmittance is the exclusive
    cumprod of (1 − α + 1e−6).
    """
    dists = torch.cat([d_vals[1:] - d_vals[:-1], d_vals.new_full((1,), 1e10)])
    alpha = 1.0 - torch.exp(-attn * dists)
    one = torch.ones((*alpha.shape[:-1], 1), dtype=alpha.dtype, device=alpha.device)
    trans = torch.cumprod(torch.cat([one, 1.0 - alpha + 1e-6], dim=-1), dim=-1)[..., :-1]
    return trans * alpha


def head_delay_mask(dist_tx: torch.Tensor, fs: float, speed: float, T: int) -> torch.Tensor:
    """Causality mask [..., T]: 1 where t ≥ round(dist·fs/c) clamped to
    [0, T−1]. ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    delay = torch.clamp(torch.round(dist_tx * fs / speed), 0, T - 1)
    t = torch.arange(T, dtype=delay.dtype, device=delay.device)
    return (t >= delay[..., None]).to(torch.float32)
