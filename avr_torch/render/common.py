"""Shared rendering math (port of ``avr_tpu/render/common.py``).

The constants depend only on the render config, so ``make_consts``
computes them once in numpy (float64, exactly as the JAX package does)
and hands float32 tensors on ``device`` to the renderer, the scene box
too: a render copies nothing from the host, which a CUDA graph's capture
would refuse.
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
    xyz_min: torch.Tensor  # [3] the scene box's lower corner (``rc.xyz_min``)
    xyz_max: torch.Tensor  # [3] its upper corner


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
        xyz_min=t(np.asarray(rc.xyz_min, dtype=np.float32)),
        xyz_max=t(np.asarray(rc.xyz_max, dtype=np.float32)),
    )


class _CumprodOfPositives(torch.autograd.Function):
    """``torch.cumprod`` over the last axis of factors none of which is 0,
    with the backward autograd takes for such factors, reversed cumsum of
    out·g over x, bit for bit, but without its test for a zero factor: that
    test reads a flag back to the host, which stalls the step and is refused
    inside a CUDA graph's capture."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def compositing_weights(attn: torch.Tensor, d_vals: torch.Tensor) -> torch.Tensor:
    """Volume-rendering weights w = transmittance × alpha over the last axis.

    The last interval is 1e10 (opaque); transmittance is the exclusive
    cumprod of (1 − α + 1e−6), whose factors are at least 1e−6 since α ≤ 1.
    """
    dists = torch.cat([d_vals[1:] - d_vals[:-1], d_vals.new_full((1,), 1e10)])
    alpha = 1.0 - torch.exp(-attn * dists)
    one = torch.ones((*alpha.shape[:-1], 1), dtype=alpha.dtype, device=alpha.device)
    trans = _CumprodOfPositives.apply(torch.cat([one, 1.0 - alpha + 1e-6], dim=-1))[..., :-1]
    return trans * alpha


def head_delay_mask(dist_tx: torch.Tensor, fs: float, speed: float, T: int) -> torch.Tensor:
    """Causality mask [..., T]: 1 where t ≥ round(dist·fs/c) clamped to
    [0, T−1]. ``torch.round`` rounds half to even, as ``jnp.round`` does.
    The division is by a tensor: PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, which can round a delay within an ulp of
    half a sample the other way than the CPU, JAX and the signal-contraction
    kernel (``ops/signal_contract``) do."""
    delay = torch.clamp(torch.round(dist_tx * fs / dist_tx.new_full((), speed)), 0, T - 1)
    t = torch.arange(T, dtype=delay.dtype, device=delay.device)
    return (t >= delay[..., None]).to(torch.float32)
