"""Acoustic volume rendering, written out plainly.

A receiver at rx casts R rays; ray r samples S shells at distances
d_s = near + (far − near)·s/(S − 1). Each point gets an attenuation a and
a signal x[t], t < T, from the field. The signal of shell s is masked to
causal samples (t ≥ round(‖tx − point‖·fs/c), clamped to [0, T−1]) and to
all but its last round(d_s·fs/c) samples, scaled by the path loss of its
delay, transformed (rFFT) and shifted by the fractional delay d_s·fs/c
(phase e^{−2πik·delay/T}). Shells are alpha-composited along the ray
(α = 1 − e^{−a·Δd}, the last interval 1e10, transmittance the exclusive
product of 1 − α + 1e−6), and the rays are summed: the spectrum [F] of the
received impulse response, F = T/2 + 1.

The sum over rays is taken before the rFFT and the phase shift, which are
linear: y[s, t] = Σ_r w·(masked x), then Σ_s phase_s·rFFT(y[s]). Rays go in
blocks, so the [rays, S, T] signal never lives whole.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from benchmark.reference import field as field_ref


class Geometry:
    """Per-shell constants of a configuration (float64 on the host)."""

    def __init__(self, cfg: dict, T: int, device):
        rc = cfg["render"]
        S, fs, c = int(rc["n_samples"]), float(rc["fs"]), float(rc["speed"])
        d = np.linspace(0.0, 1.0, S) * (rc["far"] - rc["near"]) + rc["near"]
        delay = fs * d / c
        shift = np.round(delay).astype(np.int64)
        t = np.arange(T)
        tail = ((T - 1 - t)[None, :] - shift[:, None] > 0).astype(np.float64)
        near_field = int(0.1 / c * fs)
        grid = np.arange(max(int(T * 2.5), int(shift.max()) + T)) / fs * c
        loss = rc["pathloss"] / (grid + 1e-3)
        loss[:near_field] = loss[near_field + 1]
        pathloss = np.stack([loss[k:k + T] for k in shift])
        k = np.arange(T // 2 + 1)
        phase = np.exp(-2j * np.pi / T * k[None, :] * delay[:, None])

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.T, self.S, self.fs, self.c = T, S, fs, c
        self.d = f32(d)
        self.shell_scale = f32(tail * pathloss)  # [S, T]
        self.phase = torch.as_tensor(phase.astype(np.complex64), device=device)  # [S, F]
        self.lo = f32(np.broadcast_to(rc["xyz_min"], 3))
        self.hi = f32(np.broadcast_to(rc["xyz_max"], 3))

    def box(self, x: torch.Tensor) -> torch.Tensor:
        return 2.0 * (x - self.lo) / (self.hi - self.lo) - 1.0


def composite(attn: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Compositing weights [..., S] of attenuations [..., S] along a ray."""
    gaps = torch.cat([d[1:] - d[:-1], d.new_full((1,), 1e10)])
    alpha = 1.0 - torch.exp(-attn * gaps)
    keep = torch.cumprod(1.0 - alpha + 1e-6, dim=-1)
    trans = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]], dim=-1)
    return trans * alpha


def ray_block(p, fld: field_ref.Field, geo: Geometry, batch: Dict[str, torch.Tensor],
              dirs: torch.Tensor, precision: str) -> torch.Tensor:
    """y [bs, S, T]: the rays ``dirs`` [Rb, 3] composited and summed."""
    rx, tx = batch["pos_rx"], batch["pos_tx"]
    pts = rx[:, None, None, :] + dirs[None, :, None, :] * geo.d[None, None, :, None]  # [bs, Rb, S, 3]
    view = (-dirs)[None, :, None, :]
    tx_b = geo.box(tx)[:, None, None, :]
    heading = batch["rot_tx"][:, None, None, :] if fld.complex else None
    ch = batch["ch_idx"].long()[:, None, None] if "ch_idx" in batch else None
    attn, signal = field_ref.query(p, fld, geo.box(pts), view, tx_b, heading, ch, precision)
    onset = torch.clamp(torch.round(torch.linalg.norm(tx[:, None, None, :] - pts, dim=-1) * geo.fs / geo.c),
                        0, geo.T - 1)
    causal = (torch.arange(geo.T, device=pts.device) >= onset[..., None]).float()
    w = composite(attn, geo.d)  # [bs, Rb, S]
    return torch.einsum("brs,brst->bst", w, signal * causal * geo.shell_scale)


def spectrum(y: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """[bs, F, 2] (real, imaginary) from the ray-summed y [bs, S, T]."""
    spec = (torch.fft.rfft(y, dim=-1) * geo.phase).sum(dim=1)
    return torch.stack([spec.real, spec.imag], dim=-1)


def render(p, fld, geo, batch, dirs, precision: str, ray_block_size: int) -> torch.Tensor:
    """The spectra [bs, F, 2] of a batch, without gradients."""
    with torch.no_grad():
        y = sum(ray_block(p, fld, geo, batch, dirs[i:i + ray_block_size], precision)
                for i in range(0, dirs.shape[0], ray_block_size))
        return spectrum(y, geo)


def loss_and_grads(
    p: Dict[str, torch.Tensor], fld, geo, batch, dirs, precision: str, ray_block_size: int,
    loss_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, object]],
) -> Tuple[object, Dict[str, torch.Tensor], torch.Tensor]:
    """The loss of ``loss_fn(spectra)``, its gradient for every leaf of
    ``p``, and the spectra. The rays are rendered block by block without gradients; the
    gradient of the loss with respect to y comes from the small criterion,
    and each block is rendered again with gradients and pulled back by it."""
    blocks = [slice(i, i + ray_block_size) for i in range(0, dirs.shape[0], ray_block_size)]
    with torch.no_grad():
        y = sum(ray_block(p, fld, geo, batch, dirs[b], precision) for b in blocks)
    y = y.detach().requires_grad_(True)
    pred = spectrum(y, geo)
    total, bundle = loss_fn(pred)
    (g_y,) = torch.autograd.grad(total, [y])
    leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
    grads = {n: torch.zeros_like(t) for n, t in p.items()}
    for b in blocks:
        part = ray_block(leaves, fld, geo, batch, dirs[b], precision)
        got = torch.autograd.grad(part, list(leaves.values()), grad_outputs=g_y, allow_unused=True)
        for n, d in zip(leaves, got):
            if d is not None:
                grads[n] += d
    return bundle, grads, pred.detach()
