"""Fused renderer, precomputed plan (port of ``avr_tpu/render/fused.py:124-352``).

  1. Per-point pass: the hash encodings and sigma features of ALL sample
     points are evaluated at once — each hash table sees one gather
     (kernel B) forward and one scatter-add (kernel A) backward per step —
     and the compositing weights w = transmittance·α are formed.
  2. Signal pass over S/C shell chunks: the matmul-only signal tail,
     causality masks, and the ray contraction y[b,c,t] = Σ_r w·mask·signal
     in fp32; then the rFFT and fractional phase shift of the ray-reduced
     [bs, C, T] signal, accumulated into the [bs, F] spectrum. Each chunk
     runs under ``torch.utils.checkpoint`` (the JAX ``remat=True``), so
     live memory stays at one chunk's [bs, R, C, T] in the backward too.

The streaming plan (bs·R·S > point_budget) is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from avr_torch import geometry
from avr_torch.config import RenderConfig
from avr_torch.models import field as field_lib
from avr_torch.render.common import RenderConsts, compositing_weights, head_delay_mask


def _pick_chunk(n_samples: int, requested: int) -> int:
    c = max(1, min(requested, n_samples))
    while n_samples % c:
        c -= 1
    return c


def render_fused(
    params,
    fstatic: field_lib.FieldStatic,
    consts: RenderConsts,
    rc: RenderConfig,
    rays_o: torch.Tensor,
    position_tx: torch.Tensor,
    direction_tx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    dirs: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
    shell_chunk: int = 1,
    remat: bool = True,
    point_budget: int = 4_000_000,
    ray_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render received IR spectra [bs, F, 2] (real, imag).

    rays_o / position_tx / direction_tx: [bs, 3] world receiver position,
    transmitter position and transmitter view. ``dirs`` [R, 3] overrides
    the ray directions (else drawn from ``generator``); ``ray_weights``
    [R] scales each ray's contribution.
    """
    if fstatic.variant != "complex":
        raise NotImplementedError("avr_torch renders the complex field variant only")
    if direction_tx is None:
        raise ValueError("complex field variant requires direction_tx")
    device = rays_o.device
    xyz_min = torch.tensor(rc.xyz_min, dtype=torch.float32, device=device)
    xyz_max = torch.tensor(rc.xyz_max, dtype=torch.float32, device=device)
    T = fstatic.signal_output_dim
    F = T // 2 + 1
    S = rc.n_samples
    C = _pick_chunk(S, shell_chunk)
    n_chunks = S // C

    if dirs is None:
        dirs = geometry.ray_directions(rc.n_azi, rc.n_ele, generator=generator, device=device)
    R = dirs.shape[0]
    bs = rays_o.shape[0]
    if bs * R * S > point_budget:
        raise NotImplementedError(
            f"bs·R·S = {bs * R * S} > point_budget {point_budget}: the streaming "
            "render plan is not ported yet"
        )
    d_vals = consts.d_vals
    tx_n = geometry.normalize_points(position_tx, xyz_min, xyz_max)  # [bs, 3]

    # per-ray / per-batch signal context
    h_ray, h_batch = field_lib.signal_context(
        params, fstatic, dirs, tx_n, tx_view=direction_tx, compute_dtype=compute_dtype
    )
    h_extra = h_ray[None, :, None, :] + h_batch[:, None, None, :]  # [bs, R, 1, W]

    # pass 1: per-point features + attenuation
    pts_all = geometry.ray_points(rays_o, dirs, d_vals)  # [bs, R, S, 3]
    pts_n_all = geometry.normalize_points(pts_all, xyz_min, xyz_max)
    sigma_feat, attn, psig = field_lib.point_features(
        params, fstatic, pts_n_all, tx=tx_n[:, None, None, :], compute_dtype=compute_dtype
    )
    dist_all = torch.linalg.norm(position_tx[:, None, None, :] - pts_all, dim=-1)  # [bs, R, S]
    w = compositing_weights(attn[..., 0], d_vals)  # [bs, R, S]
    if ray_weights is not None:
        w = w * ray_weights.to(w.dtype)[None, :, None]

    # pass 2: signal tail + ray contraction + spectrum, chunk by chunk
    def chunk(feat_c, psig_c, dist_c, w_c, tail_c, pl_c, ph_re, ph_im):
        signal = field_lib.signal_tail_from_features(
            params, fstatic, feat_c, psig_c, h_extra, compute_dtype=compute_dtype
        )  # [bs, R, C, T] fp32
        head = head_delay_mask(dist_c, rc.fs, rc.speed, T)
        masked = signal * head * tail_c[None, None, :, :]
        y = torch.einsum("brc,brct->bct", w_c, masked)  # [bs, C, T] fp32
        spec = torch.fft.rfft(y * pl_c[None, :, :], dim=-1)  # [bs, C, F]
        re = spec.real * ph_re - spec.imag * ph_im
        im = spec.real * ph_im + spec.imag * ph_re
        return re.sum(dim=1), im.sum(dim=1)

    acc_re = torch.zeros((bs, F), dtype=torch.float32, device=device)
    acc_im = torch.zeros((bs, F), dtype=torch.float32, device=device)
    for i in range(n_chunks):
        s = slice(i * C, (i + 1) * C)
        args = (
            sigma_feat[:, :, s], psig[:, :, s], dist_all[:, :, s], w[:, :, s],
            consts.tail_mask[s], consts.pathloss[s], consts.phase_re[s], consts.phase_im[s],
        )
        if remat and torch.is_grad_enabled():
            re, im = checkpoint(chunk, *args, use_reentrant=False)
        else:
            re, im = chunk(*args)
        acc_re = acc_re + re
        acc_im = acc_im + im
    return torch.stack([acc_re, acc_im], dim=-1)
