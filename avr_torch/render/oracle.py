"""Reference-faithful renderer, the numerical oracle (port of
``avr_tpu/render/oracle.py``).

One batched field query over all bs·R·S points (``field.apply``),
causality masks, per-shell path loss, rFFT and fractional phase delay,
alpha-compositing and the sum over rays. It materializes the [bs, R, S, F]
complex spectrum, as the reference does, so it is for small shapes only:
tests and parity checks against ``render_fused``.
"""

from __future__ import annotations

from typing import Optional

import torch

from avr_torch import geometry
from avr_torch.config import RenderConfig
from avr_torch.models import field as field_lib
from avr_torch.render.common import RenderConsts, compositing_weights, head_delay_mask


def render_oracle(
    params,
    fstatic: field_lib.FieldStatic,
    consts: RenderConsts,
    rc: RenderConfig,
    rays_o: torch.Tensor,
    position_tx: torch.Tensor,
    direction_tx: Optional[torch.Tensor] = None,
    ch_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    dirs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render received IR spectra [bs, F, 2] (real, imag), F = T//2+1.

    rays_o / position_tx: [bs, 3] world coordinates; direction_tx: [bs, 3]
    unit (complex variant); ch_idx: [bs] integer channels or None.
    ``dirs`` [R, 3] overrides the ray directions, else they are drawn with
    ``generator`` (None: the deterministic grid).
    """
    device = rays_o.device
    xyz_min = torch.tensor(rc.xyz_min, dtype=torch.float32, device=device)
    xyz_max = torch.tensor(rc.xyz_max, dtype=torch.float32, device=device)
    T = fstatic.signal_output_dim
    if dirs is None:
        dirs = geometry.ray_directions(rc.n_azi, rc.n_ele, generator=generator, device=device)
    d_vals = consts.d_vals
    pts = geometry.ray_points(rays_o, dirs, d_vals)  # [bs, R, S, 3]

    pts_n = geometry.normalize_points(pts, xyz_min, xyz_max)
    view = (-dirs)[None, :, None, :].expand(pts.shape)
    tx_n = geometry.normalize_points(position_tx, xyz_min, xyz_max)
    tx_b = tx_n[:, None, None, :].expand(pts.shape)
    tx_view_b = None if direction_tx is None else direction_tx[:, None, None, :].expand(pts.shape)
    ch_b = None if ch_idx is None else ch_idx[:, None, None].expand(pts.shape[:-1])

    attn, signal = field_lib.apply(params, fstatic, pts_n, view, tx_b, tx_view=tx_view_b, ch_idx=ch_b)
    attn = attn[..., 0]  # [bs, R, S]

    # causality masks (reference/renderer.py:79-90)
    signal = signal * consts.tail_mask[None, None, :, :]
    dist_tx = torch.linalg.norm(position_tx[:, None, None, :] - pts, dim=-1)
    signal = signal * head_delay_mask(dist_tx, rc.fs, rc.speed, T)

    # path loss, rFFT, fractional phase delay (renderer.py:96-109)
    spec = torch.fft.rfft(signal * consts.pathloss[None, None, :, :], dim=-1)
    spec = spec * torch.complex(consts.phase_re, consts.phase_im)[None, None, :, :]

    # alpha-composite along rays, sum over the sphere (:115-121)
    w = compositing_weights(attn, d_vals)  # [bs, R, S]
    ray_sig = torch.sum(spec * w[..., None].to(spec.dtype), dim=-2)  # [bs, R, F]
    out = torch.sum(ray_sig, dim=-2)  # [bs, F]
    return torch.stack([out.real, out.imag], dim=-1)
