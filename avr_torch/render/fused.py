"""Fused renderer (port of ``avr_tpu/render/fused.py``).

Same math as ``render/oracle.py``, without the [bs, R, S, F] spectrum:

  1. Attenuation. In the **precomputed** plan (bs·R·S ≤ point_budget) the
     hash encodings and sigma features of ALL sample points are evaluated
     at once, so each hash table sees one encode forward and one backward
     launch per step. In the **streaming** plan only the sigma branch runs,
     shell chunk by shell chunk, keeping the [bs, R, S] attenuation.
     Then the compositing weights w = transmittance·α are formed.
  2. Signal pass over S/C shell chunks: the signal tail (from the stored
     features, or with the sigma branch recomputed per chunk in the
     streaming plan) up to its last matmul, its first layer taking the
     per-ray and per-batch context (``field.signal_context``) as they are,
     never as one [(K,) bs, R, 1, W] tensor; then ``ops.signal_contract``:
     the last layer's bias, the causality masks and the ray contraction
     y[b,c,t] = Σ_r w·mask·signal in fp32, one kernel each way on the card;
     then the rFFT and fractional phase shift of the ray-reduced [bs, C, T]
     signal, accumulated into the [bs, F] spectrum.

With the tracer of ``utils.profiling`` on, the render records the spans
``render.context``, ``render.attenuation`` (pass 1 with the compositing
weights) and ``render.signal`` (pass 2), and in it one ``render.chunk`` per
signal chunk, opened inside the checkpointed function so that the
backward's recompute records it again; the counter ``render.chunk_calls``
counts those calls, recomputes included. The counter ``render.feature_splits``
counts the calls whose precomputed per-point tensors were split into more
than one chunk (once a call; the streaming plan never counts).

With ``remat`` each chunk of either pass runs under
``torch.utils.checkpoint`` (the JAX ``remat=True``): its activations are
recomputed in the backward, so live memory stays at one chunk's
[bs, R, C, T]; a chunk's contraction saves only the signal's last matmul.
In the streaming plan that recomputes the chunk's encodes too.

Population training: with params stacked over K trials (leading axis on
every leaf) the geometry stays shared (points, distances, masks, path
loss, phase) and the field's outputs carry K. The compositing weights and
the signal pass fold (K, bs) into one leading axis, broadcasting the
shared tensors against it without copying them, and the result is
[K, bs, F, 2]. The plan is chosen by bs·R·S as for one trial, never by K.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from avr_torch import geometry
from avr_torch.config import RenderConfig
from avr_torch.models import field as field_lib
from avr_torch.ops.signal_contract import signal_contract
from avr_torch.render.common import RenderConsts, compositing_weights
from avr_torch.utils import profiling


def _pick_chunk(n_samples: int, requested: int) -> int:
    c = max(1, min(requested, n_samples))
    while n_samples % c:
        c -= 1
    return c


def shell_chunks(x: torch.Tensor, C: int, dim: int):
    """x's shell chunks of C along ``dim``, as the views of one split.

    Autograd then concatenates the chunks' gradients once, in one
    SplitBackward0; a slice per chunk would fill a zero gradient of x's full
    size in each chunk's backward and add it to the other chunks'."""
    return torch.split(x, C, dim=dim)


def render_fused(
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
    compute_dtype=torch.bfloat16,
    shell_chunk: int = 1,
    remat: bool = True,
    point_budget: int = 4_000_000,
    ray_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render received IR spectra [bs, F, 2] (real, imag); [K, bs, F, 2]
    for params stacked over K trials.

    rays_o / position_tx / direction_tx: [bs, 3] world receiver position,
    transmitter position and transmitter view (complex variant); ch_idx
    [bs] integer microphone channels (standard variant) or None. ``dirs``
    [R, 3] overrides the ray directions (else drawn from ``generator``);
    ``ray_weights`` [R] scales each ray's contribution.
    """
    is_complex = fstatic.variant == "complex"
    if is_complex and direction_tx is None:
        raise ValueError("complex field variant requires direction_tx")
    device = rays_o.device
    xyz_min, xyz_max = consts.xyz_min, consts.xyz_max
    T = fstatic.signal_output_dim
    F = T // 2 + 1
    S = rc.n_samples
    C = _pick_chunk(S, shell_chunk)
    n_chunks = S // C

    if dirs is None:
        dirs = geometry.ray_directions(rc.n_azi, rc.n_ele, generator=generator, device=device)
    R = dirs.shape[0]
    bs = rays_o.shape[0]
    precompute = bs * R * S <= point_budget
    d_vals = consts.d_vals
    tx_n = geometry.normalize_points(position_tx, xyz_min, xyz_max)  # [bs, 3]
    tx_q = tx_n[:, None, None, :] if is_complex else None
    ch_b = ch_idx[:, None, None] if ch_idx is not None else None  # [bs, 1, 1]
    use_remat = remat and torch.is_grad_enabled()

    def run(fn, *args):
        # the chunks draw no random numbers; stashing the RNG state would not survive a graph capture
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False) if use_remat else fn(*args)

    def chunks():
        return (slice(i * C, (i + 1) * C) for i in range(n_chunks))

    def normalized_points(d_c):
        """World-space sample points of shells d_c and their box coordinates."""
        pts = geometry.ray_points(rays_o, dirs, d_c)  # [bs, R, C, 3]
        return pts, geometry.normalize_points(pts, xyz_min, xyz_max)

    # per-ray / per-batch signal context
    with profiling.span("render.context"):
        # h_ray [(K,) R, W], h_batch [(K,) bs, W]: added in the signal network's first layer
        context = field_lib.signal_context(
            params, fstatic, dirs, tx_n, tx_view=direction_tx, ch_idx=ch_idx,
            compute_dtype=compute_dtype,
        )

    # pass 1: attenuation (and, precomputed, every per-point feature)
    with profiling.span("render.attenuation"):
        if precompute:
            pts_all, pts_n_all = normalized_points(d_vals)  # [bs, R, S, 3]
            sigma_feat, attn, psig = field_lib.point_features(
                params, fstatic, pts_n_all, tx=tx_q, ch_idx=ch_b, compute_dtype=compute_dtype
            )
            attn = attn[..., 0]  # [(K,) bs, R, S]
            dist_all = torch.linalg.norm(position_tx[:, None, None, :] - pts_all, dim=-1)  # [bs, R, S]
        else:
            def attn_chunk(d_c):
                _, a = field_lib.sigma_query(
                    params, fstatic, normalized_points(d_c)[1], tx=tx_q, ch_idx=ch_b,
                    compute_dtype=compute_dtype,
                )
                return a[..., 0]  # [(K,) bs, R, C]

            attn = torch.cat([run(attn_chunk, d_vals[s]) for s in chunks()], dim=-1)
        lead = attn.shape[:-2]  # (bs,), or (K, bs) for K trials
        w = compositing_weights(attn.reshape(-1, R, S), d_vals)  # [(K·)bs, R, S]
        if ray_weights is not None:
            w = w * ray_weights.to(w.dtype)[None, :, None]

    # pass 2: signal tail + ray contraction + spectrum, chunk by chunk
    def spectrum(signal, dist_c, w_c, tail_c, pl_c, ph_re, ph_im):
        # signal: the last layer's (pre-bias output [(K,) bs, R, C, T], bias or None)
        y = signal_contract(*signal, w_c, dist_c, tail_c, rc.fs, rc.speed)  # [(K·)bs, C, T] fp32
        spec = torch.fft.rfft(y * pl_c[None, :, :], dim=-1)  # [(K·)bs, C, F]
        re = spec.real * ph_re - spec.imag * ph_im
        im = spec.real * ph_im + spec.imag * ph_re
        return re.sum(dim=1), im.sum(dim=1)

    def precomputed_chunk(feat_c, psig_c, dist_c, *rest):
        profiling.count("render.chunk_calls")
        with profiling.span("render.chunk"):
            signal = field_lib.signal_tail_from_features(
                params, fstatic, feat_c, psig_c, context, ch_idx=ch_b, compute_dtype=compute_dtype
            )
            return spectrum(signal, dist_c, *rest)

    def streaming_chunk(d_c, *rest):
        profiling.count("render.chunk_calls")
        with profiling.span("render.chunk"):
            pts, pts_n = normalized_points(d_c)
            feat_c, _ = field_lib.sigma_query(
                params, fstatic, pts_n, tx=tx_q, ch_idx=ch_b, compute_dtype=compute_dtype
            )
            signal = field_lib.signal_from_parts(
                params, fstatic, feat_c, pts_n, context, ch_idx=ch_b, compute_dtype=compute_dtype
            )
            dist_c = torch.linalg.norm(position_tx[:, None, None, :] - pts, dim=-1)
            return spectrum(signal, dist_c, *rest)

    with profiling.span("render.signal"):
        acc_re = torch.zeros((w.shape[0], F), dtype=torch.float32, device=device)
        acc_im = torch.zeros((w.shape[0], F), dtype=torch.float32, device=device)
        if precompute:
            feat_cs = shell_chunks(sigma_feat, C, -2)
            psig_cs = (None,) * n_chunks if psig is None else shell_chunks(psig, C, -2)
            dist_cs = shell_chunks(dist_all, C, -1)
            w_cs = shell_chunks(w, C, -1)
            if n_chunks > 1:
                profiling.count("render.feature_splits")
        for i, s in enumerate(chunks()):
            rest = (consts.tail_mask[s], consts.pathloss[s], consts.phase_re[s], consts.phase_im[s])
            if precompute:
                re, im = run(precomputed_chunk, feat_cs[i], psig_cs[i], dist_cs[i], w_cs[i], *rest)
            else:
                re, im = run(streaming_chunk, d_vals[s], w[:, :, s], *rest)
            acc_re = acc_re + re
            acc_im = acc_im + im
        return torch.stack([acc_re, acc_im], dim=-1).reshape(*lead, F, 2)
