"""Multiresolution hash-grid encoding (port of ``avr_tpu/models/hashgrid.py``).

Every level of an encode — dense or hashed, trilinear or Kuhn simplex —
runs in one forward launch (``ops/hashgrid_encode.encode_rows``), and its
backward is one launch of the table-gradient kernel
(``encode_backward``). The two sit in one ``autograd.Function`` per encode
call. The forward saves only the points: the backward recomputes each
corner's row and weight from them and adds w·grad into the table gradient,
so neither the gathered [L, K, N, F] rows nor the corner streams are ever
stored.

A table with a leading trial axis [K, rows, F] (population training)
encodes the shared points through all K tables in one launch each way
(``_HashEncodePop``) and returns features with a leading K.

Inputs are points in the unit cube [0,1]³; out-of-range inputs are clamped.
The TPU level-group splitting, one-hot levels and encode layouts change no
numbers and are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from avr_torch.config import EncodingConfig
from avr_torch.device import resolve_device
from avr_torch.ops.hashgrid_encode import (
    LevelSpec, encode_backward, encode_backward_pop, encode_rows, encode_rows_pop,
)


@dataclass(frozen=True)
class HashGridStatic:
    """Static level geometry for one encoding."""

    n_levels: int
    n_features: int  # features per level
    resolutions: Tuple[int, ...]
    offsets: Tuple[int, ...]  # flat-table offset per level
    sizes: Tuple[int, ...]  # table entries per level
    hashed: Tuple[bool, ...]  # True → spatial hash, False → dense index
    total_entries: int
    # Tables are allocated with total_entries rounded up to 4096 rows, so
    # tables of the JAX package load with the same shape. Rows past
    # total_entries are never indexed and get zero gradient.
    padded_entries: int
    # "trilinear" | "simplex" | "levels:<s|t per level, coarsest first>"
    interp: str = "trilinear"

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features

    @property
    def level_modes(self) -> str:
        """One char per level: "t" trilinear, "s" simplex."""
        if self.interp.startswith("levels:"):
            return self.interp.split(":", 1)[1]
        return ("s" if self.interp == "simplex" else "t") * self.n_levels

    @property
    def levels(self) -> Tuple[LevelSpec, ...]:
        return tuple(
            LevelSpec(r, s, o, bool(h), 4 if m == "s" else 8)
            for r, s, o, h, m in zip(
                self.resolutions, self.sizes, self.offsets, self.hashed, self.level_modes
            )
        )


def _parse_interp(spec, n_levels: int) -> str:
    """Canonicalize an EncodingConfig.interpolation spec.

    "trilinear" (default), "simplex", "hybridc[:N]" (trilinear on the N
    coarsest levels, simplex above), "hybrid[:N]" (trilinear on the N
    finest), "levels:<s|t ×L>". N defaults to half the levels rounded up.
    Degenerate mixes collapse to the pure mode; unrecognized values fall
    back to trilinear.
    """
    s = str(spec or "").lower()
    if s == "simplex":
        return "simplex"
    if s.startswith("hybridc") or s.startswith("hybrid"):
        coarse_first = s.startswith("hybridc")
        n_tri = int(s.split(":")[1]) if ":" in s else (n_levels + 1) // 2
        n_tri = max(0, min(n_levels, n_tri))
        if n_tri == 0:
            return "simplex"
        if n_tri == n_levels:
            return "trilinear"
        if coarse_first:
            return "levels:" + "t" * n_tri + "s" * (n_levels - n_tri)
        return "levels:" + "s" * (n_levels - n_tri) + "t" * n_tri
    if s.startswith("levels:"):
        modes = s.split(":", 1)[1]
        if len(modes) != n_levels or not set(modes) <= {"s", "t"}:
            raise ValueError(f"levels: spec must be {n_levels} chars of s/t, got {modes!r}")
        if "s" not in modes:
            return "trilinear"
        if "t" not in modes:
            return "simplex"
        return "levels:" + modes
    return "trilinear"


def build_static(cfg: EncodingConfig) -> HashGridStatic:
    """Per-level resolutions/offsets from an EncodingConfig."""
    max_entries = 1 << cfg.log2_hashmap_size
    resolutions, offsets, sizes, hashed = [], [], [], []
    offset = 0
    for level in range(cfg.n_levels):
        res = int(np.floor(cfg.base_resolution * cfg.per_level_scale**level))
        dense = (res + 1) ** 3
        use_hash = dense > max_entries
        size = max_entries if use_hash else dense
        resolutions.append(res)
        offsets.append(offset)
        sizes.append(size)
        hashed.append(use_hash)
        offset += size
    return HashGridStatic(
        n_levels=cfg.n_levels,
        n_features=cfg.n_features_per_level,
        resolutions=tuple(resolutions),
        offsets=tuple(offsets),
        sizes=tuple(sizes),
        hashed=tuple(hashed),
        total_entries=offset,
        padded_entries=-(-offset // 4096) * 4096,
        interp=_parse_interp(getattr(cfg, "interpolation", ""), cfg.n_levels),
    )


def init(
    generator: Optional[torch.Generator], static: HashGridStatic, device="cuda",
    width: Optional[int] = None,
) -> torch.Tensor:
    """Feature table U(−1e−4, 1e−4) (instant-ngp init), ``padded_entries`` rows."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else device
    t = torch.rand(
        (static.padded_entries, width or static.n_features), generator=generator, device=gdev
    )
    return (t * 2e-4 - 1e-4).to(device)


class _HashEncode(torch.autograd.Function):
    """table [rows, F] × points [N, 3] → features [N, L, F].

    Forward: ``encode_rows``, saving x alone. Backward: ``encode_backward``,
    which recomputes the corners from x. Both take the bf16 rule when
    ``round_bf16`` is set. Points get no gradient (no caller differentiates
    through positions).
    """

    @staticmethod
    def forward(ctx, table, x, levels, round_bf16):
        ctx.save_for_backward(x)
        ctx.levels, ctx.round_bf16, ctx.n_rows = levels, round_bf16, table.shape[0]
        return encode_rows(table, levels, x, round_bf16=round_bf16)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        d_table = encode_backward(g, ctx.levels, x, ctx.n_rows, round_bf16=ctx.round_bf16)
        return d_table, None, None, None


class _HashEncodePop(torch.autograd.Function):
    """K tables [K, rows, F] × shared points [N, 3] → features [K, N, L, F]:
    ``_HashEncode`` with a trial axis (``encode_rows_pop`` /
    ``encode_backward_pop``, one launch each for all K), saving x alone."""

    @staticmethod
    def forward(ctx, tables, x, levels, round_bf16):
        ctx.save_for_backward(x)
        ctx.levels, ctx.round_bf16, ctx.n_rows = levels, round_bf16, tables.shape[1]
        return encode_rows_pop(tables, levels, x, round_bf16=round_bf16)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        d_tables = encode_backward_pop(g, ctx.levels, x, ctx.n_rows, round_bf16=ctx.round_bf16)
        return d_tables, None, None, None


def _encode_lnf(table, static: HashGridStatic, x, compute_dtype) -> torch.Tensor:
    """Shared core: x [..., 3] → [N, L, F_table] fp32, or [K, N, L, F_table]
    for a table [K, rows, F_table] of K trials."""
    xf = x.reshape(-1, 3).to(torch.float32).contiguous()
    round_bf16 = compute_dtype == torch.bfloat16 and table.dtype == torch.float32
    fn = _HashEncodePop if table.dim() == 3 else _HashEncode
    return fn.apply(table, xf, static.levels, round_bf16)


def encode(table: torch.Tensor, static: HashGridStatic, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Encode points x ∈ [0,1]³, shape [..., 3] → [..., L·F] (→ [K, ..., L·F]
    for a table [K, rows, F] of K trials).

    With a bf16 ``compute_dtype`` on an fp32 table the encode follows the
    JAX package's bf16 arithmetic (rows, weights and each product rounded
    to bf16, summed in fp32, the sum rounded to bf16: bit-equal to
    ``avr_tpu``'s encode); the output stays fp32, holding those bf16 values,
    and every consumer casts it to the compute dtype exactly.
    """
    out = _encode_lnf(table, static, x, compute_dtype)
    return out.reshape(*table.shape[:-2], *x.shape[:-1], static.n_levels * static.n_features)


def encode_pair_fused(
    fused: torch.Tensor, static: HashGridStatic, x: torch.Tensor, compute_dtype=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two same-geometry tables stored as one [rows, 2F] parameter: one
    gather forward, one scatter backward. Returns (enc_a, enc_b), each [..., L·F]
    (with a leading K for a fused table [K, rows, 2F] of K trials)."""
    Fh = static.n_features
    lead = (*fused.shape[:-2], *x.shape[:-1])
    out = _encode_lnf(fused, static, x, compute_dtype)  # [(K,) N, L, 2F]
    L = static.n_levels
    return (
        out[..., :Fh].reshape(*lead, L * Fh),
        out[..., Fh:].reshape(*lead, L * Fh),
    )


def frequency_encode(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """sin/cos positional encoding: [..., 3] → [..., 3·2·n_frequencies]."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=x.dtype, device=x.device) * math.pi
    ang = x[..., :, None] * freqs
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(*x.shape[:-1], 3 * 2 * n_frequencies)
