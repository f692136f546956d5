"""Fused hash-grid encode forward (kernel B) and its plain version.

Kernel B (``csrc/hashgrid_encode.cu``) takes the place of the XLA chain
``hashgrid._indices_weights_klm`` (:434) → ``hash_scatter.
gather_rows_lmajor`` (:1367) → ``hashgrid._interp_ksum`` (:726) of the JAX
package, for every level of an encode in one launch.

Levels are described by ``LevelSpec`` tuples (res, size, offset, hashed,
K). Saved corner streams are flat and level-major: level l holds a
[K_l, N] block starting at N·Σ_{l'<l} K_{l'} — the layout the backward
hands to kernel A.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from avr_torch.ops import _build

# instant-ngp hash primes (Müller et al. 2022, Eq. 4)
PRIMES = (1, 2654435761, 805459861)
_FEATURE_WIDTHS = (1, 2, 4)


class LevelSpec(NamedTuple):
    res: int  # grid resolution
    size: int  # table rows of the level
    offset: int  # first row of the level in the flat table
    hashed: bool  # spatial hash (True) or dense index
    K: int  # 8 = trilinear corners, 4 = Kuhn simplex vertices


def level_groups(levels: Sequence[LevelSpec]) -> Tuple[Tuple[int, int], ...]:
    """Contiguous [lo, hi) level ranges that share one K."""
    groups, lo = [], 0
    for i in range(1, len(levels) + 1):
        if i == len(levels) or levels[i].K != levels[lo].K:
            groups.append((lo, i))
            lo = i
    return tuple(groups)


# ----------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------
def indices_weights(levels: Sequence[LevelSpec], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner indices and weights for levels that share one K.

    x [N, 3] (clamped to [0,1]) → (idx int64 [L, K, N], w [L, K, N]),
    operation by operation as ``_indices_weights_klm``. The uint32 hash is
    computed in int64: the low 32 bits of each product are those of the
    uint32 product, and the power-of-two mask keeps only low bits.
    """
    K = levels[0].K
    assert all(lv.K == K for lv in levels)
    dev, dt = x.device, x.dtype
    x = torch.clamp(x, 0.0, 1.0)
    col = lambda vals, dtype: torch.tensor(vals, dtype=dtype, device=dev)[:, None]  # noqa: E731
    res_i = col([lv.res for lv in levels], torch.int64)
    res_f = col([lv.res for lv in levels], dt)
    sizes = col([lv.size for lv in levels], torch.int64)
    offs = col([lv.offset for lv in levels], torch.int64)
    use_hash = col([lv.hashed for lv in levels], torch.bool)
    stride = res_i + 1

    pos0, frac = [], []
    for a in range(3):  # one [L, N] plane per axis
        s = x[None, :, a] * res_f
        p = torch.minimum(torch.clamp(torch.floor(s).to(torch.int64), min=0), res_i - 1)
        pos0.append(p)
        frac.append(s - p.to(dt))
    px, py, pz = pos0
    fx, fy, fz = frac

    def flat(cx, cy, cz):
        cx, cy, cz = torch.minimum(cx, res_i), torch.minimum(cy, res_i), torch.minimum(cz, res_i)
        dense = cx + cy * stride + cz * stride * stride
        h = (cx * PRIMES[0]) ^ (cy * PRIMES[1]) ^ (cz * PRIMES[2])
        return torch.where(use_hash, h & (sizes - 1), dense) + offs

    if K == 4:
        # descending rank of each axis' frac, ties broken by axis index
        rx = (fy > fx).long() + (fz > fx).long()
        ry = (fx >= fy).long() + (fz > fy).long()
        rz = (fx >= fz).long() + (fy >= fz).long()
        idx = torch.stack(
            [flat(px + (rx < k), py + (ry < k), pz + (rz < k)) for k in range(4)], dim=1
        )
        s1 = torch.maximum(fx, torch.maximum(fy, fz))
        s3 = torch.minimum(fx, torch.minimum(fy, fz))
        s2 = fx + fy + fz - s1 - s3
        w = torch.stack([1.0 - s1, s1 - s2, s2 - s3, s3], dim=1)
    else:
        idx_c, w_c = [], []
        for c in range(8):  # corner bit d = (c >> d) & 1
            bx, by, bz = c & 1, (c >> 1) & 1, (c >> 2) & 1
            idx_c.append(flat(px + bx, py + by, pz + bz))
            w_c.append(
                (fx if bx else 1.0 - fx) * (fy if by else 1.0 - fy) * (fz if bz else 1.0 - fz)
            )
        idx = torch.stack(idx_c, dim=1)
        w = torch.stack(w_c, dim=1)
    return idx, w


def encode_rows_reference(
    table: torch.Tensor, levels: Sequence[LevelSpec], x: torch.Tensor, round_bf16: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel B: (out [N, L, F], idx int32 [M], w [M])."""
    outs, idxs, ws = [], [], []
    for lo, hi in level_groups(levels):
        idx, w = indices_weights(levels[lo:hi], x)  # [Lg, K, N]
        rows = table[idx]  # [Lg, K, N, F]
        if round_bf16:
            rows = rows.to(torch.bfloat16).to(torch.float32)
        outs.append((rows * w[..., None]).sum(dim=1))  # [Lg, N, F]
        idxs.append(idx.reshape(-1).to(torch.int32))
        ws.append(w.reshape(-1))
    out = torch.cat(outs, dim=0).permute(1, 0, 2).contiguous()
    return out, torch.cat(idxs), torch.cat(ws)


# ----------------------------------------------------------------------
# Kernel wrapper
# ----------------------------------------------------------------------
_META: Dict[Tuple, torch.Tensor] = {}


def _meta(levels: Sequence[LevelSpec], device: torch.device) -> torch.Tensor:
    key = (tuple(levels), str(device))
    m = _META.get(key)
    if m is None:
        rows, kbase = [], 0
        for lv in levels:
            rows.append([lv.res, lv.size, lv.offset, int(lv.hashed), lv.K, kbase])
            kbase += lv.K
        m = torch.tensor(rows, dtype=torch.int32, device=device)
        _META[key] = m
    return m


def _lib():
    fn = _build.load("hashgrid_encode").avr_hashgrid_encode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def encode_rows(
    table: torch.Tensor, levels: Sequence[LevelSpec], x: torch.Tensor, round_bf16: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode points x [N, 3] ∈ [0,1]³ through every level of ``table``.

    Returns (out fp32 [N, L, F], idx int32 [M], w fp32 [M]) with
    M = N·Σ K_l: the corner streams that the backward scatters through.
    ``round_bf16`` rounds the gathered rows to bfloat16 before the fp32 sum.
    A CPU table goes to the plain version; a CUDA table to kernel B.
    """
    if table.device.type == "cpu" and x.device.type == "cpu":
        return encode_rows_reference(table, levels, x, round_bf16)
    if table.device.type != "cuda" or x.device != table.device:
        raise ValueError(
            f"encode_rows: table on {table.device} and x on {x.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if table.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"encode_rows: need float32 table and x, got {table.dtype} / {x.dtype}")
    if table.dim() != 2 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(
            f"encode_rows: need table [rows, F] and x [N, 3], got {tuple(table.shape)} / {tuple(x.shape)}"
        )
    F = table.shape[1]
    if F not in _FEATURE_WIDTHS:
        raise ValueError(f"encode_rows: feature width {F} not in {_FEATURE_WIDTHS}")
    if not (table.is_contiguous() and x.is_contiguous()):
        raise ValueError("encode_rows: table and x must be contiguous")
    if table.data_ptr() % (4 * F):
        raise ValueError("encode_rows: table rows must be aligned to their width")
    if max(lv.offset + lv.size for lv in levels) > table.shape[0]:
        raise ValueError("encode_rows: levels reach past the table's rows")
    N, L = x.shape[0], len(levels)
    dev = table.device
    M = N * sum(lv.K for lv in levels)
    out = torch.empty((N, L, F), dtype=torch.float32, device=dev)
    idx = torch.empty((M,), dtype=torch.int32, device=dev)
    w = torch.empty((M,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(
        x.data_ptr(), table.data_ptr(), _meta(levels, dev).data_ptr(), out.data_ptr(),
        idx.data_ptr(), w.data_ptr(), N, L, F, int(round_bf16), stream,
    )
    if rc != 0:
        raise RuntimeError(f"encode_rows: kernel launch failed with CUDA error {rc}")
    encode_rows.launches += 1
    return out, idx, w


encode_rows.launches = 0
