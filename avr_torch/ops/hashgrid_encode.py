"""Fused hash-grid encode, forward and backward, and their plain versions.

The forward (``csrc/hashgrid_encode.cu``) takes the place of the XLA chain
``hashgrid._indices_weights_klm`` (:434) → ``hash_scatter.
gather_rows_lmajor`` (:1367) → ``hashgrid._interp_ksum`` (:726) of the JAX
package, for every level of an encode in one launch, and stores nothing but
its output. The backward (``csrc/hashgrid_encode_bwd.cu``) recomputes the
corners from the points and adds w·g into the table gradient: what the
gather VJP and the Pallas ``_tile_kernel`` (hash_scatter.py:872) compute.
Both include ``csrc/hashgrid_index.cuh``, so their corners are the same.

Levels are described by ``LevelSpec`` tuples (res, size, offset, hashed,
K). Corner streams, where they are formed (the plain versions, and
:func:`corners` for checking the indices on the card), are flat and
level-major: level l holds a [K_l, N] block starting at N·Σ_{l'<l} K_{l'}.

bf16 compute (``round_bf16``) follows the JAX package on an fp32 table:
the forward is bf16(Σ_k bf16(bf16(row_k)·bf16(w_k))), k ascending, summed in
fp32, and is returned as fp32 holding bf16 values; the backward's corner
update is bf16(bf16(g)·bf16(w)), summed in fp32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from avr_torch.ops import _build
from avr_torch.ops.hash_scatter import scatter_add_rows_reference

# instant-ngp hash primes (Müller et al. 2022, Eq. 4)
PRIMES = (1, 2654435761, 805459861)
_FEATURE_WIDTHS = (1, 2, 4)
_MAX_LEVELS = 64  # kMaxLevels of hashgrid_index.cuh


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
# Plain versions
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


def corners_reference(levels: Sequence[LevelSpec], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`corners`: (idx int32 [M], w [M]), level-major."""
    idxs, ws = [], []
    for lo, hi in level_groups(levels):
        idx, w = indices_weights(levels[lo:hi], x)  # [Lg, K, N]
        idxs.append(idx.reshape(-1).to(torch.int32))
        ws.append(w.reshape(-1))
    return torch.cat(idxs), torch.cat(ws)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def encode_rows_reference(
    table: torch.Tensor, levels: Sequence[LevelSpec], x: torch.Tensor, round_bf16: bool = False
) -> torch.Tensor:
    """Plain version of :func:`encode_rows`: out [N, L, F], summed over k in
    ascending order as the kernel sums."""
    outs = []
    for lo, hi in level_groups(levels):
        idx, w = indices_weights(levels[lo:hi], x)  # [Lg, K, N]
        rows = table[idx].to(torch.float32)  # [Lg, K, N, F]
        if round_bf16:
            rows, w = _bf16(rows), _bf16(w)
        acc = torch.zeros_like(rows[:, 0])
        for k in range(rows.shape[1]):
            p = rows[:, k] * w[:, k, :, None]  # exact for bf16 operands
            acc = acc + (_bf16(p) if round_bf16 else p)
        outs.append(_bf16(acc) if round_bf16 else acc)
    return torch.cat(outs, dim=0).permute(1, 0, 2).contiguous()


def encode_backward_reference(
    g: torch.Tensor, levels: Sequence[LevelSpec], x: torch.Tensor, n_rows: int,
    round_bf16: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`encode_backward`: corner indices and weights,
    the update w·g of every corner (bf16 rule with ``round_bf16``), then
    ``scatter_add_rows_reference``."""
    F = g.shape[-1]
    g = g.to(torch.float32)
    if round_bf16:
        g = _bf16(g)
    idxs, upds = [], []
    for lo, hi in level_groups(levels):
        idx, w = indices_weights(levels[lo:hi], x)  # [Lg, K, N]
        if round_bf16:
            w = _bf16(w)
        upd = g[:, lo:hi].permute(1, 0, 2)[:, None] * w[..., None]  # [Lg, K, N, F]
        if round_bf16:
            upd = _bf16(upd)
        idxs.append(idx.reshape(-1))
        upds.append(upd.reshape(-1, F))
    return scatter_add_rows_reference(torch.cat(idxs), torch.cat(upds), n_rows)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------
_META: Dict[Tuple[LevelSpec, ...], ctypes.Array] = {}
_INT_P = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "avr_hashgrid_encode": [ctypes.c_void_p, ctypes.c_void_p, _INT_P, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p],
    "avr_hashgrid_corners": [ctypes.c_void_p, _INT_P, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "avr_hashgrid_encode_bwd": [ctypes.c_void_p, ctypes.c_void_p, _INT_P, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p],
}


def _meta(levels: Sequence[LevelSpec]) -> ctypes.Array:
    """Host int32 [L, 5] (res, size, offset, hashed, K): the kernels take the
    levels as a kernel parameter."""
    key = tuple(levels)
    m = _META.get(key)
    if m is None:
        flat = [v for lv in key for v in (lv.res, lv.size, lv.offset, int(lv.hashed), lv.K)]
        m = (ctypes.c_int * len(flat))(*flat)
        _META[key] = m
    return m


def _fn(source: str, name: str):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(what: str, levels, x: torch.Tensor, dev: torch.device, n_rows: int = None) -> None:
    """Raise unless x [N, 3] fp32 lies contiguous on ``dev`` (a CUDA device)
    and the levels fit the kernels (and a table of ``n_rows`` rows)."""
    if dev.type != "cuda" or x.device != dev:
        raise ValueError(
            f"{what}: tensors on {dev} and {x.device}; "
            "all must be on the same CUDA device (or all on the CPU)"
        )
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: need contiguous float32 x [N, 3], got {x.dtype} {tuple(x.shape)}")
    if not 0 < len(levels) <= _MAX_LEVELS or any(lv.K not in (4, 8) for lv in levels):
        raise ValueError(f"{what}: need 1..{_MAX_LEVELS} levels of K 4 or 8")
    if n_rows is not None and max(lv.offset + lv.size for lv in levels) > n_rows:
        raise ValueError(f"{what}: levels reach past the table's {n_rows} rows")


def _check_rows(what: str, t: torch.Tensor) -> int:
    """Raise unless t is a contiguous fp32 [..., F] with F ∈ {1, 2, 4}, rows aligned; returns F."""
    F = t.shape[-1]
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous float32, got {t.dtype}")
    if F not in _FEATURE_WIDTHS:
        raise ValueError(f"{what}: feature width {F} not in {_FEATURE_WIDTHS}")
    if t.data_ptr() % (4 * F):
        raise ValueError(f"{what}: rows must be aligned to their width")
    return F


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def encode_rows(
    table: torch.Tensor, levels: Sequence[LevelSpec], x: torch.Tensor, round_bf16: bool = False
) -> torch.Tensor:
    """Encode points x [N, 3] ∈ [0,1]³ through every level of ``table``
    [rows, F]: fp32 [N, L, F]. ``round_bf16`` applies the bf16 rule of the
    module docstring. A CPU table and x go to the plain version; CUDA ones
    to the forward kernel, or the call raises."""
    if table.device.type == "cpu" and x.device.type == "cpu":
        return encode_rows_reference(table, levels, x, round_bf16)
    _check("encode_rows", levels, x, table.device, table.shape[0])
    if table.dim() != 2:
        raise ValueError(f"encode_rows: need table [rows, F], got {tuple(table.shape)}")
    F = _check_rows("encode_rows table", table)
    N, L = x.shape[0], len(levels)
    out = torch.empty((N, L, F), dtype=torch.float32, device=table.device)
    rc = _fn("hashgrid_encode", "avr_hashgrid_encode")(
        x.data_ptr(), table.data_ptr(), _meta(levels), out.data_ptr(), N, L, F,
        int(round_bf16), _stream(table.device),
    )
    _raise_on(rc, "encode_rows")
    encode_rows.launches += 1
    return out


encode_rows.launches = 0


def encode_backward(
    g: torch.Tensor, levels: Sequence[LevelSpec], x: torch.Tensor, n_rows: int,
    round_bf16: bool = False,
) -> torch.Tensor:
    """Table gradient of :func:`encode_rows` for the cotangent g [N, L, F]:
    fp32 [n_rows, F], d[row_k] += w_k·g over every point, level and corner.
    CPU tensors go to the plain version; CUDA ones to the backward kernel,
    or the call raises. On the card the sum order changes from run to run
    (atomics)."""
    if g.device.type == "cpu" and x.device.type == "cpu":
        return encode_backward_reference(g, levels, x, n_rows, round_bf16)
    _check("encode_backward", levels, x, g.device, n_rows)
    N, L = x.shape[0], len(levels)
    if g.dim() != 3 or g.shape[:2] != (N, L):
        raise ValueError(f"encode_backward: need g [{N}, {L}, F], got {tuple(g.shape)}")
    F = _check_rows("encode_backward g", g)
    d_table = torch.zeros((n_rows, F), dtype=torch.float32, device=g.device)
    rc = _fn("hashgrid_encode_bwd", "avr_hashgrid_encode_bwd")(
        x.data_ptr(), g.data_ptr(), _meta(levels), d_table.data_ptr(), N, L, F,
        int(round_bf16), _stream(g.device),
    )
    _raise_on(rc, "encode_backward")
    encode_backward.launches += 1
    return d_table


encode_backward.launches = 0


def corners(levels: Sequence[LevelSpec], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner rows and weights of every level, level-major: (idx int32 [M],
    w fp32 [M]), M = N·Σ K_l, from the kernels' shared header. Off the
    training path: it lets the card's indices be held bit-equal to
    :func:`corners_reference`."""
    if x.device.type == "cpu":
        return corners_reference(levels, x)
    _check("corners", levels, x, x.device)
    N = x.shape[0]
    M = N * sum(lv.K for lv in levels)
    idx = torch.empty((M,), dtype=torch.int32, device=x.device)
    w = torch.empty((M,), dtype=torch.float32, device=x.device)
    rc = _fn("hashgrid_encode", "avr_hashgrid_corners")(
        x.data_ptr(), _meta(levels), idx.data_ptr(), w.data_ptr(), N, len(levels), _stream(x.device),
    )
    _raise_on(rc, "corners")
    corners.launches += 1
    return idx, w


corners.launches = 0
