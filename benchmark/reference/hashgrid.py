"""Multiresolution hash-grid encoding, written out plainly.

Level l has resolution floor(base·scale^l). A level whose (res+1)^3 grid
fits in 2^log2_hashmap_size rows is indexed densely, x + y·(res+1) +
z·(res+1)^2; a larger one by the instant-ngp spatial hash (x·1 XOR
y·2654435761 XOR z·805459861) mod 2^log2_hashmap_size. Levels are stored
one after the other in one table whose row count is rounded up to a
multiple of 4096.

A level interpolates trilinearly (8 corners) or over the Kuhn simplex
that holds the point (4 vertices: the cell corner, then one step along
each axis in descending order of the point's fraction on it, ties to the
lower axis). ``hybridc:N`` interpolates the N coarsest levels trilinearly
and the rest over simplices; ``hybrid:N`` the N finest trilinearly.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from benchmark.reference.precision import rounded

PRIMES = (1, 2654435761, 805459861)


class Level(NamedTuple):
    res: int
    size: int
    offset: int
    hashed: bool
    simplex: bool


class Grid(NamedTuple):
    levels: Tuple[Level, ...]
    n_features: int
    rows: int  # table rows, padded to a multiple of 4096
    used_rows: int  # rows that some level can index


def _modes(spec: str, n: int) -> str:
    """One of "t"/"s" per level, coarsest first."""
    s = (spec or "trilinear").lower()
    if s == "simplex":
        return "s" * n
    if s.startswith("hybrid"):
        n_tri = int(s.split(":")[1]) if ":" in s else (n + 1) // 2
        n_tri = max(0, min(n, n_tri))
        if s.startswith("hybridc"):
            return "t" * n_tri + "s" * (n - n_tri)
        return "s" * (n - n_tri) + "t" * n_tri
    if s.startswith("levels:"):
        return s.split(":", 1)[1]
    return "t" * n


def grid(enc: dict) -> Grid:
    """The level geometry of one encoding's configuration."""
    n = int(enc["n_levels"])
    cap = 1 << int(enc["log2_hashmap_size"])
    modes = _modes(enc.get("interpolation", "trilinear"), n)
    levels, offset = [], 0
    for lv in range(n):
        res = int(math.floor(enc["base_resolution"] * enc["per_level_scale"] ** lv))
        hashed = (res + 1) ** 3 > cap
        size = cap if hashed else (res + 1) ** 3
        levels.append(Level(res, size, offset, hashed, modes[lv] == "s"))
        offset += size
    return Grid(tuple(levels), int(enc["n_features_per_level"]), -(-offset // 4096) * 4096, offset)


def corners(level: Level, x01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows [N, K] (int64, within the level's block) and weights [N, K] of
    the corners that interpolate points x01 [N, 3] on one level."""
    x = torch.clamp(x01, 0.0, 1.0)
    res = level.res
    scaled = x * res
    cell = torch.clamp(torch.floor(scaled).long(), 0, res - 1)  # [N, 3]
    frac = scaled - cell.to(scaled.dtype)

    def row(c: torch.Tensor) -> torch.Tensor:  # c [..., 3] lattice coordinates
        c = torch.clamp(c, max=res)
        if level.hashed:
            h = (c[..., 0] * PRIMES[0]) ^ (c[..., 1] * PRIMES[1]) ^ (c[..., 2] * PRIMES[2])
            return (h & (level.size - 1)) + level.offset
        n = res + 1
        return c[..., 0] + c[..., 1] * n + c[..., 2] * n * n + level.offset

    if not level.simplex:
        bits = torch.tensor(
            [[(k >> d) & 1 for d in range(3)] for k in range(8)], device=x.device
        )  # [8, 3], corner k has offset bit d on axis d
        idx = row(cell[:, None, :] + bits[None])
        f = frac[:, None, :]
        w = torch.where(bits[None].bool(), f, 1.0 - f).prod(dim=-1)
        return idx, w
    # Kuhn simplex: visit the axes in descending order of frac
    order = torch.stack(
        [
            (frac[:, 1] > frac[:, 0]).long() + (frac[:, 2] > frac[:, 0]).long(),
            (frac[:, 0] >= frac[:, 1]).long() + (frac[:, 2] > frac[:, 1]).long(),
            (frac[:, 0] >= frac[:, 2]).long() + (frac[:, 1] >= frac[:, 2]).long(),
        ],
        dim=-1,
    )  # rank of each axis, 0 = largest fraction
    verts = torch.stack([cell + (order < k).long() for k in range(4)], dim=1)  # [N, 4, 3]
    hi, _ = frac.max(dim=-1)
    lo, _ = frac.min(dim=-1)
    mid = frac.sum(dim=-1) - hi - lo
    w = torch.stack([1.0 - hi, hi - mid, mid - lo, lo], dim=-1)
    return row(verts), w


def encode(table: torch.Tensor, g: Grid, x01: torch.Tensor, precision: str) -> torch.Tensor:
    """Features [N, L·F] of points x01 [N, 3] from ``table`` [rows, F]."""
    t = rounded(table, precision)
    out: List[torch.Tensor] = []
    for level in g.levels:
        idx, w = corners(level, x01)
        rows = t[idx]  # [N, K, F]
        out.append((rows * rounded(w, precision)[..., None]).sum(dim=1))
    return torch.cat(out, dim=-1)


def distinct_rows(g: Grid, x01: torch.Tensor, block: int = 1 << 20) -> int:
    """How many table rows the points x01 [N, 3] touch over all levels."""
    seen = torch.zeros(g.used_rows, dtype=torch.bool, device=x01.device)
    for start in range(0, x01.shape[0], block):
        xb = x01[start:start + block]
        for level in g.levels:
            seen[corners(level, xb)[0].reshape(-1)] = True
    return int(seen.sum())
