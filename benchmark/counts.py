"""Operations and bytes of the work a step or a request asks for, and the
card's peaks they are held against.

Counted from the configuration's widths and the inputs, never from a
kernel: a later change that fuses or replaces kernels changes which
kernels the time is read from, not these counts.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from benchmark.reference import hashgrid
from benchmark.reference.field import Field

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, float32
# FLOP/s outside the tensor cores, HBM bytes/s (at the 700 W limit).
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

# the input each encoding reads: encodings of one stream share its points
STREAM = {"pos": "points", "pos_sig": "points", "dir": "view", "tx": "tx", "tx_pos": "tx",
          "tx_pos_sig": "tx", "tx_dir": "heading"}


def model_flops(fld: Field, points: int, trials: int, backward: bool) -> float:
    """MLP FLOPs at the configured widths for ``points`` query points per
    trial: 2 per multiply-add forward, three times that with the backward
    (the input and the weight gradient); recomputed work is not counted."""
    return 2.0 * fld.mlp_macs_per_point() * points * max(1, trials) * (3 if backward else 1)


def encode_inputs(geo_box, batch: Dict[str, torch.Tensor], dirs: torch.Tensor,
                  d_vals: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Points in [0, 1]^3 [N, 3] of each input stream of one batch."""
    rx, tx = batch["pos_rx"], batch["pos_tx"]
    pts = rx[:, None, None, :] + dirs[None, :, None, :] * d_vals[None, None, :, None]
    out = {
        "points": (geo_box(pts).reshape(-1, 3) + 1) / 2,
        "view": (-dirs + 1) / 2,
        "tx": (geo_box(tx) + 1) / 2,
    }
    if "rot_tx" in batch:
        out["heading"] = (batch["rot_tx"] + 1) / 2
    return out


def encode_work(fld: Field, inputs: Dict[str, torch.Tensor], trials: int, backward: bool = True) -> Dict[str, float]:
    """Bytes and operations of every hash encoding of one batch, forward
    and (``backward``) backward, for ``trials`` tables each: the points
    read once per stream, the features written, the upstream gradient
    read, and each distinct table row the points touch read once and (with
    the backward) its gradient written once. The dense zero fill of a
    table's gradient is not counted as work. Operations: per corner and
    feature a multiply and an add each way."""
    k = max(1, trials)
    n_bytes, ops = 0.0, 0.0
    for stream in sorted({STREAM[n] for n in fld.grids}):
        n_bytes += inputs[stream].shape[0] * 3 * 4
    for name, g in fld.grids.items():
        x = inputs[STREAM[name]]
        n, L, F = x.shape[0], len(g.levels), g.n_features
        corners = sum(4 if lv.simplex else 8 for lv in g.levels)
        rows = hashgrid.distinct_rows(g, x)
        passes = 2 if backward else 1
        n_bytes += k * (n * L * F * 4 * passes + rows * F * 4 * passes)
        ops += k * n * corners * F * 2 * passes
    return {"bytes": n_bytes, "ops": ops}


def least_seconds(work: Dict[str, float]) -> float:
    """The least time the card could take: bytes at the HBM rate or
    float32 operations at their peak, whichever is longer."""
    return max(work["bytes"] / HBM_BYTES, work["ops"] / FP32_FLOPS)


def sum_work(works: Iterable[Dict[str, float]]) -> Dict[str, float]:
    works: List[Dict[str, float]] = list(works)
    return {k: sum(w[k] for w in works) for k in ("bytes", "ops")}
