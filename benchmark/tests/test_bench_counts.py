"""The FLOP and byte counters against hand counts."""

from __future__ import annotations

import torch

from benchmark import counts
from benchmark.reference import hashgrid
from benchmark.reference.field import Field


def test_mlp_macs_by_hand():
    from benchmark import harness

    flagship = Field(harness.cell("flagship_train")["config_file"]["config"])
    # sigma encoder 80→128→128→128→256, decoder 256→128→1, signal 416→512×4→1600
    by_hand = (80 * 128 + 2 * 128 * 128 + 128 * 256) + (256 * 128 + 128) + \
        (416 * 512 + 3 * 512 * 512 + 512 * 1600)
    assert flagship.mlp_macs_per_point() == by_hand == 1_927_296
    array = Field(harness.cell("array_train")["config_file"]["config"])
    # sigma encoder 40→128×3→128, decoder 128→128×3→1, signal 208→512×3→1600
    by_hand = (40 * 128 + 3 * 128 * 128) + (3 * 128 * 128 + 128) + (208 * 512 + 2 * 512 * 512 + 512 * 1600)
    assert array.mlp_macs_per_point() == by_hand == 1_553_536
    assert counts.model_flops(array, 10, 4, backward=True) == 2 * by_hand * 10 * 4 * 3
    assert counts.model_flops(array, 10, 0, backward=False) == 2 * by_hand * 10


class _OneGrid:
    """A field stand-in with one dense encoding of the point stream."""

    def __init__(self, g):
        self.grids = {"pos": g}


def test_encode_bytes_by_hand():
    # one dense level of resolution 1: 8 rows; a point inside the cell
    # touches all 8 corners, two points in the cell still touch 8 rows
    g = hashgrid.grid({"n_levels": 1, "n_features_per_level": 2, "log2_hashmap_size": 9,
                       "base_resolution": 1, "per_level_scale": 2.0})
    assert g.used_rows == 8
    x = torch.tensor([[0.5, 0.5, 0.5], [0.25, 0.75, 0.5]])
    w = counts.encode_work(_OneGrid(g), {"points": x}, trials=0)
    # points 2·3·4; features out and gradient in 2·1·2·4 each; rows read and written 8·2·4 each
    assert w["bytes"] == 2 * 3 * 4 + 2 * (2 * 1 * 2 * 4) + 2 * (8 * 2 * 4)
    assert w["ops"] == 2 * 8 * 2 * 2 * 2
    w4 = counts.encode_work(_OneGrid(g), {"points": x}, trials=4)
    assert w4["bytes"] == 2 * 3 * 4 + 4 * (2 * (2 * 1 * 2 * 4) + 2 * (8 * 2 * 4))
    assert counts.least_seconds(w) == w["bytes"] / counts.HBM_BYTES
