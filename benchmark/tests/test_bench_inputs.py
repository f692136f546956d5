"""The input generators: seeded, repeatable, and whole 8-mic groups."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, inputs


def _cfg(cell):
    return harness.cell(cell)["config_file"]["config"]


def _traffic(cell):
    return harness.cell(cell)["traffic_file"]


@pytest.mark.parametrize("cell", ["flagship_train", "array_train"])
def test_batches_repeat_by_seed(cell):
    a = inputs.Batches(_cfg(cell), _traffic(cell)["batches"], 2 ** 31 + 11, "cpu")
    b = inputs.Batches(_cfg(cell), _traffic(cell)["batches"], 2 ** 31 + 11, "cpu")
    c = inputs.Batches(_cfg(cell), _traffic(cell)["batches"], 2 ** 31 + 12, "cpu")
    for k in a.pool:
        assert torch.equal(a.pool[k], b.pool[k])
    assert not torch.equal(a.pool["pos_rx"], c.pool["pos_rx"])
    order = [a.index() for _ in range(a.n)]
    assert sorted(order) == list(range(a.n))
    assert order == [b.index() for _ in range(b.n)]


def test_array_batches_are_whole_groups():
    cfg = _cfg("array_train")
    b = inputs.Batches(cfg, _traffic("array_train")["batches"], 7, "cpu")
    room = _traffic("array_train")["batches"]["room"]
    assert b.n == 16 and b.pool["wave"].shape == (16, 8, 801, 2)
    for i in range(b.n):
        batch = b.get(i)
        assert torch.equal(batch["ch_idx"], torch.arange(8, dtype=torch.int32))
        rx = batch["pos_rx"].double()
        center = rx.mean(dim=0)
        assert torch.allclose((rx - center).norm(dim=-1), torch.full((8,), room["array_radius"], dtype=torch.float64),
                              atol=1e-6)
        assert torch.equal(batch["pos_tx"], batch["pos_tx"][:1].expand(8, 3))


def test_image_source_matches_the_port():
    from avr_torch.data.synthetic import RoomSpec, simulate_ir

    room = _traffic("array_train")["batches"]["room"]
    r = np.random.default_rng(0)
    rx = r.uniform(0.5, 2.5, size=(5, 3))
    tx = np.array([3.0, 2.0, 1.5])
    got = inputs.impulse_responses(room, rx, tx, 1600, 16000.0, 343.8)
    spec = RoomSpec(size=tuple(room["size"]), absorption=room["absorption"], max_order=room["max_order"],
                    speed=343.8, fs=16000, seq_len=1600)
    want = np.stack([simulate_ir(spec, p, tx) for p in rx])
    assert np.allclose(got, want, atol=1e-6)


def test_render_poses_and_trials():
    cfg = _cfg("array_render")
    p = inputs.render_poses(cfg, _traffic("array_render")["requests"], 5, "cpu")
    q = inputs.render_poses(cfg, _traffic("array_render")["requests"], 5, "cpu")
    assert p["pos_rx"].shape == (512, 8, 3) and torch.equal(p["pos_rx"], q["pos_rx"])
    spec = {**_traffic("array_pop4")["trials"], "count": 4}
    t = inputs.population_trials(spec, 9)
    assert t == inputs.population_trials(spec, 9)
    assert t[0]["lr"] == 1e-3 and abs(t[0]["eta_min"] - 1e-4) < 1e-12
    for trial in t[1:]:
        assert 1e-6 <= trial["lr"] <= 2e-3 and 1e-2 * trial["lr"] <= trial["eta_min"] <= 0.5 * trial["lr"]
        assert 1.0 <= trial["das_reg_loss_weight"] <= 100.0


def test_ray_directions_match_the_port():
    from avr_torch import geometry

    want = geometry.ray_directions(64, 32, generator=torch.Generator().manual_seed(3), device="cpu")
    got = inputs.ray_directions(64, 32, torch.Generator().manual_seed(3), "cpu")
    assert torch.allclose(got, want, atol=1e-5)
