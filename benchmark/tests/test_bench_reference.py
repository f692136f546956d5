"""The plain reference against avr_torch on the CPU, at small sizes, with
the program computing in float32: the same weights, batches and
directions must give the same spectra, losses, gradients and update."""

from __future__ import annotations

import pytest
import torch

from benchmark import inputs, weights
from benchmark.reference import Reference, hashgrid, hparams, losses
from benchmark.reference.field import Field
from benchmark.tests.conftest import small_config

CELLS = ("flagship_train", "array_train")


def program(cfg: dict, tc_over=None):
    from avr_torch.config import AVRConfig
    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.train import state as st

    c = AVRConfig.from_dict(cfg)
    fst = field.build_field(c.model, c.path.dataset_type)
    consts = make_consts(c.render, c.model.signal_output_dim, device="cpu")
    return st.make_train_step(fst, consts, c.render, c.train, CriterionConfig.from_configs(c.train, c.render)), c, st


def draw(cfg, seed):
    fld = Field(cfg)
    return fld, weights.draw(fld, inputs.torch_generator(seed, 0, "cpu"), "cpu")


def first_batch(cfg, traffic, seed):
    b = inputs.Batches(cfg, traffic["batches"], seed, "cpu")
    d = inputs.ray_directions(cfg["render"]["n_azi"], cfg["render"]["n_ele"], inputs.torch_generator(seed, 5, "cpu"), "cpu")
    return b.get(b.index()), d


@pytest.mark.parametrize("cell", CELLS)
def test_render_matches_program(cell):
    from benchmark import harness

    cfg = small_config(cell)
    fld, w = draw(cfg, 3)
    (step, render), _, _ = program(cfg)
    batch, d = first_batch(cfg, harness.cell(cell)["traffic_file"], 3)
    batch = {**batch, **({"ch_idx": batch["ch_idx"].long()} if "ch_idx" in batch else {})}
    got = render(weights.program_tree(w, fld), batch, d)
    want = Reference(cfg, "cpu", ray_block=5).render(w, batch, d)
    assert torch.linalg.vector_norm(got - want) <= 1e-5 * torch.linalg.vector_norm(want)


@pytest.mark.parametrize("cell", CELLS)
def test_train_step_matches_program(cell):
    from benchmark import harness

    cfg = small_config(cell)
    fld, w = draw(cfg, 4)
    (step, _), c, st = program(cfg)
    batch, d = first_batch(cfg, harness.cell(cell)["traffic_file"], 4)
    state = st.init_state(None, None, c.train, device="cpu", params=weights.program_tree(w, fld))
    new, bundle = step(state, batch, d)
    ref = Reference(cfg, "cpu", ray_block=7).train(dict(w), [batch], [d], hparams(cfg))
    assert abs(float(bundle.total) - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    got_p = dict(st.named_leaves(new.params))
    got_mu = dict(st.named_leaves(new.opt_state.mu))
    want_u = weights.program_leaves(ref["first_update"], fld)
    want_p = weights.program_leaves(ref["params"], fld)
    for n, u in want_u.items():
        assert torch.allclose(got_mu[n] / 0.1, u, rtol=1e-3, atol=1e-4 * float(u.abs().max()) + 1e-12), n
        # Adam moves an entry by about lr·u/(|u| + 1e-8): where u is within
        # round-off of 0 the two sides may move it differently
        off = (got_p[n] - want_p[n]).abs() > 1e-6
        assert float(off.float().mean()) <= 1e-2 and bool((want_u[n][off].abs() < 1e-6).all()), n


@pytest.mark.parametrize("interp", ["trilinear", "simplex", "hybridc:2"])
def test_encode_matches_program(interp):
    from avr_torch.config import EncodingConfig
    from avr_torch.models import hashgrid as prog

    spec = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=9, base_resolution=3,
                per_level_scale=1.7, interpolation=interp)
    g = hashgrid.grid(spec)
    st = prog.build_static(EncodingConfig(**spec))
    assert (g.rows, g.used_rows) == (st.padded_entries, st.total_entries)
    table = torch.rand((g.rows, 2), generator=torch.Generator().manual_seed(0)) - 0.5
    x = torch.rand((300, 3), generator=torch.Generator().manual_seed(1))
    want = prog.encode(table, st, x)
    got = hashgrid.encode(table, g, x, "fp32")
    assert torch.allclose(got, want, atol=1e-6)


def test_criterion_matches_program():
    from avr_torch.losses import CriterionConfig, criterion

    g = torch.Generator().manual_seed(5)
    pred, wave = torch.randn((16, 129, 2), generator=g) * 1e-2, torch.randn((16, 129, 2), generator=g) * 1e-2
    cc = CriterionConfig(das_reg_loss_weight=10.0, das_ce_loss_weight=2.0, fs=16000, speed=343.8)
    want = criterion(pred, wave, cc)[0]
    got = losses.criterion(pred, wave, {k: getattr(cc, k) for k in losses.WEIGHTS},
                           {"reg": True, "ce": True, "fs": 16000.0, "speed": 343.8, "beta": 100.0})
    for name, v in zip(want._fields, want):
        assert abs(float(got.values[name]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, name
