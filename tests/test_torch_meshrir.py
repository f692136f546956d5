"""The AVR paper's MeshRIR recipe (``configs/avr_meshrir.yml``, the
benchmark's ``meshrir`` configuration) in avr_torch against the
benchmark's plain float32 reference (``benchmark/reference``), on the CPU.

The structure is the recipe's: the standard field with no channel
embedding, three trilinear hash grids, T = 2,400 samples at fs = 24 kHz
(F = 1,201 bins, the 24 kHz delay masks and phase table, the 2,400-sample
multi-resolution STFT). Only rays, shells, levels and widths are cut. The
program computes in float32 here, so the two sides differ by summation
order alone; the same seeded weights, batch and ray directions go to both.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from avr_torch.config import AVRConfig
from avr_torch.utils import profiling
from benchmark import harness, inputs, weights
from benchmark.reference import Reference, hparams
from benchmark.tests import test_bench_meshrir
from benchmark.tests.test_bench_reference import draw, first_batch, program

ROOT = Path(__file__).resolve().parents[1]
CELL = test_bench_meshrir.CELL
# the precomputed plan (the recipe's) and the streaming one (point_budget 0)
PLANS = {"precomputed": 4_000_000, "streaming": 0}


def small(plan: str = "precomputed") -> dict:
    cfg = test_bench_meshrir.small()
    cfg["train"]["point_budget"] = PLANS[plan]
    return cfg


def batch_and_dirs(cfg: dict, seed: int):
    return first_batch(cfg, harness.cell(CELL)["traffic_file"], seed)


def test_recipe_yaml_is_the_benchmark_configuration():
    with open(ROOT / "benchmark" / "configs" / "meshrir.json") as f:
        bench = json.load(f)
    got = AVRConfig.from_yaml(str(ROOT / "configs" / "avr_meshrir.yml"))
    assert got == AVRConfig.from_dict(bench["config"])
    assert bench["reduced"] == [] and bench["source"] and bench["assumed"]
    r, m = got.render, got.model
    assert (r.n_rays, r.n_samples, r.fs, m.signal_output_dim, got.train.batch_size) == (3202, 64, 24000, 2400, 4)
    assert got.path.dataset_type == "MeshRIR" and not m.channel_embed.is_embed
    encs = (m.pos_encoding_sigma, m.dir_encoding_sig, m.tx_encoding_sig)
    assert {e.interpolation for e in encs} == {"trilinear"} and m.dir_encoding_sig.log2_hashmap_size == 20


def test_small_configuration_keeps_the_structure():
    cfg, full = small(), harness.cell(CELL)["config_file"]["config"]
    for section, key in (("render", "fs"), ("render", "speed"), ("render", "far"), ("model", "signal_output_dim"),
                         ("train", "batch_size"), ("train", "shell_chunk"), ("path", "dataset_type")):
        assert cfg[section][key] == full[section][key], key
    assert cfg["model"]["channel_embed"] == full["model"]["channel_embed"]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_spectra_match_reference(plan):
    """The rendered spectra [4, 1201, 2]: within 1e-5 of the reference's
    norm, float32 round-off over the rays' and shells' sums, which both
    sides take in different orders (the reference sums the rays before
    the rFFT, the port after its contraction per shell chunk)."""
    cfg = small(plan)
    fld, w = draw(cfg, 31)
    (_, render), _, _ = program(cfg)
    batch, d = batch_and_dirs(cfg, 31)
    got = render(weights.program_tree(w, fld), batch, d)
    want = Reference(cfg, "cpu", ray_block=5).render(w, batch, d)
    assert got.shape == (4, 1201, 2)
    assert torch.linalg.vector_norm(got - want) <= 1e-5 * torch.linalg.vector_norm(want)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_train_step_matches_reference(plan):
    """One step from the same weights, batch and directions: the loss and
    each of its terms, the clipped gradient as Adam receives it, and the
    parameters after Adam's update."""
    cfg = small(plan)
    fld, w = draw(cfg, 32)
    (step, _), c, st = program(cfg)
    batch, d = batch_and_dirs(cfg, 32)
    state = st.init_state(None, None, c.train, device="cpu", params=weights.program_tree(w, fld))
    new, bundle = step(state, batch, d)
    ref = Reference(cfg, "cpu", ray_block=7).train(dict(w), [batch], [d], hparams(cfg))
    # the total: float32 round-off of the spectra carried through the criterion
    assert abs(float(bundle.total) - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    # each term: as the criterion's own parity test holds them (1e-4 of the
    # term, 1e-7 absolute for the terms near zero)
    for name, v in ref["terms"][0].items():
        assert abs(float(bundle.as_dict()[name]) - v) <= 1e-4 * abs(v) + 1e-7, name
    got_mu = dict(st.named_leaves(new.opt_state.mu))
    got_p = dict(st.named_leaves(new.params))
    want_u = weights.program_leaves(ref["first_update"], fld)
    want_p = weights.program_leaves(ref["params"], fld)
    for n, u in want_u.items():
        # the clipped gradient, read from the first moment m = 0.1·u: the
        # backward sums over the rays' and shells' points in other orders,
        # so 1e-3 relative, and 1e-4 of the leaf's largest entry for the
        # entries near zero
        assert torch.allclose(got_mu[n] / 0.1, u, rtol=1e-3, atol=1e-4 * float(u.abs().max()) + 1e-12), n
        # Adam moves an entry by about lr·u/(|u| + 1e-8): where u is within
        # round-off of 0 the two sides may move it differently
        off = (got_p[n] - want_p[n]).abs() > 1e-6
        assert float(off.float().mean()) <= 1e-2 and bool((want_u[n][off].abs() < 1e-6).all()), n


def test_counters_per_step():
    """The renderer's counters on this shape, per step of the precomputed
    plan: each of the S shell chunks run and recomputed once, and one split
    of the per-point features."""
    cfg = small()
    fld, w = draw(cfg, 33)
    (step, _), c, st = program(cfg)
    state = st.init_state(None, None, c.train, device="cpu", params=weights.program_tree(w, fld))
    b = inputs.Batches(cfg, harness.cell(CELL)["traffic_file"]["batches"], 33, "cpu")
    gen = inputs.torch_generator(33, 5, "cpu")
    for _ in range(2):
        d = inputs.ray_directions(cfg["render"]["n_azi"], cfg["render"]["n_ele"], gen, "cpu")
        before = profiling.counters()
        state, _ = step(state, b.get(b.index()), d)
        after = profiling.counters()
        moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        assert moved == {"render.chunk_calls": 2 * cfg["render"]["n_samples"], "render.feature_splits": 1}
