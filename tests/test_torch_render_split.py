"""The precomputed plan's hand-off of its per-point tensors to the shell
chunks (``render.fused.shell_chunks``): one split of each tensor, so that
autograd concatenates the chunks' gradients once.

Held on the CPU against the hand-off it replaced, a slice of each tensor per
chunk (kept here as ``sliced``): the render, the gradients of the sigma
features, of psig, of the compositing weights and of every parameter are
bit-equal, for one trial and for K = 4, shell chunks of 1, 2 and all S, both
field variants, fp32 and bf16 compute. A profiled backward holds that no
zero fill of the features' full shape runs and that no slice of them is in
the graph, and ``render.feature_splits`` counts one per precomputed call
and none per streaming call.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from avr_torch.config import AVRConfig
from avr_torch.flagship import flagship_config
from avr_torch.models import field
from avr_torch.render import fused
from avr_torch.render.common import make_consts
from avr_torch.train import state as st
from avr_torch.utils import profiling

torch.set_num_threads(2)

ARRAY_RECIPE = Path(__file__).resolve().parents[1] / "configs" / "avr_synthetic_array.yml"
BS = 4
FILLS = ("aten::fill_", "aten::zero_", "aten::zeros", "aten::new_zeros", "aten::zeros_like")


def sliced(x, C, dim):
    """The earlier hand-off: a slice of x per chunk."""
    return tuple(x.narrow(dim, i, C) for i in range(0, x.shape[dim], C))


def _config(variant):
    """The array recipe (standard, channel add) or the flagship (complex),
    cut to a size the CPU renders in a fraction of a second; at 2 kHz every
    point's delay falls inside the T = 64 samples."""
    if variant == "complex":
        cfg = flagship_config(small=True)
        cfg.render.n_samples, cfg.render.fs = 8, 2000
        cfg.model.signal_output_dim = 64
        return cfg
    with open(ARRAY_RECIPE) as f:
        d = yaml.safe_load(f)
    d["render"].update(n_samples=8, n_azi=4, n_ele=2, fs=2000)
    d["model"]["signal_output_dim"] = 64
    for v in d["model"].values():
        if isinstance(v, dict) and "n_levels" in v:
            v.update(n_levels=2, log2_hashmap_size=6, base_resolution=2)
        if isinstance(v, dict) and "n_neurons" in v:
            v["n_neurons"] = 16
    return AVRConfig.from_dict(d)


def _setup(variant, K):
    """(cfg, static, params as leaves, render inputs); tables N(0, 1/4) and
    K trials' params stacked, each trial scaled apart."""
    cfg = _config(variant)
    fst = field.build_field(cfg.model, cfg.path.dataset_type)
    p0 = field.init(torch.Generator().manual_seed(0), fst, device="cpu")
    gen = torch.Generator().manual_seed(1)
    leaves = {n: (torch.randn(t.shape, generator=gen) * 0.5 if n.startswith("enc") else t)
              for n, t in st.named_leaves(p0)}
    if K:
        leaves = {n: torch.stack([t * (1 + 0.1 * k) + 0.01 * k for k in range(K)]) for n, t in leaves.items()}
    rng = np.random.default_rng(2)
    lo, hi = cfg.render.xyz_min[0], cfg.render.xyz_max[0]
    mid, half = (lo + hi) / 2, (hi - lo) / 4
    dirs = torch.from_numpy(rng.normal(size=(cfg.render.n_azi * cfg.render.n_ele + 2, 3)).astype(np.float32))
    kw = {
        "rays_o": torch.from_numpy(rng.uniform(mid - half, mid + half, (BS, 3)).astype(np.float32)),
        "position_tx": torch.from_numpy(rng.uniform(mid - half, mid + half, (BS, 3)).astype(np.float32)),
        "dirs": dirs / dirs.norm(dim=-1, keepdim=True),
    }
    if variant == "complex":
        kw["direction_tx"] = kw["dirs"][:BS].clone()
    else:
        kw["ch_idx"] = torch.arange(BS)
    return cfg, fst, p0, leaves, kw


def _render_and_grads(monkeypatch, variant, K, shell_chunk, compute_dtype, hand_off):
    """Render with ``hand_off`` as the plan's split, take the gradient of
    Σ out·G; return (out, the split tensors' gradients, the leaves')."""
    cfg, fst, p0, leaves, kw = _setup(variant, K)
    seen = []

    def recording(x, C, dim):
        if x.requires_grad:
            x.retain_grad()
        seen.append(x)
        return hand_off(x, C, dim)

    monkeypatch.setattr(fused, "shell_chunks", recording)
    leaves = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    out = fused.render_fused(
        st.unflatten(p0, leaves), fst, make_consts(cfg.render, cfg.model.signal_output_dim, device="cpu"),
        cfg.render, compute_dtype=compute_dtype, shell_chunk=shell_chunk, **kw,
    )
    G = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    (out * G).sum().backward()
    assert len(seen) == (4 if variant == "complex" else 3)  # sigma_feat, (psig,) dist, w
    return out.detach(), [x.grad for x in seen if x.requires_grad], {n: t.grad for n, t in leaves.items()}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shell_chunk", [1, 2, 8])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("variant", ["standard_add", "complex"])
def test_split_hand_off_is_bit_equal_to_slices(monkeypatch, variant, K, shell_chunk, compute_dtype):
    got = _render_and_grads(monkeypatch, variant, K, shell_chunk, compute_dtype, fused.shell_chunks)
    ref = _render_and_grads(monkeypatch, variant, K, shell_chunk, compute_dtype, sliced)
    assert torch.equal(got[0], ref[0])
    assert len(got[1]) == len(ref[1]) == (3 if variant == "complex" else 2)  # features, (psig,) w
    for g, r in zip(got[1], ref[1]):
        assert g is not None and torch.equal(g, r)
    assert got[2].keys() == ref[2].keys()
    n_grads = 0
    for n, g in got[2].items():
        r = ref[2][n]
        assert (g is None) == (r is None), n
        if g is not None:
            assert torch.equal(g, r), n
            n_grads += bool(g.abs().sum() > 0)
    assert n_grads >= len(got[2]) // 2  # the comparison is of gradients that carry something


@pytest.mark.parametrize("variant", ["standard_add", "complex"])
def test_backward_fills_no_full_size_feature_gradient(monkeypatch, variant):
    """One profiled backward of a precomputed render of K = 4 trials in 4
    chunks: no zero fill has the features' full shape, the graph holds one
    split of them and no slice, and the counter reads one; a streaming
    render and a render in one chunk count none."""
    from torch.profiler import ProfilerActivity, profile

    cfg, fst, p0, leaves, kw = _setup(variant, 4)
    consts = make_consts(cfg.render, cfg.model.signal_output_dim, device="cpu")
    shapes = []
    point_features = field.point_features

    def recording(*a, **k):
        outs = point_features(*a, **k)
        shapes.extend(list(o.shape) for o in outs if o is not None)
        return outs

    monkeypatch.setattr(field, "point_features", recording)
    leaves = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    profiling.drain()
    out = fused.render_fused(st.unflatten(p0, leaves), fst, consts, cfg.render, shell_chunk=2, **kw)
    feat_shape, psig_shape = shapes[0], shapes[2] if variant == "complex" else None
    assert feat_shape[-2] == cfg.render.n_samples and feat_shape[0] == 4
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out.sum().backward()
    full = [e.name for e in prof.events() if e.name in FILLS
            and any(list(s) in (feat_shape, psig_shape) for s in e.input_shapes)]
    assert full == [], f"zero fills of the features' full shape: {full}"

    nodes, todo, seen = [], [out.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            nodes.append(fn)
            todo.extend(f for f, _ in fn.next_functions)

    def on(name, shape):
        return [f for f in nodes if f.name() == name and list(f._saved_self_sym_sizes) == shape]

    for shape in (feat_shape, psig_shape) if variant == "complex" else (feat_shape,):
        assert on("SliceBackward0", shape) == []
        assert len(on("SplitBackward0", shape)) == 1
    assert profiling.drain()[1]["render.feature_splits"] == 1

    shapes.clear()
    with torch.no_grad():
        fused.render_fused(st.unflatten(p0, leaves), fst, consts, cfg.render, shell_chunk=2, point_budget=0, **kw)
        fused.render_fused(st.unflatten(p0, leaves), fst, consts, cfg.render, shell_chunk=8, **kw)
    assert shapes  # the one-chunk render took the precomputed plan
    assert "render.feature_splits" not in profiling.drain()[1]
