"""The MLPs' hidden-layer chain (``avr_torch.ops.mlp_act``).

On the CPU: the plain version against the MLPs' eager ops (the adds of the
context, bias and channel embedding, ``torch.relu`` and the bf16 cast;
autograd's ReLU backward and the sums of the broadcast adds), the chain
against the eager chain of ``mlp`` through whole networks, the cotangents
the backward hands the elementwise step, the renderer without the
[(K,) bs, R, 1, W] context tensor, and the wrapper's refusals. Tests marked
``card`` hold the kernels against the plain version on a CUDA card at the
recipes' shapes and skip without one: this file imports neither JAX nor the
conftest's helpers, so on the card it runs as
``python -m pytest --noconftest tests/test_torch_mlp_act.py``.
"""

import math

import pytest
import torch

from avr_torch.models import mlp
from avr_torch.ops import mlp_act as ma
from avr_torch.utils import profiling

torch.set_num_threads(2)

U = 2.0 ** -24

# The fp32 sums of the backward (bias, embedding, h_ray, h_batch) against the
# exact sum of their terms: within SUM_C·√n·u·‖terms‖₂ (u = 2^−24, n the
# terms an element adds, ‖·‖₂ the root of their sum of squares). A sum of
# terms of random sign rounds to about √n·u·‖terms‖₂ in any order. SUM_C is
# set from the worst reading of the kernels and the plain version on the
# card, 2.7 at h_ray's 8 terms (PERF.md §6). Summing g_pre in bf16, or
# leaving a sum at zero, breaks the limit at the median element of every
# sum at every shape; the worst-case 2·γ_n of Σ|terms| passes both where n
# is large.
SUM_C = 8.0


def sum_errors(got, g, mask, lay, ch=None, ch_num=0, bias=False, context=False, median=False):
    """Each sum's largest error against the exact (fp64) sum of its terms,
    or with ``median`` its median over the elements that add a term, as a
    share of SUM_C·√n·u·‖terms‖₂; ``got`` is act_backward's tuple and
    ``mask`` the bool mask [M, W]."""
    args = (lay, ch, ch_num, bias, context)
    g64 = g.double()
    ref, sq, n = (ma.act_backward_reference(x, mask, *args, out_dtype=torch.float64)[1:]
                  for x in (g64, g64 * g64, torch.ones_like(g64)))
    out = {}
    for name, a, r, q, c in zip(("bias", "emb", "h_ray", "h_batch"), got[1:], ref, sq, n):
        if r is None:
            assert a is None, name
            continue
        assert a is not None and a.dtype == torch.float32 and a.shape == r.shape, name
        err = (a.double() - r).abs()
        lim = SUM_C * c.sqrt() * U * q.sqrt()
        ratio = torch.where(lim > 0, err / lim.clamp_min(1e-300), torch.where(err > 0, float("inf"), 0.0))
        out[name] = float(ratio[c > 0].median() if median else ratio.max())
    return out


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal element for element, NaN where the other is NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all())


def inputs(K, B, R, C, W, context, bias, ch_num, device="cpu", seed=0, specials=False):
    """P [(K,) B, R, C, W] and the tables, as the MLPs hand them over."""
    g = torch.Generator(device=device).manual_seed(seed)
    lead = (B, R, C) if K is None else (K, B, R, C)
    kk = () if K is None else (K,)
    p = torch.randn((*lead, W), generator=g, device=device)
    if specials:  # zeros of both signs, NaN, ±inf and subnormals on the first row
        row = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1e-40, -1e-40, 3e-39],
                           device=device)
        p.reshape(-1, W)[0, :8] = row
    t = {}
    if context:
        t["h_ray"] = torch.randn((*kk, R, W), generator=g, device=device)
        t["h_batch"] = torch.randn((*kk, B, W), generator=g, device=device)
    if bias:
        t["bias"] = torch.randn((*kk, W), generator=g, device=device)
    if ch_num:
        t["emb"] = torch.randn((*kk, ch_num, W), generator=g, device=device)
        t["ch"] = (torch.arange(B, device=device) * 5 + 3) % ch_num
    return p, t


def eager(p, t):
    """The MLPs' eager forward before the kernels: fused.py's h_extra, then
    mlp.apply_tail's bias, channel embedding and ReLU; fp32."""
    h = p
    if "h_ray" in t:
        h_extra = t["h_ray"].unsqueeze(-2).unsqueeze(-4) + t["h_batch"].unsqueeze(-2).unsqueeze(-2)
        h = h + h_extra
    if "bias" in t:
        h = h + mlp.per_trial(t["bias"], h)
    if "emb" in t:
        h = h + mlp.rows(t["emb"], t["ch"][:, None, None])
    return torch.relu(h)


def layout(p, K, t):
    return ma.Layout(K or 1, *p.shape[-4:-1])


def call_forward(p, K, t, fn=ma.act_reference):
    lay = layout(p, K, t)
    return fn(p.reshape(-1, p.shape[-1]), lay, t.get("bias"), t.get("emb"), t.get("ch"), t.get("h_ray"),
              t.get("h_batch"))


CASES = {
    "layer": dict(K=None, B=2, R=5, C=1, W=16, context=False, bias=True, ch_num=3),
    "layer_K3": dict(K=3, B=2, R=5, C=2, W=24, context=False, bias=True, ch_num=3),
    "layer_no_emb": dict(K=3, B=1, R=7, C=1, W=16, context=False, bias=True, ch_num=0),
    "signal0": dict(K=None, B=2, R=5, C=1, W=16, context=True, bias=False, ch_num=3),
    "signal0_K3_C2": dict(K=3, B=2, R=4, C=2, W=24, context=True, bias=False, ch_num=4),
    "signal0_complex": dict(K=None, B=3, R=4, C=3, W=16, context=True, bias=False, ch_num=0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_is_the_eager_chain(case):
    """Bit-equal: the same fp32 adds in the same order, then ReLU and the
    cast; the mask is where ReLU's backward lets the gradient through."""
    kw = CASES[case]
    p, t = inputs(**kw, specials=True)
    a, mask = call_forward(p, kw["K"], t)
    ref = eager(p, t)
    assert same(a, ref.to(torch.bfloat16).reshape(a.shape))
    assert torch.equal(mask, ~(ref <= 0).reshape(mask.shape))
    bare = ma.act_reference(p.reshape(-1, p.shape[-1]), layout(p, kw["K"], t))[1]
    assert bare[0, :8].tolist() == [False, False, True, True, False, True, False, True]
    assert same(ma.act_forward(p.reshape(-1, p.shape[-1]), layout(p, kw["K"], t), t.get("bias"), t.get("emb"),
                               t.get("ch"), t.get("h_ray"), t.get("h_batch"))[0], a)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_is_the_eager_chain(case):
    """g_pre bit-equal to autograd's gradient of P through the eager chain
    (and its bf16 cast bit-equal to what the GEMMs read); each sum, and
    autograd's, within SUM_C·√n·u·‖terms‖₂ of the exact sum; the sums of g
    rounded to bf16 and sums left at zero are not, at the median element."""
    kw = CASES[case]
    p, t = inputs(**kw)
    K, W = kw["K"], kw["W"]
    leaves = {k: v.requires_grad_(True) for k, v in t.items() if k != "ch"}
    p.requires_grad_(True)
    ref_out = eager(p, t)
    g = torch.randn(ref_out.shape, generator=torch.Generator().manual_seed(5))
    names = ["p", *leaves]
    ref = dict(zip(names, torch.autograd.grad(ref_out, [p, *leaves.values()], g)))
    _, mask = call_forward(p.detach(), K, t)
    lay = layout(p, K, t)
    g2 = g.reshape(-1, W)
    args = (lay, t.get("ch"), kw["ch_num"], kw["bias"], kw["context"])
    got = ma.act_backward(g2, mask, *args, torch.float32)
    gp16 = ma.act_backward(g2, mask, *args)[0]
    assert torch.equal(got[0], ref["p"].reshape(got[0].shape))
    assert gp16.dtype == torch.bfloat16 and torch.equal(gp16, ref["p"].reshape(gp16.shape).to(torch.bfloat16))
    errs = sum_errors(got, g2, mask, *args)
    assert errs and max(errs.values()) <= 1, errs
    autograd_sums = [None] + [ref[n].reshape(x.shape) if n in ref else None
                              for n, x in zip(("bias", "emb", "h_ray", "h_batch"), got[1:])]
    assert max(sum_errors(autograd_sums, g2, mask, *args).values()) <= 1
    bf16 = sum_errors(ma.act_backward(g2.bfloat16().float(), mask, *args, torch.float32), g2, mask, *args,
                      median=True)
    zero = sum_errors([None] + [None if x is None else torch.zeros_like(x) for x in got[1:]], g2, mask, *args,
                      median=True)
    assert min(bf16.values()) > 1 and min(zero.values()) > 1, (bf16, zero)


def _static(inject, use_bias=True, H=3, act="ReLU", out_act="None", W=16):
    return mlp.MLPStatic(n_input_dims=12, n_output_dims=8, n_neurons=W, n_hidden_layers=H, activation=act,
                         output_activation=out_act, use_bias=use_bias, inject=inject, ch_num=4)


def _params(st, K, seed=1):
    g = torch.Generator().manual_seed(seed)
    p = mlp.init(g, st, device="cpu")
    p["b"] = [torch.randn(b.shape, generator=g) for b in p["b"]]
    if K:
        p = {k: [torch.stack([v * (1 + 0.1 * i) for i in range(K)]) for v in vs] for k, vs in p.items()}
    return p


def eager_apply(params, st, x, ch, cd):
    """mlp.apply as the eager chain computes it: the fused path disabled."""
    h = mlp._matmul(x, params["w"][0], cd)
    if st.use_bias:
        h = h + mlp.per_trial(params["b"][0], h)
    for layer in range(st.n_hidden_layers):
        if layer > 0:
            h = mlp._matmul(h, params["w"][layer], cd)
            if st.use_bias:
                h = h + mlp.per_trial(params["b"][layer], h)
        if st.inject and ch is not None:
            h = h + mlp.rows(params["emb"][layer], ch)
        h = torch.relu(h)
    h = mlp._matmul(h, params["w"][-1], cd)
    return h + mlp.per_trial(params["b"][-1], h) if st.use_bias else h


def _leaves(params):
    return [t.requires_grad_(True) for vs in params.values() for t in vs]


def _close_grads(got, ref):
    """Gradients equal but for the order of the bias, embedding and context
    sums: within 1e-6 of each gradient's scale."""
    for a, r in zip(got, ref):
        if a is None or r is None:
            assert a is None and r is None
            continue
        assert a.shape == r.shape and a.dtype == r.dtype
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6 * max(r.abs().max().item(), 1e-30))


@pytest.mark.parametrize("K", [0, 3])
@pytest.mark.parametrize("inject,use_bias", [(True, True), (False, True), (True, False)])
def test_apply_is_the_eager_chain(K, inject, use_bias):
    """mlp.apply in bf16 compute (the chain) against the eager chain: the
    output bit-equal, the gradients equal up to the sums' order."""
    st = _static(inject, use_bias)
    params = _params(st, K)
    lead = (K,) if K else ()
    x = torch.randn(*lead, 2, 5, 3, 12, generator=torch.Generator().manual_seed(2), requires_grad=True)
    ch = torch.tensor([1, 3])[:, None, None]
    leaves = [x, *_leaves(params)]
    out = mlp.apply(params, st, x, ch_idx=ch, compute_dtype=torch.bfloat16)
    ref = eager_apply(params, st, x, ch, torch.bfloat16)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    _close_grads(torch.autograd.grad(out, leaves, g), torch.autograd.grad(ref, leaves, g))


@pytest.mark.parametrize("variant", ["standard", "complex"])
@pytest.mark.parametrize("K", [0, 2])
def test_apply_parts_is_the_eager_chain(variant, K):
    """The signal network's factored first layer with the (h_ray, h_batch)
    context against the eager chain on their [(K,) B, R, 1, W] sum (the
    renderer's earlier h_extra): output bit-equal, gradients equal up to the
    sums' order; the complex variant sums two parts' products."""
    st = _static(variant == "standard")
    params = _params(st, K)
    gen = torch.Generator().manual_seed(4)
    kk = (K,) if K else ()
    B, R, C = 2, 5, 2
    sizes = [7, 5] if variant == "complex" else [12]
    xs = [torch.randn(*kk, B, R, C, s, generator=gen, requires_grad=True) for s in sizes]
    h_ray = torch.randn(*kk, R, 16, generator=gen, requires_grad=True)
    h_batch = torch.randn(*kk, B, 16, generator=gen, requires_grad=True)
    ch = torch.tensor([2, 0])[:, None, None] if variant == "standard" else None
    leaves = [*xs, h_ray, h_batch, *_leaves(params)]
    slices = mlp.input_weight_slices(params, sizes)
    out, bias = mlp.apply_parts(params, st, list(zip(xs, slices)), (h_ray, h_batch), ch_idx=ch,
                                compute_dtype=torch.bfloat16, split_bias=True)
    h = sum(mlp._matmul(x, w, torch.bfloat16) for x, w in zip(xs, slices))
    h = h + (h_ray.unsqueeze(-2).unsqueeze(-4) + h_batch.unsqueeze(-2).unsqueeze(-2))
    ref, ref_bias = _eager_tail(params, st, h, ch)
    assert bias is params["b"][-1] and ref_bias is bias
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
    # the first bias is folded into h_batch by signal_context: unused here
    _close_grads(torch.autograd.grad(out, leaves, g, allow_unused=True),
                 torch.autograd.grad(ref, leaves, g, allow_unused=True))


def _eager_tail(params, st, h, ch):
    """mlp.apply_tail's eager chain in bf16 compute, split_bias=True."""
    for layer in range(st.n_hidden_layers):
        if layer > 0:
            h = mlp._matmul(h, params["w"][layer], torch.bfloat16)
            h = h + mlp.per_trial(params["b"][layer], h)
        if st.inject and ch is not None:
            h = h + mlp.rows(params["emb"][layer], ch)
        h = torch.relu(h)
    return mlp._matmul(h, params["w"][-1], torch.bfloat16), params["b"][-1]


@pytest.mark.parametrize("act,cd", [("Sigmoid", torch.bfloat16), ("ReLU", None)])
def test_other_activations_and_fp32_keep_the_eager_chain(act, cd, monkeypatch):
    """Chosen from MLPStatic and the compute dtype, never on an error: a
    sigmoid network or fp32 compute never reaches the chain."""
    st = _static(True, act=act)
    params = _params(st, 0)
    monkeypatch.setattr(ma, "hidden_chain", lambda *a, **k: pytest.fail("took the chain"))
    x = torch.randn(2, 5, 12, generator=torch.Generator().manual_seed(7))
    mlp.apply(params, st, x, ch_idx=torch.tensor([1, 2])[:, None], compute_dtype=cd)
    assert not mlp._fused(st, cd)


def test_no_grad_runs_the_chain_without_masks(monkeypatch):
    """Under inference_mode the chain asks for no mask and gives the output
    of the autograd function bit for bit."""
    st = _static(True)
    params = _params(st, 2)
    x = torch.randn(2, 2, 5, 12, generator=torch.Generator().manual_seed(8))
    ch = torch.tensor([0, 3])[:, None]
    want = []
    real = ma.act_forward

    def spy(*a, want_mask=True, **k):
        want.append(want_mask)
        return real(*a, want_mask=want_mask, **k)

    monkeypatch.setattr(ma, "act_forward", spy)
    with torch.inference_mode():
        fast = mlp.apply(params, st, x, ch_idx=ch, compute_dtype=torch.bfloat16)
    slow = mlp.apply({k: [t.requires_grad_(True) for t in vs] for k, vs in params.items()}, st, x, ch_idx=ch,
                     compute_dtype=torch.bfloat16)
    assert want == [False] * 3 + [True] * 3
    assert torch.equal(fast, slow.detach())


def test_autograd_rounds_a_cotangent_to_its_tensors_dtype():
    """Why the chain is one autograd function: a backward that returns an fp32
    gradient for a bf16 input has it cast to bf16 before the producer's
    backward reads it, so a bf16 activation between two functions would round
    the matmul's fp32 cotangent before ReLU's mask and the sums."""
    seen = []

    class Widen(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.float() * 3

        @staticmethod
        def backward(ctx, g):
            return g * 3  # fp32, for a bf16 input

    class Narrow(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.to(torch.bfloat16)

        @staticmethod
        def backward(ctx, g):
            seen.append(g.dtype)
            return g.float()

    x = torch.randn(4, requires_grad=True)
    Widen.apply(Narrow.apply(x)).sum().backward()
    assert seen == [torch.bfloat16]


def test_chain_backward_reads_fp32_cotangents(monkeypatch):
    """The cotangent each hidden layer's backward reads is the fp32 product
    g_next @ wᵀ, unrounded (it holds values no bf16 holds), and what the
    GEMMs read is bf16; the first product's cotangent in the product mode is
    fp32 g_pre."""
    st = _static(True)
    params = _params(st, 0)
    seen = []
    real = ma.act_backward

    def spy(g, mask, lay, *a, **k):
        out = real(g, mask, lay, *a, **k)
        seen.append((g, out[0]))
        return out

    monkeypatch.setattr(ma, "act_backward", spy)
    x = torch.randn(2, 5, 12, generator=torch.Generator().manual_seed(9), requires_grad=True)
    ch = torch.tensor([1, 2])[:, None]
    leaves = [x, *_leaves(params)]
    out = mlp.apply(params, st, x, ch_idx=ch, compute_dtype=torch.bfloat16)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(10))
    torch.autograd.grad(out, leaves, g)
    assert len(seen) == st.n_hidden_layers
    for gin, gpre in seen:
        assert gin.dtype == torch.float32 and not torch.equal(gin, gin.to(torch.bfloat16).float())
        assert gpre.dtype == torch.bfloat16
    w_out = params["w"][-1].to(torch.bfloat16)
    first = ma.mm_f32(g.reshape(-1, 8).to(torch.bfloat16), w_out.t())
    assert torch.equal(seen[0][0], first)
    # the product mode hands its first product fp32 g_pre
    h = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(11), requires_grad=True)
    seen.clear()
    out = mlp.apply_tail(params, st, h, ch_idx=ch, compute_dtype=torch.bfloat16)
    (gh,) = torch.autograd.grad(out, [h], torch.ones_like(out))
    assert gh.dtype == torch.float32 and seen[-1][1].dtype == torch.float32
    assert torch.equal(gh.reshape(-1, 16), seen[-1][1])


def _tiny_render(W=24, n_samples=4, device="cpu"):
    """A tiny standard field with channel "add" injection, its signal
    network W wide, and a render's arguments: (params, field static, the
    render's positional arguments, its keyword arguments)."""
    from avr_torch.config import EncodingConfig, ModelConfig, MLPConfig, RenderConfig
    from avr_torch.models import field
    from avr_torch.render.common import make_consts

    enc = EncodingConfig(n_levels=2, n_features_per_level=2, log2_hashmap_size=6, base_resolution=4,
                         per_level_scale=1.5)
    mcfg = ModelConfig(signal_output_dim=16, leaky_relu=0.03, pos_encoding_sigma=enc, dir_encoding_sig=enc,
                       tx_encoding_sig=enc, sigma_encoder_network=MLPConfig(n_neurons=16, n_hidden_layers=2),
                       sigma_decoder_network=MLPConfig(n_neurons=16, n_hidden_layers=1),
                       signal_network=MLPConfig(n_neurons=W, n_hidden_layers=2))
    ce = mcfg.channel_embed
    ce.is_embed, ce.ch_num, ce.is_sigma_encoder, ce.is_signal_network = True, 4, True, True
    rc = RenderConfig(xyz_min=[-2.0] * 3, xyz_max=[2.0] * 3, near=0.1, far=2.0, n_samples=n_samples, n_azi=4,
                      n_ele=2, speed=343.8, fs=2000, pathloss=1.5)
    fst = field.build_field(mcfg, "Real_env")
    assert fst.sig_mode == "add"
    params = _tree_map(lambda t: t.to(device), field.init(torch.Generator().manual_seed(0), fst, device="cpu"))
    bs, R = 2, 7
    gen = torch.Generator().manual_seed(1)
    dirs = torch.nn.functional.normalize(torch.randn(R, 3, generator=gen), dim=-1)
    pos = [(torch.rand(bs, 3, generator=gen) - 0.5).to(device) for _ in range(2)]
    return params, fst, (fst, make_consts(rc, 16, device=device), rc, *pos), dict(
        ch_idx=torch.tensor([1, 3], device=device), dirs=dirs.to(device), compute_dtype=torch.bfloat16)


def test_renderer_forms_no_full_context_tensor(monkeypatch):
    """Outside the elementwise step (whose plain version adds h_ray + h_batch
    per chunk, as the eager chain did, and whose kernel forms no such tensor)
    a train step's render and backward create no [(K,) bs, R, 1, W] tensor
    of the signal network's width: not the context's sum, not its gradient
    accumulated over the chunks. Shell chunks of 2, so no chunk's own rows
    take that shape."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from avr_torch.render.fused import render_fused

    W, bs, R = 24, 2, 7
    params, _, args, kw = _tiny_render(W)
    leaves = [t.requires_grad_(True) for t in _tree_leaves(params)]
    shapes, inside = [], [0]
    for name in ("act_reference", "act_backward_reference"):
        real = getattr(ma, name)

        def paused(*a, _real=real, **k):
            inside[0] += 1
            try:
                return _real(*a, **k)
            finally:
                inside[0] -= 1

        monkeypatch.setattr(ma, name, paused)

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(o, torch.Tensor) and not inside[0]:
                    shapes.append(tuple(o.shape))
            return out

    with Record():
        spec = render_fused(params, *args, **kw, shell_chunk=2)
        torch.autograd.grad(spec.sum(), leaves, allow_unused=True)
    assert (bs * R * 2, W) in shapes  # a chunk's rows: the record sees the signal pass
    assert (R, W) in shapes and (bs, W) in shapes  # the context, and its gradients
    assert not [s for s in shapes if s[-4:] == (bs, R, 1, W)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_layout_of_groups_rows_by_channel():
    """Channels per batch element make the batch groups; per-point channels
    (the oracle's expanded ones) make every row a group; none, one group."""
    ch = torch.tensor([2, 0, 1])
    lay, groups = ma.layout_of((3, 5, 4), 2, ch[:, None, None], False)
    assert lay == ma.Layout(2, 3, 20, 1) and torch.equal(groups, ch)
    lay, groups = ma.layout_of((3, 5, 4), 0, ch[:, None, None].expand(3, 5, 4), False)
    assert lay == ma.Layout(1, 3, 20, 1) and torch.equal(groups, ch)
    full = torch.arange(60).reshape(3, 5, 4) % 3
    lay, groups = ma.layout_of((3, 5, 4), 0, full, False)
    assert lay == ma.Layout(1, 60, 1, 1) and torch.equal(groups, full.reshape(-1))
    assert ma.layout_of((3, 5, 4), 0, None, False) == (ma.Layout(1, 1, 60, 1), None)
    lay, groups = ma.layout_of((3, 5, 4), 4, ch[:, None, None], True)
    assert lay == ma.Layout(4, 3, 5, 4) and torch.equal(groups, ch)
    with pytest.raises(ValueError):
        ma.layout_of((3, 5, 4), 0, full, True)


def test_wrapper_refuses_what_it_does_not_take():
    p, t = inputs(K=None, B=2, R=4, C=1, W=16, context=True, bias=False, ch_num=3)
    lay = ma.Layout(1, 2, 4, 1)
    p2 = p.reshape(-1, 16)
    with pytest.raises(ValueError):  # a device that is neither the CPU nor CUDA
        ma.act_forward(p2.to("meta"), lay, h_ray=t["h_ray"].to("meta"), h_batch=t["h_batch"].to("meta"))
    with pytest.raises(ValueError):  # mixed devices
        ma.act_forward(p2, lay, h_ray=t["h_ray"].to("meta"), h_batch=t["h_batch"])
    with pytest.raises(ValueError):  # the kernels take CUDA tensors only
        ma._forward_kernel(p2, lay, h_ray=t["h_ray"], h_batch=t["h_batch"])
    with pytest.raises(ValueError):
        ma._backward_kernel(p2, torch.zeros(8, 2, dtype=torch.uint8), lay)


@pytest.mark.parametrize("C", [1, 2, 3, 6, 8, 12, 32, 64])
@pytest.mark.parametrize("W", [24, 128, 512])
def test_backward_plan_takes_any_shell_chunk(C, W):
    """With the context a tile holds whole rays at any shell chunk C (every
    divisor of the recipes' sample counts up to train.shell_chunk), its
    shells split over power-of-two groups of thread rows; without it, tiles
    of rows."""
    rpi = 256 // (W // 8)
    for K, B, R in ((4, 8, 2050), (1, 4, 650), (1, 2, 7)):
        plan = ma.backward_plan(ma.Layout(K, B, R, C), W, True, 132)
        G = plan["groups"]
        assert G & (G - 1) == 0 and rpi % G == 0 and G <= C and (2 * G > C or rpi % (2 * G))
        assert plan["nray"] == plan["nr"] in (1, 2, 4) and plan["units"] == rpi // G * plan["nr"]
        assert plan["n_tiles"] == -(-R // plan["units"]) and plan["b_per_block"] == B
        plain = ma.backward_plan(ma.Layout(K, B, R, C), W, False, 132)
        assert plain["nray"] == 0 and plain["groups"] == 1 and plain["n_tiles"] * plain["units"] >= R * C


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mlp_act kernels have no CPU mode")
    return torch.device("cuda", 0)


# The recipes' hidden layers: (K, B, R, C, W, context, bias, ch_num)
CARD_SHAPES = {
    "pop4_signal0": (4, 8, 2050, 1, 512, True, False, 8),  # array recipe, 4 trials, first signal layer
    "pop4_signal": (4, 8, 2050, 1, 512, False, True, 8),
    "array_signal0": (None, 8, 2050, 1, 512, True, False, 8),  # one trial; the render's chunk too
    "array_signal": (None, 8, 2050, 1, 512, False, True, 8),
    "flagship_signal0": (None, 4, 650, 8, 512, True, False, 0),  # RAF recipe, shell_chunk 8, no channels
    "flagship_signal": (None, 4, 650, 8, 512, False, True, 0),
    "pop4_sigma_encoder": (4, 8, 131200, 1, 128, False, True, 8),  # 4,198,400 points, 128 wide
    "pop4_sigma_decoder": (4, 1, 1049600, 1, 128, False, True, 0),
    # shell chunks beside the recipes': 32 (shells split over 4 groups) and 3 (2 uneven groups)
    "flagship_signal0_C32": (None, 4, 650, 32, 512, True, False, 0),
    "pop4_signal0_C3": (4, 8, 2050, 3, 512, True, False, 8),
}


def unpack(mask: torch.Tensor) -> torch.Tensor:
    """The kernel's mask bits [M, W/8] as bool [M, W]."""
    bits = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=mask.device)
    return ((mask[..., None] & bits) != 0).reshape(mask.shape[0], -1)


def card_case(dev, shape, seed=0):
    K, B, R, C, W, context, bias, ch_num = CARD_SHAPES[shape]
    p, t = inputs(K, B, R, C, W, context, bias, ch_num, device=dev, seed=seed)
    return p.reshape(-1, W), ma.Layout(K or 1, B, R, C), t, (bias, ch_num, context)


def _fwd(fn, p, lay, t, **kw):
    return fn(p, lay, t.get("bias"), t.get("emb"), t.get("ch"), t.get("h_ray"), t.get("h_batch"), **kw)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_card_forward_matches_plain(card, shape):
    """A and the mask bit-equal to the plain version (the same fp32 adds in
    the same order); a second launch bit-equal; without a mask the same A."""
    p, lay, t, _ = card_case(card, shape)
    a, mask = _fwd(ma._forward_kernel, p, lay, t)
    a2, mask2 = _fwd(ma._forward_kernel, p, lay, t)
    a3, none = _fwd(ma._forward_kernel, p, lay, t, want_mask=False)
    ra, rmask = _fwd(ma.act_reference, p, lay, t)
    torch.cuda.synchronize()
    assert none is None and torch.equal(a, a2) and torch.equal(mask, mask2) and torch.equal(a, a3)
    assert torch.equal(a, ra) and torch.equal(unpack(mask), rmask)
    assert 0.3 < float(rmask.float().mean()) < 0.7


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_card_backward_matches_plain(card, shape):
    """g_pre bit-equal in bf16 and in fp32; each sum, the kernel's and the
    plain version's on the card, within SUM_C·√n·u·‖terms‖₂ of the exact sum;
    a second launch bit-equal (no atomics)."""
    p, lay, t, (bias, ch_num, context) = card_case(card, shape)
    _, mask = _fwd(ma._forward_kernel, p, lay, t)
    rmask = unpack(mask)
    g = torch.randn(p.shape, generator=torch.Generator(device=card).manual_seed(3), device=card)
    args = (lay, t.get("ch"), ch_num, bias, context)
    got = ma._backward_kernel(g, mask, *args)
    again = ma._backward_kernel(g, mask, *args)
    got32 = ma._backward_kernel(g, mask, *args, out_dtype=torch.float32)
    ref = ma.act_backward_reference(g, rmask, *args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(got, again))
    assert torch.equal(got[0], ref[0].to(torch.bfloat16)) and torch.equal(got32[0], ref[0])
    errs = sum_errors(got, g, rmask, *args)
    assert errs and max(errs.values()) <= 1, errs
    plain = sum_errors(ref, g, rmask, *args)
    assert max(plain.values()) <= 1, plain


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_card_limits_fail_a_bf16_product(card, shape):
    """The controls: the kernel given P rounded to bf16 before the adds breaks
    the forward's bit-equality; the kernel given g rounded to bf16, and sums
    left at zero, break every sum's limit at its median element."""
    p, lay, t, (bias, ch_num, context) = card_case(card, shape)
    a_c, _ = _fwd(ma._forward_kernel, p.bfloat16().float(), lay, t)
    ra, rmask = _fwd(ma.act_reference, p, lay, t)
    assert not torch.equal(a_c, ra)
    g = torch.randn(p.shape, generator=torch.Generator(device=card).manual_seed(3), device=card)
    args = (lay, t.get("ch"), ch_num, bias, context)
    _, mask = _fwd(ma._forward_kernel, p, lay, t)
    bf16 = sum_errors(ma._backward_kernel(g.bfloat16().float(), mask, *args), g, rmask, *args, median=True)
    got = ma._backward_kernel(g, mask, *args)
    zero = sum_errors([None] + [None if x is None else torch.zeros_like(x) for x in got[1:]], g, rmask, *args,
                      median=True)
    assert bf16 and min(bf16.values()) > 1 and min(zero.values()) > 1, (bf16, zero)


@pytest.mark.card
@pytest.mark.parametrize("K", [0, 4])
def test_card_chain_matches_the_plain_chain(card, K, monkeypatch):
    """mlp.apply on the card against the same chain with the plain versions
    in the kernels' place (same cuBLAS products): output bit-equal, gradients
    equal up to the sums' order; one forward and one backward launch per
    hidden layer, no more."""
    st = _static(True, W=512, H=3)
    params = {k: [v.to(card).requires_grad_(True) for v in vs] for k, vs in _params(st, K).items()}
    lead = (K,) if K else ()
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(*lead, 8, 300, 1, 12, generator=gen, device=card, requires_grad=True)
    ch = torch.arange(8, device=card)[:, None, None] % 4
    leaves = [x, *[t for vs in params.values() for t in vs]]
    before = profiling.counters()
    out = mlp.apply(params, st, x, ch_idx=ch, compute_dtype=torch.bfloat16)
    g = torch.randn(out.shape, generator=gen, device=card)
    got = torch.autograd.grad(out, leaves, g)
    after = profiling.counters()
    for key in ("mlp_act.fwd_launches", "mlp_act.bwd_launches"):
        assert after.get(key, 0) - before.get(key, 0) == st.n_hidden_layers
    monkeypatch.setattr(ma, "act_forward", lambda p, lay, *a, want_mask=True, **k: ma.act_reference(p, lay, *a, **k))
    monkeypatch.setattr(ma, "act_backward", ma.act_backward_reference)
    ref_out = mlp.apply(params, st, x, ch_idx=ch, compute_dtype=torch.bfloat16)
    ref = torch.autograd.grad(ref_out, leaves, g)
    assert torch.equal(out, ref_out)
    _close_grads(got, ref)


@pytest.mark.card
@pytest.mark.parametrize("C", [3, 32])
def test_card_render_trains_at_any_shell_chunk(card, C, monkeypatch):
    """A bf16 render and its backward at shell chunk C, the signal network
    512 wide, against the same with the plain versions in the kernels' place:
    spectra bit-equal, gradients equal up to the sums' order, one backward
    launch of the first signal layer per chunk."""
    from avr_torch.render.fused import render_fused

    params, _, args, kw = _tiny_render(W=512, n_samples=96, device=card)
    leaves = [t.requires_grad_(True) for t in _tree_leaves(params)]
    before = profiling.counters()
    spec = render_fused(params, *args, **kw, shell_chunk=C)
    g = torch.randn(spec.shape, generator=torch.Generator(device=card).manual_seed(4), device=card)
    got = torch.autograd.grad(spec, leaves, g, allow_unused=True)
    after = profiling.counters()
    # per chunk: the signal network's 2 hidden layers, forward, recompute and backward
    chunks = 96 // C
    assert after["mlp_act.bwd_launches"] - before.get("mlp_act.bwd_launches", 0) >= 2 * chunks
    monkeypatch.setattr(ma, "act_forward", lambda p, lay, *a, want_mask=True, **k: ma.act_reference(p, lay, *a, **k))
    monkeypatch.setattr(ma, "act_backward", ma.act_backward_reference)
    ref_spec = render_fused(params, *args, **kw, shell_chunk=C)
    ref = torch.autograd.grad(ref_spec, leaves, g, allow_unused=True)
    assert torch.equal(spec, ref_spec)
    _close_grads(got, ref)


@pytest.mark.card
def test_card_tables_at_any_offset(card):
    """Tables that are views into flat buffers at an offset of one float (as
    parameters broadcast in flat buckets are) give the aligned tables'
    results bit for bit."""
    p, lay, t, _ = card_case(card, "array_signal")
    shifted = {}
    for k, v in t.items():
        if v.is_floating_point():
            flat = torch.empty(v.numel() + 1, device=card)
            flat[1:] = v.reshape(-1)
            shifted[k] = flat[1:].view(v.shape)
            assert shifted[k].data_ptr() % 16
        else:
            shifted[k] = v
    assert torch.equal(_fwd(ma._forward_kernel, p, lay, t)[0], _fwd(ma._forward_kernel, p, lay, shifted)[0])
    p0, lay0, t0, _ = card_case(card, "array_signal0")
    t0s = {k: (torch.cat([torch.zeros(1, device=card), v.reshape(-1)])[1:].view(v.shape)
               if v.is_floating_point() else v) for k, v in t0.items()}
    assert torch.equal(_fwd(ma._forward_kernel, p0, lay0, t0)[0], _fwd(ma._forward_kernel, p0, lay0, t0s)[0])
    assert math.isfinite(float(p.sum()))
