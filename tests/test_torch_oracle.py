"""avr_torch's ``render_oracle``: against the JAX package's oracle (CPU,
fp32, forward and gradients of every leaf), and as the yardstick of the
port's own ``render_fused`` over both plans, as tests/test_render.py holds
the JAX renderers. Forward within 5e-5 of scale, gradients within 1e-4.
"""

import jax.numpy as jnp
import pytest
import torch

from avr_tpu.render import common as jcommon
from avr_tpu.render import oracle as joracle
from test_torch_field import _rel
from test_torch_field_standard import check_vjp
from test_torch_render import _scene
from test_torch_render_plans import variant_setup

from avr_torch.render import common as tcommon
from avr_torch.render.fused import render_fused
from avr_torch.render.oracle import render_oracle
from avr_torch.train.state import named_leaves, unflatten

torch.set_num_threads(2)


def _inputs(variant):
    """Port params and static, consts, render config and the scene's tensors."""
    _, _, tparams, tfst, ch = variant_setup(variant)
    rc, rays_o, tx, tx_view, dirs, target = _scene()
    t = torch.from_numpy
    kw = dict(
        direction_tx=t(tx_view) if variant == "complex" else None,
        ch_idx=None if ch is None else t(ch), dirs=t(dirs),
    )
    return tparams, tfst, tcommon.make_consts(rc, 64, device="cpu"), rc, t(rays_o), t(tx), kw, t(target)


@pytest.mark.parametrize("variant", ["standard_add", "standard_concat", "complex"])
def test_render_oracle_matches_jax(variant):
    jparams, jfst, tparams, tfst, ch = variant_setup(variant)
    rc, rays_o, tx, tx_view, dirs, _ = _scene()
    if variant != "complex":
        tx_view = None
    jc, tc = jcommon.make_consts(rc, 64), tcommon.make_consts(rc, 64, device="cpu")
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    check_vjp(
        lambda p: (joracle.render_oracle(p, jfst, jc, rc, j(rays_o), j(tx), direction_tx=j(tx_view),
                                         ch_idx=j(ch), dirs=j(dirs)),),
        lambda p: (render_oracle(p, tfst, tc, rc, t(rays_o), t(tx), direction_tx=t(tx_view),
                                 ch_idx=t(ch), dirs=t(dirs)),),
        jparams, tparams,
    )


@pytest.mark.parametrize("variant", ["standard_add", "complex"])
@pytest.mark.parametrize("shell_chunk", [1, 4])
@pytest.mark.parametrize("point_budget", [4_000_000, 0], ids=["precomputed", "streaming"])
def test_fused_matches_oracle_forward(variant, shell_chunk, point_budget):
    params, fst, consts, rc, rays_o, tx, kw, _ = _inputs(variant)
    with torch.no_grad():
        ref = render_oracle(params, fst, consts, rc, rays_o, tx, **kw)
        got = render_fused(params, fst, consts, rc, rays_o, tx, **kw, compute_dtype=None,
                           shell_chunk=shell_chunk, point_budget=point_budget)
    assert got.shape == ref.shape == (2, 33, 2)
    assert _rel(got.numpy(), ref.numpy()) < 5e-5


@pytest.mark.parametrize("variant", ["standard_add", "standard_concat"])
@pytest.mark.parametrize("point_budget", [4_000_000, 0], ids=["precomputed", "streaming"])
def test_fused_matches_oracle_gradients(variant, point_budget):
    params, fst, consts, rc, rays_o, tx, kw, target = _inputs(variant)
    grads = []
    for render, extra in ((render_oracle, {}), (render_fused, dict(
            compute_dtype=None, shell_chunk=2, point_budget=point_budget))):
        leaves = {n: t.detach().requires_grad_(True) for n, t in named_leaves(params)}
        out = render(unflatten(params, leaves), fst, consts, rc, rays_o, tx, **kw, **extra)
        loss = torch.mean((out - target) ** 2)
        grads.append(torch.autograd.grad(loss, list(leaves.values()), allow_unused=True))
    for (name, _), a, b in zip(named_leaves(params), *grads):
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(b.numpy(), a.numpy()) < 1e-4, name


def test_channels_change_the_render():
    params, fst, consts, rc, rays_o, tx, kw, _ = _inputs("standard_add")
    with torch.no_grad():
        a = render_fused(params, fst, consts, rc, rays_o, tx, **kw, compute_dtype=None)
        kw["ch_idx"] = torch.tensor([1, 1])
        b = render_fused(params, fst, consts, rc, rays_o, tx, **kw, compute_dtype=None)
    assert float((a - b).abs().max()) > 1e-7
