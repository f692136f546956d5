"""Parity of avr_torch's standard field variant, its microphone-channel
embeddings and the MLP injection with the JAX package (CPU, fp32).

Params come from the JAX ``init`` with the hash tables refilled with
N(0,1) numpy values and reach the port through ``params_from_jax``.
Tolerances are those of tests/test_render.py: forward 5e-5 of scale,
gradients 1e-4 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import ChannelEmbedConfig
from avr_tpu.models import field as jfield
from avr_tpu.models import mlp as jmlp
from conftest import tiny_model_config
from test_torch_field import _rel, complex_setup, context_pair, with_bias

from avr_torch.convert import params_from_jax, params_to_numpy
from avr_torch.models import field as tfield
from avr_torch.models import mlp as tmlp

torch.set_num_threads(2)

MODES = ["none", "add", "concat"]


def standard_config(mode, T=64):
    """The tiny standard config, with channel conditioning of all three
    subnets in ``mode`` ("none", "add" or "concat")."""
    mcfg = tiny_model_config(signal_output_dim=T)
    if mode != "none":
        mcfg.channel_embed = ChannelEmbedConfig(
            is_embed=True, connection_type=mode, ch_num=8, is_sigma_encoder=True,
            is_sigma_decoder=True, is_signal_network=True, emb_dim_sigma_encoder=4,
            emb_dim_sigma_decoder=3, emb_dim_signal_network=5,
        )
    return mcfg


def standard_setup(mode, T=64, seed=0):
    """(JAX params, JAX static, port params, port static) for the tiny
    standard config, tables N(0,1)."""
    mcfg = standard_config(mode, T)
    jfst = jfield.build_field(mcfg, "Real_env")
    jparams = jax.device_get(jfield.init(jax.random.PRNGKey(seed), jfst))
    rng = np.random.default_rng(seed)
    for k, v in jparams["enc"].items():
        jparams["enc"][k] = rng.normal(size=v.shape).astype(np.float32)
    tfst = tfield.build_field(mcfg, "Real_env")
    return jparams, jfst, params_from_jax(jparams, device="cpu"), tfst


def check_vjp(jfn, tfn, jparams, tparams, seed=0, fwd_tol=5e-5, grad_tol=1e-4):
    """Outputs of jfn(params) and tfn(params) (tuples) within fwd_tol of
    scale, and the gradients of Σ out·cotangent (numpy cotangents) within
    grad_tol of scale for every leaf; a leaf the port leaves without a
    gradient must have a zero one in JAX."""
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jouts, vjp = jax.vjp(jfn, jp)
    rng = np.random.default_rng(seed)
    cots = tuple(rng.normal(size=o.shape).astype(np.float32) for o in jouts)
    (jgrads,) = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = jax.tree_util.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    touts = tfn(tparams)
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert tuple(t.shape) == tuple(j.shape)
        assert _rel(t.detach().numpy(), j) < fwd_tol
    torch.autograd.backward(list(touts), [torch.from_numpy(c) for c in cots])
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(leaves)
    for a, t in zip(jl, leaves):
        a = np.asarray(a)
        if t.grad is None:
            assert not a.any()
        else:
            assert _rel(t.grad.numpy(), a) < grad_tol
        t.grad = None
        t.requires_grad_(False)


@pytest.mark.parametrize("lead,ch_shape", [((2, 5, 3), (2, 1, 1)), ((7,), (7,))])
def test_mlp_injection_matches_jax(lead, ch_shape):
    kw = dict(n_input_dims=6, n_output_dims=5, n_neurons=16, n_hidden_layers=3, inject=True, ch_num=8)
    jst, tst = jmlp.MLPStatic(**kw), tmlp.MLPStatic(**kw)
    jparams = jax.device_get(jmlp.init(jax.random.PRNGKey(1), jst))
    own = tmlp.init(torch.Generator().manual_seed(0), tst, device="cpu")
    assert [tuple(e.shape) for e in own["emb"]] == [e.shape for e in jparams["emb"]] == [(8, 16)] * 3
    rng = np.random.default_rng(2)
    x = rng.normal(size=lead + (6,)).astype(np.float32)
    ch = rng.integers(0, 8, ch_shape).astype(np.int32)
    check_vjp(
        lambda p: (jmlp.apply(p, jst, jnp.asarray(x), ch_idx=jnp.asarray(ch)),),
        lambda p: (tmlp.apply(p, tst, torch.from_numpy(x), ch_idx=torch.from_numpy(ch)),),
        jparams, params_from_jax(jparams, device="cpu"),
    )


@pytest.mark.parametrize("mode", MODES)
def test_build_and_init_match_jax(mode):
    jparams, jfst, tparams, tfst = standard_setup(mode)
    assert tfst.variant == jfst.variant == "standard" and tfst.leaky_slope == jfst.leaky_slope == 0.01
    for f in ("enc_mode", "dec_mode", "sig_mode", "ch_num", "emb_dim_enc", "emb_dim_dec", "emb_dim_sig"):
        assert getattr(tfst, f) == getattr(jfst, f), f
    for net in ("sigma_encoder", "sigma_decoder", "signal"):
        assert getattr(tfst, net).layer_dims == getattr(jfst, net).layer_dims
        assert getattr(tfst, net).inject == getattr(jfst, net).inject
    own = tfield.init(torch.Generator().manual_seed(0), tfst, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == shapes
    # emb lists and the concat_emb dict survive the round trip, empty or not
    back = params_to_numpy(tparams)
    assert set(back["concat_emb"]) == set(jparams["concat_emb"])
    for net in ("sigma_encoder", "sigma_decoder", "signal"):
        assert len(back[net]["emb"]) == len(jparams[net]["emb"])
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert (mode == "concat") == bool(back["concat_emb"])
    assert (mode == "add") == bool(back["signal"]["emb"])


@pytest.mark.parametrize("mode", MODES)
def test_apply_matches_jax(mode):
    jparams, jfst, tparams, tfst = standard_setup(mode)
    rng = np.random.default_rng(3)
    shape = (2, 5, 4)
    pts, view, tx = (rng.uniform(-1, 1, shape + (3,)).astype(np.float32) for _ in range(3))
    ch = rng.integers(0, 8, shape).astype(np.int32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = torch.from_numpy
    check_vjp(
        lambda p: jfield.apply(p, jfst, j(pts), j(view), j(tx), ch_idx=j(ch)),
        lambda p: tfield.apply(p, tfst, t(pts), t(view), t(tx), ch_idx=t(ch)),
        jparams, tparams,
    )


@pytest.mark.parametrize("mode", MODES)
def test_factored_queries_match_jax(mode):
    """sigma_query, point_features, signal_context and
    signal_tail_from_features, with ch_idx as the renderer passes it."""
    jparams, jfst, tparams, tfst = standard_setup(mode)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (2, 6, 4, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tx = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    ch = np.asarray([3, 6], np.int32)
    feat = rng.normal(size=(2, 20, 3, 128)).astype(np.float32)
    (h_ray, h_batch), h_extra = context_pair(rng, 2, 20, 32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = torch.from_numpy
    cb = ch[:, None, None]
    check_vjp(
        lambda p: jfield.sigma_query(p, jfst, j(pts), ch_idx=j(cb)),
        lambda p: tfield.sigma_query(p, tfst, t(pts), ch_idx=t(cb)),
        jparams, tparams,
    )
    check_vjp(
        lambda p: jfield.point_features(p, jfst, j(pts), ch_idx=j(cb))[:2],
        lambda p: tfield.point_features(p, tfst, t(pts), ch_idx=t(cb))[:2],
        jparams, tparams,
    )
    assert tfield.point_features(tparams, tfst, t(pts), ch_idx=t(cb))[2] is None
    check_vjp(
        lambda p: jfield.signal_context(p, jfst, j(dirs), j(tx), ch_idx=j(ch)),
        lambda p: tfield.signal_context(p, tfst, t(dirs), t(tx), ch_idx=t(ch)),
        jparams, tparams,
    )
    check_vjp(
        lambda p: (jfield.signal_tail_from_features(p, jfst, j(feat), None, j(h_extra), ch_idx=j(cb)),),
        lambda p: (with_bias(tfield.signal_tail_from_features(p, tfst, t(feat), None, (t(h_ray), t(h_batch)),
                                                              ch_idx=t(cb))),),
        jparams, tparams,
    )


@pytest.mark.parametrize("variant", ["standard_add", "standard_concat", "complex"])
def test_signal_from_parts_matches_jax(variant):
    if variant == "complex":
        jparams, jfst, tparams, tfst = complex_setup("hybridc:2")
        D, ch = 256, None
    else:
        jparams, jfst, tparams, tfst = standard_setup(variant.split("_")[1])
        D, ch = 128, np.asarray([1, 7], np.int32)[:, None, None]
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 9, 3, D)).astype(np.float32)
    pts = rng.uniform(-1, 1, (2, 9, 3, 3)).astype(np.float32)
    (h_ray, h_batch), h_extra = context_pair(rng, 2, 9, 32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    check_vjp(
        lambda p: (jfield.signal_from_parts(p, jfst, j(feat), j(pts), j(h_extra), ch_idx=j(ch)),),
        lambda p: (with_bias(tfield.signal_from_parts(p, tfst, t(feat), t(pts), (t(h_ray), t(h_batch)),
                                                      ch_idx=t(ch))),),
        jparams, tparams,
    )

