"""Parity of avr_torch's MLP and complex field with the JAX package (CPU);
the standard variant is in test_torch_field_standard.py.

Params come from the JAX ``init`` with the hash tables refilled with
N(0,1) numpy values, and reach the port through ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.models import field as jfield
from avr_tpu.models import mlp as jmlp
from conftest import tiny_model_config

from avr_torch.convert import params_from_jax, params_to_numpy
from avr_torch.models import field as tfield
from avr_torch.models import mlp as tmlp

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def context_pair(rng, bs, R, W):
    """A signal context (h_ray [R, W], h_batch [bs, W]) as numpy N(0, 1), and
    the JAX package's h_extra [bs, R, 1, W] = h_ray + h_batch built from it."""
    h_ray = rng.normal(size=(R, W)).astype(np.float32)
    h_batch = rng.normal(size=(bs, W)).astype(np.float32)
    return (h_ray, h_batch), h_ray[None, :, None, :] + h_batch[:, None, None, :]


def with_bias(pair):
    """The signal of the port's signal functions' (output before the output
    layer's bias, bias or None), the bias added as the JAX network adds it."""
    out, bias = pair
    return out if bias is None else out + tmlp.per_trial(bias, out)


def complex_setup(interp="trilinear", T=64, seed=0):
    """(JAX params, JAX static, port params, port static) for the tiny
    complex config, tables N(0,1)."""
    mcfg = tiny_model_config(signal_output_dim=T, complex_variant=True)
    for name in ("pos_encoding_sigma", "tx_pos_encoding_sigma", "pos_encoding_sig",
                 "tx_pos_encoding_sig", "dir_encoding_sig", "tx_dir_encoding_sig"):
        getattr(mcfg, name).interpolation = interp
    jfst = jfield.build_field(mcfg, "RAF")
    jparams = jax.device_get(jfield.init(jax.random.PRNGKey(seed), jfst))
    rng = np.random.default_rng(seed)
    for k, v in jparams["enc"].items():
        jparams["enc"][k] = rng.normal(size=v.shape).astype(np.float32)
    tfst = tfield.build_field(mcfg, "RAF")
    return jparams, jfst, params_from_jax(jparams, device="cpu"), tfst


def test_params_round_trip_and_names():
    jparams, _, tparams, tfst = complex_setup()
    back = params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree with the same shapes
    own = tfield.init(torch.Generator().manual_seed(0), tfst, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == shapes
    assert "pos_pair" in own["enc"] and "pos" not in own["enc"]


@pytest.mark.parametrize("dataset_type", ["RAF", "MeshRIR"])
def test_sigma_feat_dim_and_first_layer_weight_match_jax(dataset_type):
    mcfg = tiny_model_config(signal_output_dim=64, complex_variant=dataset_type == "RAF")
    jfst, tfst = jfield.build_field(mcfg, dataset_type), tfield.build_field(mcfg, dataset_type)
    assert tfst.sigma_feat_dim == jfst.sigma_feat_dim == (256 if dataset_type == "RAF" else 128)
    jparams = jax.device_get(jfield.init(jax.random.PRNGKey(0), jfst))
    tparams = params_from_jax(jparams, device="cpu")
    for net in ("sigma_encoder", "sigma_decoder", "signal"):
        got = tmlp.first_layer_weight(tparams[net])
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmlp.first_layer_weight(jparams[net])))
        assert got.shape[0] == getattr(tfst, net).n_input_dims


@pytest.mark.parametrize("shape", [(6, 5, 24), (40, 24)])
def test_matmul_cd_bf16_forward_and_backward(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32)
    g = rng.normal(size=shape[:-1] + (16,)).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b: jmlp._matmul(a, b, jnp.bfloat16), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tout = tmlp._matmul(tx, tw, torch.bfloat16)
    tout.backward(torch.from_numpy(g))
    assert tout.dtype == torch.float32 and tx.grad.dtype == torch.float32
    # same bf16 operands (cotangent included), fp32 sums in another order
    assert _rel(tout.detach().numpy(), jout) < 1e-3
    assert _rel(tx.grad.numpy(), jdx) < 1e-3
    assert _rel(tw.grad.numpy(), jdw) < 1e-3


@pytest.mark.parametrize("name", ["relu", "leakyrelu", "gelu", "sigmoid", "tanh", "exp", "squareplus", "none"])
def test_activations_match_jax(name):
    x = np.linspace(-3, 3, 31).astype(np.float32)
    ref = np.asarray(jmlp._activation(name)(jnp.asarray(x)))
    got = tmlp._activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("interp", ["trilinear", "hybridc:2"])
def test_point_features_match_jax(interp):
    jparams, jfst, tparams, tfst = complex_setup(interp)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (2, 6, 4, 3)).astype(np.float32)
    tx = rng.uniform(-1, 1, (2, 1, 1, 3)).astype(np.float32)
    jf, ja, jp = jfield.point_features(
        jax.tree_util.tree_map(jnp.asarray, jparams), jfst, jnp.asarray(pts), tx=jnp.asarray(tx)
    )
    tf_, ta, tp = tfield.point_features(tparams, tfst, torch.from_numpy(pts), tx=torch.from_numpy(tx))
    assert tf_.shape == jf.shape and ta.shape == ja.shape and tp.shape == jp.shape
    for got, ref in ((tf_, jf), (ta, ja), (tp, jp)):
        assert _rel(got.detach().numpy(), ref) < 1e-5


def test_signal_context_and_tail_match_jax():
    jparams, jfst, tparams, tfst = complex_setup("hybridc:2")
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(20, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tx = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    tv = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    jr, jb = jfield.signal_context(jp, jfst, jnp.asarray(dirs), jnp.asarray(tx), tx_view=jnp.asarray(tv))
    tr, tb = tfield.signal_context(
        tparams, tfst, torch.from_numpy(dirs), torch.from_numpy(tx), tx_view=torch.from_numpy(tv)
    )
    assert _rel(tr.detach().numpy(), jr) < 1e-5
    assert _rel(tb.detach().numpy(), jb) < 1e-5

    feat = rng.normal(size=(2, 20, 3, 256)).astype(np.float32)
    psig = rng.normal(size=(2, 20, 3, tfst.encodings["pos_sig"].n_output_dims)).astype(np.float32)
    h_extra = np.asarray(jr)[None, :, None, :] + np.asarray(jb)[:, None, None, :]
    js = jfield.signal_tail_from_features(jp, jfst, jnp.asarray(feat), jnp.asarray(psig), jnp.asarray(h_extra))
    context = (torch.from_numpy(np.array(jr)), torch.from_numpy(np.array(jb)))
    ts = with_bias(tfield.signal_tail_from_features(
        tparams, tfst, torch.from_numpy(feat), torch.from_numpy(psig), context
    ))
    assert ts.shape == js.shape
    assert _rel(ts.detach().numpy(), js) < 1e-5


def test_sigma_query_attenuation_uses_config_slope():
    jparams, jfst, tparams, tfst = complex_setup()
    assert tfst.leaky_slope == jfst.leaky_slope == 0.03
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (3, 5, 3)).astype(np.float32)
    tx = rng.uniform(-1, 1, (3, 1, 3)).astype(np.float32)
    jf, ja = jfield.sigma_query(
        jax.tree_util.tree_map(jnp.asarray, jparams), jfst, jnp.asarray(pts), tx=jnp.asarray(tx)
    )
    tf_, ta = tfield.sigma_query(tparams, tfst, torch.from_numpy(pts), torch.from_numpy(tx))
    assert float(ta.min()) >= 0.0
    assert _rel(tf_.detach().numpy(), jf) < 1e-5
    assert _rel(ta.detach().numpy(), ja) < 1e-5
