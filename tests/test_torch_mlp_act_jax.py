"""The MLPs' hidden-layer chain in bf16 compute against the JAX package (CPU).

``mlp.apply``, ``mlp.apply_tail`` with ``add_first_bias`` and
``field.signal_tail_from_features`` with the (h_ray, h_batch) context run
the chain of ``ops.mlp_act`` (its hand-written backward: the GEMM
cotangents, the weight gradients and the bias, embedding and context sums)
in bf16 compute; here they are held against avr_tpu's functions in bf16
compute on the same inputs, for one trial and for K = 4 trials (``jax.vmap``
of the JAX function over stacked params and inputs), for MLPs with and
without channel injection and for the standard field with "add" embeddings
and the complex field.

Limits: the outputs within FWD_TOL and every gradient (params, inputs and
the context) within GRAD_TOL of its scale. Both sides round the same values
to bf16 and sum in fp32 in other orders, so they differ where a sum's
rounding tips a value across a bf16 rounding boundary. The worst readings
are given beside the limits; the control, the port in fp32 compute against
JAX in bf16, must break both limits in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.models import field as jfield
from avr_tpu.models import mlp as jmlp
from test_torch_field import _rel, complex_setup
from test_torch_field_standard import standard_setup

from avr_torch.models import field as tfield
from avr_torch.models import mlp as tmlp

torch.set_num_threads(2)

BF16 = jnp.bfloat16
# worst readings over these cases: forward 9.3e-8, gradients 2.0e-7; the
# control reads at least 3.3e-3 forward and 3.6e-2 in its worst gradient
FWD_TOL = 1e-6
GRAD_TOL = 1e-5


def _stack(tree, K):
    """K trials of a numpy tree: trial i scaled by 1 + 0.1·i."""
    return jax.tree_util.tree_map(lambda v: np.stack([v * np.float32(1 + 0.1 * i) for i in range(K)]), tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.tensor(np.array(v, np.float32), requires_grad=True), tree)


def errors(jfn, tfn, args, seed=0):
    """(forward error, {leaf: gradient error}) of tfn against jfn on the
    numpy tree ``args``, each relative to the JAX value's largest magnitude;
    the gradients of Σ out·cotangent, the cotangent N(0, 1)."""
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    jout, vjp = jax.vjp(jfn, jargs)
    cot = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(cot))
    targs = _torch(args)
    tout = tfn(targs)
    assert tuple(tout.shape) == tuple(jout.shape)
    leaves = jax.tree_util.tree_leaves(targs)
    tgrad = torch.autograd.grad(tout, leaves, torch.from_numpy(cot), allow_unused=True)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(args)[0]]
    grads = {}
    for path, t, j in zip(paths, tgrad, jax.tree_util.tree_leaves(jgrad)):
        j = np.asarray(j)
        grads[path] = float(np.abs(j).max() > 0) if t is None else _rel(t.numpy(), j)
    return _rel(tout.detach().numpy(), np.asarray(jout)), grads


def _vmapped(fn, K):
    return jax.vmap(fn) if K else fn


def _mlp_case(K, inject, seed=1):
    kw = dict(n_input_dims=12, n_output_dims=8, n_neurons=32, n_hidden_layers=3, inject=inject, ch_num=4)
    jst, tst = jmlp.MLPStatic(**kw), tmlp.MLPStatic(**kw)
    params = jax.device_get(jmlp.init(jax.random.PRNGKey(seed), jst))
    rng = np.random.default_rng(seed)
    params["b"] = [rng.normal(size=b.shape).astype(np.float32) for b in params["b"]]
    if inject:
        params["emb"] = [rng.normal(size=e.shape).astype(np.float32) for e in params["emb"]]
    return jst, tst, (_stack(params, K) if K else params), rng


@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("inject", [True, False])
def test_apply_bf16_matches_jax(K, inject):
    jst, tst, params, rng = _mlp_case(K, inject)
    x = rng.normal(size=((K,) if K else ()) + (2, 5, 3, 12)).astype(np.float32)
    ch = np.asarray([1, 3], np.int32)[:, None, None]
    jfn = lambda a: _vmapped(lambda p, x: jmlp.apply(p, jst, x, ch_idx=jnp.asarray(ch), compute_dtype=BF16), K)(
        a["params"], a["x"])  # noqa: E731

    def tfn(a, cd=torch.bfloat16):
        return tmlp.apply(a["params"], tst, a["x"], ch_idx=torch.from_numpy(ch), compute_dtype=cd)

    _check(jfn, tfn, {"params": params, "x": x})


@pytest.mark.parametrize("K", [0, 4])
def test_apply_tail_first_bias_bf16_matches_jax(K):
    """``add_first_bias`` (the complex sigma encoder's form): the port adds
    the first bias in the chain's first step, JAX before ``apply_tail``."""
    jst, tst, params, rng = _mlp_case(K, True, seed=2)
    h = rng.normal(size=((K,) if K else ()) + (2, 7, 32)).astype(np.float32)
    ch = np.asarray([0, 2], np.int32)[:, None]

    def jtail(p, h):
        return jmlp.apply_tail(p, jst, h + p["b"][0], ch_idx=jnp.asarray(ch), compute_dtype=BF16)

    jfn = lambda a: _vmapped(jtail, K)(a["params"], a["h"])  # noqa: E731

    def tfn(a, cd=torch.bfloat16):
        return tmlp.apply_tail(a["params"], tst, a["h"], ch_idx=torch.from_numpy(ch), compute_dtype=cd,
                               add_first_bias=True)

    _check(jfn, tfn, {"params": params, "h": h})


@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("variant", ["standard_add", "complex"])
def test_signal_tail_bf16_matches_jax(variant, K):
    """The signal network's factored first layer with the context pair: the
    port adds h_ray and h_batch in the chain's first step and sums their
    gradients there; JAX adds h_extra = h_ray + h_batch [bs, R, 1, W]."""
    if variant == "complex":
        jparams, jfst, _, tfst = complex_setup("hybridc:2")
        D, ch = 256, None
    else:
        jparams, jfst, _, tfst = standard_setup("add")
        D, ch = 128, np.asarray([3, 6], np.int32)[:, None, None]
    W = tfst.signal.n_neurons
    rng = np.random.default_rng(7)
    kk = (K,) if K else ()
    bs, R, C = 2, 9, 3
    args = {
        "params": _stack(jparams, K) if K else jparams,
        "feat": rng.normal(size=kk + (bs, R, C, D)).astype(np.float32),
        "h_ray": rng.normal(size=kk + (R, W)).astype(np.float32),
        "h_batch": rng.normal(size=kk + (bs, W)).astype(np.float32),
    }
    if variant == "complex":
        args["psig"] = rng.normal(size=kk + (bs, R, C, tfst.encodings["pos_sig"].n_output_dims)).astype(np.float32)
    jch = None if ch is None else jnp.asarray(ch)
    tch = None if ch is None else torch.from_numpy(ch)

    def jsig(p, feat, psig, h_ray, h_batch):
        h_extra = h_ray[None, :, None, :] + h_batch[:, None, None, :]
        return jfield.signal_tail_from_features(p, jfst, feat, psig, h_extra, ch_idx=jch, compute_dtype=BF16)

    jfn = lambda a: _vmapped(jsig, K)(a["params"], a["feat"], a.get("psig"), a["h_ray"], a["h_batch"])  # noqa: E731

    def tfn(a, cd=torch.bfloat16):
        out, bias = tfield.signal_tail_from_features(a["params"], tfst, a["feat"], a.get("psig"),
                                                     (a["h_ray"], a["h_batch"]), ch_idx=tch, compute_dtype=cd)
        return out if bias is None else out + tmlp.per_trial(bias, out)

    _check(jfn, tfn, args)


def _check(jfn, tfn, args):
    """The port in bf16 compute within the limits of JAX in bf16 compute;
    the port in fp32 compute breaks both."""
    fwd, grads = errors(jfn, tfn, args)
    assert fwd < FWD_TOL and max(grads.values()) < GRAD_TOL, (fwd, grads)
    c_fwd, c_grads = errors(jfn, lambda a: tfn(a, cd=None), args)
    assert c_fwd > FWD_TOL and max(c_grads.values()) > GRAD_TOL, (c_fwd, c_grads)
