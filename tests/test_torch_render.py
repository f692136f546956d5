"""Parity of avr_torch's geometry, render constants and fused renderer
with the JAX package (CPU). Ray directions are passed to both renderers.
Tolerances are those of tests/test_render.py: fp32 forward 5e-5 of
scale, gradients 1e-4 of scale; bf16 compute 3e-2 of scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu import geometry as jgeo
from avr_tpu.render import common as jcommon
from avr_tpu.render import fused as jfused
from conftest import tiny_render_config
from test_torch_field import complex_setup

from avr_torch import geometry as tgeo
from avr_torch.render import common as tcommon
from avr_torch.render import fused as tfused

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


@pytest.mark.parametrize("T,fs,n_samples", [(64, 2000, 8), (1600, 16000, 32), (127, 24000, 5)])
def test_make_consts_equal(T, fs, n_samples):
    rc = tiny_render_config(n_samples=n_samples, fs=fs)
    j = jcommon.make_consts(rc, T)
    t = tcommon.make_consts(rc, T, device="cpu")
    for name in j._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)


def test_compositing_weights_and_head_mask():
    rng = np.random.default_rng(0)
    attn = np.abs(rng.normal(size=(3, 7, 9))).astype(np.float32)
    d_vals = np.linspace(0, 3, 9).astype(np.float32)
    ref = np.asarray(jcommon.compositing_weights(jnp.asarray(attn), jnp.asarray(d_vals)))
    got = tcommon.compositing_weights(torch.from_numpy(attn), torch.from_numpy(d_vals)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    # distances on exact half-sample boundaries: half-to-even rounding
    dist = np.asarray([0.0, 0.5, 1.5, 2.5, 3.49, 343.8, 7.3], np.float32) * np.float32(343.8 / 1000.0)
    mref = np.asarray(jcommon.head_delay_mask(jnp.asarray(dist), 1000.0, 343.8, 8))
    mgot = tcommon.head_delay_mask(torch.from_numpy(dist), 1000.0, 343.8, 8).numpy()
    np.testing.assert_array_equal(mgot, mref)


def test_sample_distances_ray_points_and_normalize_match_jax():
    """The same float32 elementwise arithmetic in the same order: 1e-6."""
    rng = np.random.default_rng(5)
    ref = np.asarray(jgeo.sample_distances(0.5, 6.0, 9))
    got = tgeo.sample_distances(0.5, 6.0, 9, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    rays_o = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    dirs = rng.normal(size=(5, 3)).astype(np.float32)
    jp = np.array(jgeo.ray_points(jnp.asarray(rays_o), jnp.asarray(dirs), jnp.asarray(ref)))
    tp = tgeo.ray_points(torch.from_numpy(rays_o), torch.from_numpy(dirs), torch.from_numpy(got))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-5)
    lo, hi = np.full(3, -12.0, np.float32), np.full(3, 12.0, np.float32)
    jn = np.asarray(jgeo.normalize_points(jnp.asarray(jp), jnp.asarray(lo), jnp.asarray(hi)))
    tn = tgeo.normalize_points(torch.from_numpy(jp), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6, atol=1e-6)


def test_ray_directions_grid_and_random_offset():
    ref = np.asarray(jgeo.ray_directions(6, 3))
    got = tgeo.ray_directions(6, 3, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    r = tgeo.ray_directions(6, 3, generator=g, device="cpu")
    np.testing.assert_allclose(torch.linalg.norm(r, dim=-1).numpy(), 1.0, atol=1e-6)
    assert not np.allclose(r.numpy()[:-2], got[:-2])  # azimuths were offset
    np.testing.assert_array_equal(r.numpy()[-2:], got[-2:])  # poles stay


def _scene(T=64):
    rng = np.random.default_rng(5)
    rc = tiny_render_config()
    bs = 2
    rays_o = rng.uniform(-2, 2, (bs, 3)).astype(np.float32)
    tx = rng.uniform(-2, 2, (bs, 3)).astype(np.float32)
    d = rng.normal(size=(bs, 3))
    tx_view = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dirs = np.array(jgeo.ray_directions(rc.n_azi, rc.n_ele, key=jax.random.PRNGKey(3)))
    target = rng.normal(size=(bs, T // 2 + 1, 2)).astype(np.float32)
    return rc, rays_o, tx, tx_view, dirs, target


@pytest.mark.parametrize("interp,shell_chunk", [("trilinear", 4), ("hybridc:2", 2), ("hybridc:2", 8)])
def test_render_fused_fp32_forward_and_grads_match_jax(interp, shell_chunk):
    jparams, jfst, tparams, tfst = complex_setup(interp)
    rc, rays_o, tx, tx_view, dirs, target = _scene()
    jc = jcommon.make_consts(rc, 64)
    tc = tcommon.make_consts(rc, 64, device="cpu")
    ray_w = np.linspace(0.5, 1.0, dirs.shape[0]).astype(np.float32)

    def jloss(p):
        out = jfused.render_fused(
            p, jfst, jc, rc, jnp.asarray(rays_o), jnp.asarray(tx), direction_tx=jnp.asarray(tx_view),
            dirs=jnp.asarray(dirs), compute_dtype=None, shell_chunk=shell_chunk,
            ray_weights=jnp.asarray(ray_w),
        )
        return jnp.mean((out - target) ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams)
    )
    leaves = jax.tree_util.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tout = tfused.render_fused(
        tparams, tfst, tc, rc, torch.from_numpy(rays_o), torch.from_numpy(tx),
        direction_tx=torch.from_numpy(tx_view), dirs=torch.from_numpy(dirs),
        compute_dtype=None, shell_chunk=shell_chunk, ray_weights=torch.from_numpy(ray_w),
    )
    torch.mean((tout - torch.from_numpy(target)) ** 2).backward()
    assert tout.shape == jout.shape == (2, 33, 2)
    assert _rel(tout.detach().numpy(), jout) < 5e-5
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(leaves)
    for a, t in zip(jl, leaves):
        assert t.grad is not None
        assert _rel(t.grad.numpy(), a) < 1e-4


def test_render_fused_bf16_matches_jax_loosely():
    jparams, jfst, tparams, tfst = complex_setup("hybridc:2")
    rc, rays_o, tx, tx_view, dirs, _ = _scene()
    jout = jfused.render_fused(
        jax.tree_util.tree_map(jnp.asarray, jparams), jfst, jcommon.make_consts(rc, 64), rc,
        jnp.asarray(rays_o), jnp.asarray(tx), direction_tx=jnp.asarray(tx_view),
        dirs=jnp.asarray(dirs), shell_chunk=4, compute_dtype=jnp.bfloat16,
    )
    with torch.no_grad():
        tout = tfused.render_fused(
            tparams, tfst, tcommon.make_consts(rc, 64, device="cpu"), rc,
            torch.from_numpy(rays_o), torch.from_numpy(tx), direction_tx=torch.from_numpy(tx_view),
            dirs=torch.from_numpy(dirs), shell_chunk=4, compute_dtype=torch.bfloat16,
        )
    assert np.isfinite(tout.numpy()).all()
    assert _rel(tout.numpy(), jout) < 3e-2
