"""Parity of avr_torch's train step with ``avr_tpu.train.state.make_train_step``
(CPU, fp32 compute). The JAX step's ray directions are handed to the port.

How params are compared: Adam's first steps move each entry by about
lr·sign(m), with m the moment of the (clipped, decayed) gradients, so an
entry whose JAX moment is within float noise of zero (|m| ≤ 1e-3 of its
leaf's largest |m|, ten times the 1e-4 gradient tolerance of the render
parity test) can move either way in either framework. Those entries are
only held to Adam's bound, |Δp| ≤ lr per step. Every other entry must
agree with JAX to k·lr·(2e-3 + 1e-3·max|m|/|m|) after k steps: a moment
error of 1e-4 of the leaf's scale (with a 10× margin) moves an entry's
update by that share of its own moment.

The jitted steps run the full criterion except the energy-decay term,
whose weight is set to 0 there: for the small signals of these steps
XLA's jitted fp32 gradient of that term departs from its float64
gradient by more than its own scale, while eager JAX and the port agree
with float64 (test_torch_losses.test_energy_gradient_matches_fp64). One
step with the default energy weight is therefore held against the JAX
step run under ``jax.disable_jit()``; the skip test also keeps the
default weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu import geometry as jgeo
from avr_tpu.config import TrainConfig
from avr_tpu.losses import CriterionConfig as JCrit
from avr_tpu.losses import criterion as jcriterion
from avr_tpu.render.common import make_consts as jmake_consts
from avr_tpu.train import state as jstate_lib
from conftest import tiny_render_config
from test_torch_field import complex_setup
from test_torch_field_standard import standard_setup

from avr_torch.convert import params_to_numpy
from avr_torch.losses import CriterionConfig as TCrit
from avr_torch.render.common import make_consts as tmake_consts
from avr_torch.train import state as tstate_lib

torch.set_num_threads(2)

LR = 1e-4


def _tc(**kw):
    base = dict(lr=LR, eta_min=LR / 4, T_max=3, compute_dtype="float32", shell_chunk=4,
                batch_size=2)
    base.update(kw)
    return TrainConfig(**base)


def _batch(rng, T, wave_scale=1e-2, group=False):
    """A complex-variant batch of 2 (with ``rot_tx``), or with ``group`` one
    8-microphone group (``ch_idx`` 0..7, int32 as the sampler gives it)."""
    bs = 8 if group else 2
    d = rng.normal(size=(bs, 3))
    batch = {
        "wave": (rng.normal(size=(bs, T // 2 + 1, 2)) * wave_scale).astype(np.float32),
        "pos_rx": rng.uniform(-2, 2, (bs, 3)).astype(np.float32),
        "pos_tx": rng.uniform(-2, 2, (bs, 3)).astype(np.float32),
    }
    if group:
        batch["ch_idx"] = np.arange(8, dtype=np.int32)
    else:
        batch["rot_tx"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return batch


def _run_both(tc, wave_scale=1e-2, n_steps=2, nan_wave=False, energy_weight=0.0, standard=None,
              **crit_extra):
    """Steps of both frameworks from the same params on the same batches:
    the complex variant, or with ``standard`` (a channel mode) the standard
    one on 8-microphone groups."""
    if standard is None:
        jparams, jfst, tparams, tfst = complex_setup("hybridc:2", T=64)
    else:
        jparams, jfst, tparams, tfst = standard_setup(standard, T=64)
    rc = tiny_render_config()
    crit_kw = dict(fs=rc.fs, speed=rc.speed, energy_loss_weight=energy_weight, **crit_extra)
    jstep, jrender = jstate_lib.make_train_step(jfst, jmake_consts(rc, 64), rc, tc, JCrit(**crit_kw))
    tstep, _ = tstate_lib.make_train_step(tfst, tmake_consts(rc, 64, device="cpu"), rc, tc, TCrit(**crit_kw))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js = jstate_lib.TrainState(jp, jstate_lib.make_optimizer(tc).init(jp), jnp.zeros((), jnp.int32))
    ts = tstate_lib.init_state(None, tfst, tc, device="cpu", params=tparams)
    rng = np.random.default_rng(11)
    out = []
    for i in range(n_steps):
        batch = _batch(rng, 64, wave_scale, group=standard is not None)
        if nan_wave:
            batch["wave"][0, 3, 0] = np.nan
        key = jax.random.PRNGKey(100 + i)
        dirs = np.array(jgeo.ray_directions(rc.n_azi, rc.n_ele, key=key))
        # the JAX gradient at the pre-step params, to tell noise from signal
        g = jax.jit(jax.grad(
            lambda p: jcriterion(jrender(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                         jnp.asarray(dirs)), jnp.asarray(batch["wave"]),
                                 JCrit(**crit_kw))[0].total
        ))(js.params)
        p_before = params_to_numpy(ts.params)
        js, jb = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        ts, tb = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(dirs))
        # the JAX step donates its state: keep host copies
        out.append((jax.device_get(g), p_before, jax.device_get(js), jax.device_get(jb), ts, tb))
    return out


def _check_bundle(jb, tb):
    for name in jb._fields:
        a, b = float(getattr(tb, name)), float(getattr(jb, name))
        assert np.isfinite(a) == np.isfinite(b), name
        if np.isfinite(b):
            assert abs(a - b) <= 1e-5 * max(abs(b), 1.0), (name, a, b)


def _check_params(steps, weight_decay=0.0):
    mom = None
    for k, (g, p_before, js, jb, ts, tb) in enumerate(steps, start=1):
        _check_bundle(jb, tb)
        jl = jax.tree_util.tree_leaves(js.params)
        tl = jax.tree_util.tree_leaves(params_to_numpy(ts.params))
        gl = jax.tree_util.tree_leaves(g)
        pl = jax.tree_util.tree_leaves(p_before)
        assert int(js.step) == int(ts.step) == k
        g_norm = np.sqrt(sum(np.sum(np.square(x.astype(np.float64))) for x in gl))
        clip = 1.0 if g_norm < 1.0 else 1.0 / g_norm
        u = [clip * gi + weight_decay * pb for gi, pb in zip(gl, pl)]
        mom = u if mom is None else [0.9 * m + 0.1 * x for m, x in zip(mom, u)]
        for a, b, m, pb in zip(jl, tl, mom, pl):
            assert np.all(np.abs(b - pb) <= LR * (1 + 1e-3) + 1e-7)  # Adam's bound
            m_abs, m_max = np.abs(m), np.abs(m).max()
            zero = m == 0  # rows no point touched: no update in either
            np.testing.assert_array_equal(b[zero], a[zero])
            sure = m_abs > 1e-3 * m_max
            tol = k * LR * (2e-3 + 1e-3 * m_max / m_abs[sure]) + 1e-7
            assert np.all(np.abs(b[sure] - a[sure]) <= tol)


def test_two_fp32_steps_match_jax():
    _check_params(_run_both(_tc()))


def test_clipped_and_decayed_steps_match_jax():
    """A target 300× larger makes the global gradient norm exceed 1."""
    steps = _run_both(_tc(weight_decay=1e-2), wave_scale=3.0)
    g_norm = np.sqrt(sum(np.sum(np.square(x)) for x in jax.tree_util.tree_leaves(steps[0][0])))
    assert g_norm > 1.0
    _check_params(steps, weight_decay=1e-2)


def test_step_with_default_energy_weight_matches_eager_jax():
    with jax.disable_jit():
        steps = _run_both(_tc(), n_steps=1, energy_weight=TCrit().energy_loss_weight)
    assert TCrit().energy_loss_weight == JCrit().energy_loss_weight > 0
    assert float(steps[0][3].energy) > 0
    _check_params(steps)


def test_nan_energy_skips_the_update():
    steps = _run_both(_tc(), n_steps=1, nan_wave=True, energy_weight=5.0)
    g, p_before, js, jb, ts, tb = steps[0]
    assert not np.isfinite(float(jb.energy)) and not np.isfinite(float(tb.energy))
    assert int(js.step) == int(ts.step) == 0
    for a, b in zip(jax.tree_util.tree_leaves(p_before),
                    jax.tree_util.tree_leaves(params_to_numpy(ts.params))):
        np.testing.assert_array_equal(a, b)
    for t in list(tstate_lib.named_leaves(ts.opt_state.mu)) + list(tstate_lib.named_leaves(ts.opt_state.nu)):
        assert float(t[1].abs().max()) == 0.0


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7])
def test_cosine_schedule_matches_optax(step):
    tc = _tc()
    ref = float(jstate_lib.make_schedule(tc)(step))
    got = float(tstate_lib.cosine_lr(tc, torch.tensor(step)))
    assert abs(got - ref) <= 1e-6 * ref


def test_step_draws_directions_from_a_generator():
    _, _, tparams, tfst = complex_setup("hybridc:2", T=64)
    rc = tiny_render_config()
    tc = _tc(compute_dtype="bfloat16")
    tstep, _ = tstate_lib.make_train_step(tfst, tmake_consts(rc, 64, device="cpu"), rc, tc,
                                          TCrit(fs=rc.fs, speed=rc.speed))
    ts = tstate_lib.init_state(torch.Generator().manual_seed(0), tfst, tc, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(0), 64).items()}
    gen = torch.Generator().manual_seed(1)
    before = params_to_numpy(ts.params)
    for _ in range(2):
        ts, tb = tstep(ts, batch, gen)
        assert all(np.isfinite(float(v)) for v in tb)
    assert int(ts.step) == 2
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(params_to_numpy(ts.params)))]
    assert all(moved)
