"""Parity of avr_torch's STFT and criterion with the JAX package (CPU).
Every LossBundle field agrees to 1e-5: absolute for values below 1,
relative above (the energy term is a difference of log10 curves, so its
fp32 error is absolute). The one exception is das_reg: its soft-argmax
takes softmax(beta·power), so the ~1e-6 that two fp32 FFT libraries
differ by in the beamformer power reaches the angle multiplied by
beta = 100; it is held to 1e-5·beta, and the power itself to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu import losses as jlosses
from avr_tpu.ops import stft as jstft

from avr_torch import losses as tlosses
from avr_torch.ops import stft as tstft

torch.set_num_threads(2)


@pytest.mark.parametrize("T,n_fft,hop,win", [(1600, 512, 60, 300), (64, 256, None, None), (128, 64, 4, 30)])
def test_stft_matches_jax(T, n_fft, hop, win):
    x = np.random.default_rng(0).normal(size=(3, T)).astype(np.float32)
    w = None if win is None else jstft.hann_window(win)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win, w))
    tw = None if win is None else tstft.hann_window(win)
    got = tstft.stft(torch.from_numpy(x), n_fft, hop, win, tw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _spectra(bs, F, seed):
    rng = np.random.default_rng(seed)
    pred = (rng.normal(size=(bs, F, 2)) * 1e-2).astype(np.float32)
    ori = (rng.normal(size=(bs, F, 2)) * 1e-2).astype(np.float32)
    return pred, ori


@pytest.mark.parametrize(
    "bs,T,das",
    [(4, 1600, False), (4, 64, False), (8, 128, True), (16, 64, True)],
    ids=["flagship-T", "tiny-T", "das-one-group", "das-two-groups"],
)
def test_criterion_bundle_matches_jax(bs, T, das):
    pred, ori = _spectra(bs, T // 2 + 1, seed=bs + T)
    kw = dict(das_reg_loss_weight=0.7, das_ce_loss_weight=0.3) if das else {}
    jcfg = jlosses.CriterionConfig(fs=16000, speed=346.8, **kw)
    tcfg = tlosses.CriterionConfig(fs=16000, speed=346.8, **kw)
    jb, jo, jp = jlosses.criterion(jnp.asarray(pred), jnp.asarray(ori), jcfg)
    tb, to, tp = tlosses.criterion(torch.from_numpy(pred), torch.from_numpy(ori), tcfg)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-9)
    for name in jlosses.LossBundle._fields:
        a, b = float(getattr(tb, name)), float(getattr(jb, name))
        assert np.isfinite(a), name
        tol = 1e-5 * (tcfg.beta if name == "das_reg" else 1.0)
        assert abs(a - b) <= tol * max(abs(b), 1.0), (name, a, b)
    if das:
        assert float(tb.das_reg) > 0 and float(tb.das_ce) > 0
    tol = 1e-5 * (tcfg.beta if das else 1.0)
    assert abs(float(tb.total) - float(jb.total)) <= tol * max(abs(float(jb.total)), 1.0)


def test_beamforming_power_matches_jax():
    pred, _ = _spectra(8, 65, seed=7)
    c = pred[..., 0] + 1j * pred[..., 1]
    ref = np.asarray(jlosses.beamforming_power(jnp.asarray(c.astype(np.complex64)), 16000, 343.8))
    got = tlosses.beamforming_power(torch.from_numpy(c.astype(np.complex64)), 16000, 343.8).numpy()
    assert got.shape == (360,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_das_needs_whole_groups():
    pred, ori = _spectra(4, 33, seed=1)
    cfg = tlosses.CriterionConfig(das_ce_loss_weight=1.0)
    with pytest.raises(ValueError):
        tlosses.criterion(torch.from_numpy(pred), torch.from_numpy(ori), cfg)


ENERGY_ONLY = dict(spec_loss_weight=0.0, amplitude_loss_weight=0.0, angle_loss_weight=0.0,
                   time_loss_weight=0.0, multistft_loss_weight=0.0, energy_loss_weight=5.0)


@pytest.mark.parametrize("scale", [1e-2, 1.0])
def test_energy_gradient_matches_fp64(scale):
    """The energy-decay term alone, at its default weight: the port's fp32
    gradient and eager JAX's are each held to 1e-5 of scale against the
    port's float64 gradient. At the 1e-2 scale XLA's jitted fp32 gradient
    of this term departs from the float64 one by more than its scale, so
    the reference is eager JAX (jax.grad outside jit)."""
    import jax

    rng = np.random.default_rng(5)
    pred = (rng.normal(size=(2, 33, 2)) * scale).astype(np.float32)
    ori = (rng.normal(size=(2, 33, 2)) * scale).astype(np.float32)
    g_jax = np.asarray(jax.grad(
        lambda p: jlosses.criterion(p, jnp.asarray(ori), jlosses.CriterionConfig(**ENERGY_ONLY))[0].total
    )(jnp.asarray(pred)))
    grads = {}
    for dt in (torch.float32, torch.float64):
        tp = torch.from_numpy(pred).to(dt).requires_grad_(True)
        bundle = tlosses.criterion(tp, torch.from_numpy(ori).to(dt), tlosses.CriterionConfig(**ENERGY_ONLY))[0]
        assert float(bundle.energy.detach()) > 0
        bundle.total.backward()
        grads[dt] = tp.grad.double().numpy()
    g64 = grads[torch.float64]
    s = np.abs(g64).max()
    assert np.abs(grads[torch.float32] - g64).max() <= 1e-5 * s
    assert np.abs(g_jax - g64).max() <= 1e-5 * s


def test_criterion_gradient_matches_jax():
    import jax

    pred, ori = _spectra(4, 33, seed=2)
    cfg_j = jlosses.CriterionConfig()
    g_ref = jax.grad(lambda p: jlosses.criterion(p, jnp.asarray(ori), cfg_j)[0].total)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tlosses.criterion(tp, torch.from_numpy(ori), tlosses.CriterionConfig())[0].total.backward()
    g_ref = np.asarray(g_ref)
    assert np.abs(tp.grad.numpy() - g_ref).max() <= 1e-4 * np.abs(g_ref).max()
