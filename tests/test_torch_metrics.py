"""avr_torch's validation metrics against the JAX package's
(``avr_tpu/metrics.py``): the numpy fields are the same code and must agree
to 1e-12 relative; ``multi_stft`` runs each framework's fp32 STFT loss and
must agree to 1e-5."""

import numpy as np
import pytest

from avr_tpu import losses as jlosses
from avr_tpu import metrics as jmetrics

from avr_torch import losses as tlosses
from avr_torch import metrics as tmetrics

FS, T, N_PAIRS = 16000, 1600, 6


def _ir(rng, decay):
    t = np.arange(T) / FS
    return (rng.normal(size=T) * np.exp(-t / decay)).astype(np.float32)


def _pairs():
    """6 (ori, pred) IR pairs from a numpy seed, and the identical-IR case."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(N_PAIRS):
        ori = _ir(rng, rng.uniform(0.01, 0.05))
        pred = ori + 0.3 * _ir(rng, rng.uniform(0.01, 0.05))
        out.append((ori, pred))
    ori = _ir(rng, 0.02)
    out.append((ori, ori.copy()))
    return out


PAIRS = _pairs()
IDS = [f"pair{i}" for i in range(N_PAIRS)] + ["identical"]


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    assert np.all(np.abs(a[ok] - b[ok]) <= rtol * np.maximum(np.abs(b[ok]), 1e-30)), (a, b)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_metric_cal_matches_jax(pair):
    ori, pred = pair
    j = jmetrics.metric_cal(ori[None], pred[None], fs=FS)
    t = tmetrics.metric_cal(ori[None], pred[None], fs=FS)
    assert t._fields == j._fields
    for name in j._fields:
        if name == "multi_stft":
            assert abs(t.multi_stft - j.multi_stft) <= 1e-5 * max(abs(j.multi_stft), 1e-6), name
        else:
            _close(getattr(t, name), getattr(j, name), 1e-12)
    if np.array_equal(ori, pred):
        assert t.angle_error == t.amp_error == t.env_error == t.c50_error == t.edt_error == 0.0
        assert t.t60_error == 0.0 and t.multi_stft == 0.0


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_energy_curves_and_t60_edt_match_jax(pair):
    irs = np.stack(pair).astype(np.float64)
    je, te = jmetrics.backward_energy_db(irs), tmetrics.backward_energy_db(irs)
    _close(te, je, 1e-12)
    for a, b in zip(tmetrics.t60_edt(te, fs=FS), jmetrics.t60_edt(je, fs=FS)):
        _close(a, b, 1e-12)


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 257))
    _close(tmetrics._hilbert_envelope(x), jmetrics._hilbert_envelope(x), 1e-12)
    for w in (32, 7):
        _close(tmetrics._box_smooth(x, w), jmetrics._box_smooth(x, w), 1e-12)


def test_mrstft_metric_config_matches_jax():
    a, b = tlosses.MRSTFT_METRIC, jlosses.MRSTFT_METRIC
    for f in ("fft_sizes", "win_lengths", "hop_sizes", "w_sc", "w_log_mag", "w_lin_mag", "eps"):
        assert getattr(a, f) == getattr(b, f), f
