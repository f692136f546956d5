"""The port's white-noise DoA evaluation (``avr_torch/eval/whitenoise.py``)
against ``avr_tpu/eval/whitenoise.py`` on tests/test_eval_pipelines.py's
inputs: equal DataFrames, arrays within 1e-6, and the same files with the
same contents (the condition pickles, the ranked CSV)."""

import os
import pickle
import warnings

import numpy as np
import pandas as pd
import pytest
import yaml

from avr_tpu.eval import whitenoise as jwn
from test_doa import _fake_npz, make_group_signals

from avr_torch.eval import whitenoise as twn


def _run_both(tmp_path, **kw):
    """Both pipelines on the same config, each into its own outdir; returns
    the two DataFrames, the warnings each raised, and the outdirs."""
    out = {}
    for name, mod in (("jax", jwn), ("torch", twn)):
        cfg = mod.WhitenoiseConfig(outdir=str(tmp_path / name), **kw)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            df = mod.run_whitenoise_eval(cfg)
        out[name] = (df, sorted(str(x.message) for x in w), cfg.outdir)
    return out


def _assert_same_outdirs(a, b):
    files = sorted(os.listdir(a))
    assert files and files == sorted(os.listdir(b))
    for f in files:
        if f.endswith(".pkl"):
            with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
                np.testing.assert_equal(pickle.load(fa), pickle.load(fb), err_msg=f)
        else:
            assert open(os.path.join(a, f), "rb").read() == open(os.path.join(b, f), "rb").read(), f


CASES = {
    "long": dict(seeds=[0], long_noise_seconds=2.0, stft_grid=[{"nfft": 256, "hop": 128, "win": "hann"}],
                 T_use_list=[8, 16]),
    "capped": dict(seeds=[0], long_noise_seconds=2.0, stft_grid=[{"nfft": 256, "hop": 128, "win": "hann"}],
                   T_use_list=[8], max_windows=2),
    "bandpass": dict(seeds=[0], long_noise_seconds=2.0, stft_grid=[{"nfft": 256, "hop": 128, "win": "none"}],
                     T_use_list=[16], bands_hz=[(500.0, 3000.0)]),
    "overlap": dict(seeds=[0], long_noise_seconds=1.0, stft_grid=[{"nfft": 256, "hop": 128, "win": "hann"}],
                    T_use_list=[16], slide_hop_frames=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_whitenoise_pipeline_matches_jax(tmp_path, case):
    npz = _fake_npz(tmp_path, [45.0, 135.0] if case == "long" else [250.0])
    out = _run_both(tmp_path, npz=npz, fs=16000, **CASES[case])
    (jdf, jw, jdir), (tdf, tw, tdir) = out["jax"], out["torch"]
    pd.testing.assert_frame_equal(tdf, jdf)
    assert tw == jw
    _assert_same_outdirs(jdir, tdir)


def test_whitenoise_reference_schema_matches_jax(tmp_path):
    """The reference bandpass YAML (bands / noise_seconds / segments_ms /
    overlap_factors) loads to the same config and runs the same segmented
    sweep."""
    npz = _fake_npz(tmp_path, [250.0])
    raw = {
        "npz": npz, "fs": 16000, "seeds": [0], "which": "pred",
        "bands": [{"name": "bp_0p5_3k", "low": 500, "high": 3000}],
        "noise_seconds": [1.0, 2.0], "segments_ms": [100.0], "overlap_factors": [0.5],
        "stft_grid": [{"nfft": 256, "hop": 128, "win": "hann"}],
    }
    dfs = {}
    for name, mod in (("jax", jwn), ("torch", twn)):
        path = tmp_path / f"{name}.yml"
        path.write_text(yaml.safe_dump({**raw, "outdir": str(tmp_path / name)}))
        cfg = mod.WhitenoiseConfig.from_yaml(str(path))
        dfs[name] = (cfg, mod.run_whitenoise_eval(cfg))
    (jcfg, jdf), (tcfg, tdf) = dfs["jax"], dfs["torch"]
    assert {**vars(tcfg), "outdir": None} == {**vars(jcfg), "outdir": None}
    pd.testing.assert_frame_equal(tdf, jdf)
    _assert_same_outdirs(str(tmp_path / "jax"), str(tmp_path / "torch"))


@pytest.mark.parametrize("angles", [[350.0, 10.0], [90.0, 90.0, 90.0], [0.0, 90.0, 180.0, 270.0], []])
def test_circular_statistics_match_jax(angles):
    assert twn.circ_mean_deg(angles) == pytest.approx(jwn.circ_mean_deg(angles), nan_ok=True)
    assert twn.circ_stats_deg(angles) == pytest.approx(jwn.circ_stats_deg(angles), nan_ok=True)
    for a, b in ((10.0, 350.0), (200.0, 20.0), (-5.0, 725.0)):
        assert twn.angular_error_deg(a, b) == jwn.angular_error_deg(a, b)
    assert twn.seg_hop_samples(16000, 100.0, 0.5) == jwn.seg_hop_samples(16000, 100.0, 0.5)


@pytest.mark.parametrize("win", ["hann", "none"])
def test_synthesis_stft_and_sliding_doa_match_jax(win):
    sig, mic_xy = make_group_signals(75.0, T=1600, seed=5, snr_noise=0.01)
    yj = jwn.convolve_noise_with_group(sig, 0.5, 16000, seed=3)
    yt = twn.convolve_noise_with_group(sig, 0.5, 16000, seed=3)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(twn.apply_bandpass(yt, 500.0, 3000.0, 16000),
                               jwn.apply_bandpass(yj, 500.0, 3000.0, 16000), rtol=0, atol=1e-6)
    Xj, Xt = jwn.stft_condition(yj, 256, 128, win), twn.stft_condition(yt, 256, 128, win)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-6 * np.abs(Xj).max())
    got = twn.sliding_window_doa(Xj, mic_xy, 16000, 256, 16, slide_hop_frames=4, max_windows=5)
    assert got == jwn.sliding_window_doa(Xj, mic_xy, 16000, 256, 16, slide_hop_frames=4, max_windows=5)
