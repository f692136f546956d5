"""avr_torch's evaluation against the JAX package's: the DoA estimators
(a numpy copy: bit-equal), the rotation sweep on one numpy render
function (equal results and files), and ``make_render_fn`` over a port
runner holding the JAX runner's params (5e-5 of scale, JAX's directions)."""

import os

import jax
import numpy as np
import pytest
import torch

from avr_tpu import geometry as jgeo
from avr_tpu.config import AVRConfig as JAVRConfig
from avr_tpu.config import ChannelEmbedConfig, PathConfig, TrainConfig
from avr_tpu.eval import doa as jdoa
from avr_tpu.eval import rotate as jrotate
from avr_tpu.train.runner import AVRRunner as JRunner
from conftest import tiny_model_config, tiny_render_config
from test_torch_data import _assert_same_file, _files
from test_torch_runner import port_cfg

from avr_torch.convert import state_from_jax
from avr_torch.data import load_dataset, synthetic
from avr_torch.eval import doa as tdoa
from avr_torch.eval import rotate as trotate
from avr_torch.train.runner import AVRRunner

torch.set_num_threads(2)

ROOM = synthetic.RoomSpec(size=(4.0, 3.0, 2.5), max_order=2, fs=16000, seq_len=512)


@pytest.fixture(scope="module")
def array_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("array"))
    synthetic.write_real_env_dataset(d, ROOM, n_groups=5, seed=4)
    return d


@pytest.mark.parametrize("algo", jdoa.ALGO_NAMES)
def test_doa_spectrum_matches_jax(array_dir, algo):
    """Each estimator on the first 8-mic group's IRs with seeded noise."""
    data = load_dataset(array_dir, "Real_env", seq_len=ROOM.seq_len)
    rng = np.random.default_rng(0)
    sig = np.fft.irfft(data.wave[:8], axis=-1) + 1e-3 * rng.normal(size=(8, ROOM.seq_len))
    center = data.pos_rx[:8, :2].mean(axis=0)
    mic_xy = tdoa.circular_2d_array(center, 8, 0.0365)
    np.testing.assert_array_equal(mic_xy, jdoa.circular_2d_array(center, 8, 0.0365))
    X = tdoa.stft_frames(sig, 256)
    np.testing.assert_array_equal(X, jdoa.stft_frames(sig, 256))
    t = tdoa.doa_spectrum(X, mic_xy, ROOM.fs, 256, algo)
    j = jdoa.doa_spectrum(X, mic_xy, ROOM.fs, 256, algo)
    np.testing.assert_array_equal(t, j)
    assert tdoa.estimate_azimuth_deg(t) == jdoa.estimate_azimuth_deg(j)


def _render_fn(pos_rx, pos_tx, ch_idx=None):
    """Spectra of the shoebox room's image-source IRs: a numpy stand-in for
    a trained field."""
    return np.stack([
        np.fft.rfft(synthetic.simulate_ir(ROOM, rx.astype(np.float64), tx.astype(np.float64)))
        for rx, tx in zip(pos_rx, pos_tx)
    ]).astype(np.complex64)


def test_rotate_group_eval_matches_jax(array_dir, tmp_path):
    data = load_dataset(array_dir, "Real_env", eval=False, seq_len=ROOM.seq_len)
    args = (data, [0.0] * 3, list(ROOM.size), ROOM.fs, ROOM.seq_len)
    j = jrotate.rotate_group_eval(_render_fn, *args, deg_step=90.0, out_dir=str(tmp_path / "jax"))
    t = trotate.rotate_group_eval(_render_fn, *args, deg_step=90.0, out_dir=str(tmp_path / "torch"))
    assert sorted(t) == sorted(j) and len(t["pred_deg"]) > 0
    for k in j:
        assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "torch") == ["overall.txt", "summary.csv", "val_rotate_pred.npz"]
    for f in files:
        _assert_same_file(os.path.join(tmp_path, "jax", f), os.path.join(tmp_path, "torch", f))


def test_make_render_fn_matches_jax(array_dir, tmp_path):
    """The JAX runner's params (tables refilled N(0,1), so that relative
    tolerances mean something) in a port runner, channel embeddings added
    to the sigma encoder and the signal network, on one 8-mic group."""
    rc = tiny_render_config(n_samples=4, n_azi=4, n_ele=2, fs=ROOM.fs)
    rc.far = 6.0
    rc.xyz_min, rc.xyz_max = [0.0] * 3, [4.0] * 3
    model = tiny_model_config(signal_output_dim=ROOM.seq_len)
    model.channel_embed = ChannelEmbedConfig(
        is_embed=True, connection_type="add", ch_num=8, is_sigma_encoder=True, is_signal_network=True,
    )
    jcfg = JAVRConfig(
        path=PathConfig(expname="mr", dataset_type="Real_env", logdir=str(tmp_path / "jax")),
        render=rc, train=TrainConfig(batch_size=8, compute_dtype="float32"), model=model,
    )
    cfg = port_cfg(jcfg, str(tmp_path / "torch"))
    jr = JRunner(jcfg, array_dir)
    params = jax.device_get(jr.state.params)
    rng = np.random.default_rng(5)
    for k, v in params["enc"].items():
        params["enc"][k] = rng.normal(size=v.shape).astype(np.float32)
    jr.state = jr.state._replace(params=jax.device_put(params))
    tr = AVRRunner(cfg, array_dir, device="cpu")
    tr.state = state_from_jax(jax.device_get(jr.state), device="cpu")

    dirs = np.array(jgeo.ray_directions(cfg.render.n_azi, cfg.render.n_ele, key=jax.random.PRNGKey(1234)))
    d = tr.test_data
    rows = (d.pos_rx[:8], d.pos_tx[:8], d.ch_idx[:8])
    ref = jrotate.make_render_fn(jr)(*rows)
    got = trotate.make_render_fn(tr, dirs=dirs)(*rows)
    assert got.dtype == ref.dtype == np.complex64 and got.shape == ref.shape == (8, ROOM.seq_len // 2 + 1)
    assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()
    # the eval directions by default are fixed: two calls agree exactly
    np.testing.assert_array_equal(trotate.make_render_fn(tr)(*rows), trotate.make_render_fn(tr)(*rows))
