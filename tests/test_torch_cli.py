"""``python -m avr_torch``: tests/test_cli.py's tests for the commands the
port has (train, render, synth, tools, doa, das, rotate), on the CPU
(``--device cpu``), with the outputs of synth, doa and das held equal to
the JAX package's CLI on the same arguments."""

import json
import os

import numpy as np
import pytest
import torch

from avr_tpu.__main__ import main as jmain
from avr_tpu.config import AVRConfig as JAVRConfig
from avr_tpu.config import PathConfig, TrainConfig
from conftest import tiny_model_config, tiny_render_config
from test_torch_data import _assert_same_file, _files
from test_torch_runner import port_cfg

from avr_torch.__main__ import NOT_PORTED
from avr_torch.__main__ import main
from avr_torch.data import synthetic
from avr_torch.train.runner import AVRRunner

torch.set_num_threads(2)

ROOM = dict(size=(4.0, 3.0, 2.5), max_order=1, fs=4000, seq_len=256)


def tiny_cfg(logdir, expname, dataset_type, complex_variant=False, **train_kw):
    """tests/test_cli.py's render config, in the port's classes."""
    rc = tiny_render_config(n_samples=4, n_azi=4, n_ele=2, fs=4000)
    rc.far = 6.0
    rc.xyz_min, rc.xyz_max = [0.0] * 3, [4.0] * 3
    train = dict(lr=5e-3, total_iterations=2, save_freq=2, val_freq=100, batch_size=4,
                 compute_dtype="float32", seed=0)
    train.update(train_kw)
    jcfg = JAVRConfig(
        path=PathConfig(expname=expname, dataset_type=dataset_type, logdir=str(logdir)),
        render=rc, train=TrainConfig(**train),
        model=tiny_model_config(signal_output_dim=256, complex_variant=complex_variant),
    )
    return port_cfg(jcfg)


def trained(tmp_path, writer, dataset_type, complex_variant=False, **kw):
    """A port runner trained 2 steps on a synthetic set; returns its logdir."""
    d = str(tmp_path / "data")
    getattr(synthetic, writer)(d, synthetic.RoomSpec(**ROOM), **kw.pop("data", {"n": 8}))
    cfg = tiny_cfg(tmp_path / "logs", "r", dataset_type, complex_variant, **kw)
    runner = AVRRunner(cfg, d, device="cpu")
    runner.train()
    return runner.logdir, d


def queries(path, n, **extra):
    rng = np.random.default_rng(0)
    np.savez(path, pos_rx=rng.uniform(1, 3, (n, 3)).astype(np.float32),
             pos_tx=rng.uniform(1, 3, (n, 3)).astype(np.float32), **extra)
    return str(path)


def test_cli_help(capsys):
    main(["--help"])
    out = capsys.readouterr().out
    for cmd in ("train", "render", "doa", "das", "rotate", "synth", "tools", *NOT_PORTED):
        assert cmd in out


def test_cli_unknown_command():
    with pytest.raises(SystemExit) as e:
        main(["frobnicate"])
    assert e.value.code == 2


@pytest.mark.parametrize("cmd", NOT_PORTED)
def test_cli_commands_not_ported_yet_exit_2(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 2 and "not ported yet" in capsys.readouterr().out


def test_cli_render_from_checkpoint(tmp_path):
    logdir, _ = trained(tmp_path, "write_simu_dataset", "Simu")
    out, wavs = str(tmp_path / "irs.npz"), str(tmp_path / "wavs")
    main(["render", "--config", f"{logdir}/avr_conf.yml", "--queries", queries(tmp_path / "q.npz", 5),
          "--out", out, "--batch", "4", "--time_domain", "--wav_dir", wavs, "--device", "cpu"])
    z = np.load(out)
    assert z["spec"].shape == (5, 129) and z["spec"].dtype == np.complex64
    assert np.isfinite(z["spec"]).all()
    assert z["ir"].shape == (5, 256)
    np.testing.assert_array_equal(z["ir"], np.fft.irfft(z["spec"], n=256, axis=-1).astype(np.float32))
    assert len(os.listdir(wavs)) == 5


def test_cli_render_raf_with_rot_tx(tmp_path):
    logdir, _ = trained(tmp_path, "write_raf_dataset", "RAF", complex_variant=True)
    rng = np.random.default_rng(1)
    rot = rng.normal(size=(3, 3))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    q = queries(tmp_path / "q.npz", 3, rot_tx=rot.astype(np.float32))
    out = str(tmp_path / "irs.npz")
    main(["render", "--config", f"{logdir}/avr_conf.yml", "--queries", q, "--out", out, "--device", "cpu"])
    z = np.load(out)
    assert z["spec"].shape == (3, 129) and np.isfinite(z["spec"]).all()


def test_cli_render_refuses_without_checkpoint(tmp_path):
    conf = str(tmp_path / "c.yml")
    tiny_cfg(tmp_path / "logs", "empty", "Simu").to_yaml(conf)
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["render", "--config", conf, "--queries", queries(tmp_path / "q.npz", 2),
              "--out", str(tmp_path / "o.npz"), "--device", "cpu"])


@pytest.mark.parametrize(
    "arrays,match",
    [
        (dict(pos_rx=np.zeros((0, 3), np.float32), pos_tx=np.zeros((0, 3), np.float32)), "zero rows"),
        (dict(pos_rx=np.zeros((2, 3), np.float32)), "missing required key"),
        (dict(pos_rx=np.zeros((2, 3), np.float32), pos_tx=np.zeros((3, 3), np.float32)), "rows"),
    ],
    ids=["empty", "missing_key", "row_mismatch"],
)
def test_cli_render_validates_queries(tmp_path, arrays, match):
    conf = str(tmp_path / "c.yml")
    tiny_cfg(tmp_path / "logs", "qv", "Simu").to_yaml(conf)
    q = str(tmp_path / "q.npz")
    np.savez(q, **arrays)
    with pytest.raises(SystemExit, match=match):
        main(["render", "--config", conf, "--queries", q, "--out", str(tmp_path / "o.npz"), "--device", "cpu"])


def test_cli_render_ignores_group8_sampling(tmp_path):
    logdir, _ = trained(tmp_path, "write_real_env_dataset", "Real_env", batch_size=8,
                        das_reg_loss_weight=1.0, data={"n_groups": 2, "seed": 0},
                        extra={"group_sampling": True})
    q = queries(tmp_path / "q.npz", 3, ch_idx=np.arange(3, dtype=np.int32))  # not a multiple of 8
    out = str(tmp_path / "o.npz")
    main(["render", "--config", f"{logdir}/avr_conf.yml", "--queries", q, "--out", out, "--device", "cpu"])
    z = np.load(out)
    assert z["spec"].shape[0] == 3 and np.isfinite(z["spec"]).all()


def test_cli_train_then_test_mode_loads_checkpoint(tmp_path):
    d = str(tmp_path / "simu")
    synthetic.write_simu_dataset(d, synthetic.RoomSpec(**ROOM), n=8)
    conf = str(tmp_path / "c.yml")
    cfg = tiny_cfg(tmp_path / "logs", "tm", "Simu")
    cfg.to_yaml(conf)
    main(["train", "--config", conf, "--dataset_dir", d, "--device", "cpu"])
    logdir = os.path.join(cfg.path.logdir, cfg.path.expname)
    # the config backup has load_ckpt: false; test mode must load anyway
    main(["train", "--mode", "test", "--config", logdir, "--dataset_dir", d, "--device", "cpu"])
    log = open(os.path.join(logdir, "train.log")).read()
    assert "resumed from checkpoint step 2" in log
    assert any("000002" in f for f in os.listdir(os.path.join(logdir, "val_result")))


@pytest.mark.parametrize("cmd", ["train", "render"])
def test_cli_defaults_to_the_card(monkeypatch, tmp_path, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    logdir, d = trained(tmp_path, "write_simu_dataset", "Simu")
    args = {
        "train": ["--config", f"{logdir}/avr_conf.yml", "--dataset_dir", d],
        "render": ["--config", f"{logdir}/avr_conf.yml", "--queries", queries(tmp_path / "q.npz", 2),
                   "--out", str(tmp_path / "o.npz")],
    }[cmd]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([cmd, *args])


@pytest.mark.parametrize("fmt", ["Simu", "Real_env", "MeshRIR", "RAF"])
def test_cli_synth_matches_jax(tmp_path, fmt, capsys):
    args = ["--format", fmt, "--n", "2" if fmt == "Real_env" else "6", "--fs", "4000",
            "--seq_len", "128", "--seed", "3"]
    jmain(["synth", "--out", str(tmp_path / "jax"), *args])
    main(["synth", "--out", str(tmp_path / "torch"), *args])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(tmp_path / "jax"), "X") == out[1].replace(str(tmp_path / "torch"), "X")
    files = _files(tmp_path / "jax")
    assert files and files == _files(tmp_path / "torch")
    for f in files:
        _assert_same_file(os.path.join(tmp_path, "jax", f), os.path.join(tmp_path, "torch", f))


def test_cli_tools_inspect(tmp_path, capsys):
    p = str(tmp_path / "x.npz")
    np.savez(p, ir=np.ones((8, 16), np.float32), position_rx=np.zeros((8, 3)))
    main(["tools", "inspect", p])
    info = json.loads(capsys.readouterr().out)
    assert info["ir"]["shape"] == [8, 16]
    a = str(tmp_path / "a.npy")
    np.save(a, np.arange(6, dtype=np.float32).reshape(2, 3))
    main(["tools", "inspect", a])
    assert json.loads(capsys.readouterr().out)["max"] == 5.0


def test_cli_tools_meshrir_split(tmp_path, capsys):
    src = tmp_path / "raw"
    src.mkdir()
    np.save(str(src / "pos_mic.npy"), np.zeros((20, 3)))
    np.save(str(src / "pos_src.npy"), np.zeros((1, 3)))
    for i in range(20):
        np.save(str(src / f"ir_{i:05d}.npy"), np.zeros(64, np.float32))
    main(["tools", "meshrir-split", str(src), "--test_ratio", "0.2"])
    res = json.loads(capsys.readouterr().out)
    assert res["train"] + res["test"] == 20 and res["test"] == 4


@pytest.fixture(scope="module")
def val_npz(tmp_path_factory):
    """A val_iter npz of two 8-mic groups: the targets of a synthetic
    Real_env set, and predictions with seeded noise on them."""
    from avr_torch.data import load_dataset

    root = tmp_path_factory.mktemp("doa")
    d = str(root / "data")
    synthetic.write_real_env_dataset(d, synthetic.RoomSpec(size=(4.0, 3.0, 2.5), max_order=1, seq_len=512),
                                     n_groups=3, seed=1)
    data = load_dataset(d, "Real_env", seq_len=512)
    rng = np.random.default_rng(2)
    noise = (rng.normal(size=data.wave.shape) + 1j * rng.normal(size=data.wave.shape)) * 0.05
    path = str(root / "val_iter000010.npz")
    np.savez_compressed(
        path, ori_sig=data.wave, pred_sig=(data.wave * (1 + noise)).astype(np.complex64),
        position_rx=data.pos_rx, position_tx=data.pos_tx, fs=16000, ch_idx=data.ch_idx,
    )
    return path


@pytest.mark.parametrize("cmd", ["doa", "das"])
def test_cli_doa_and_das_match_jax(val_npz, cmd, capsys):
    jmain([cmd, val_npz])
    ref = capsys.readouterr().out
    main([cmd, val_npz])
    got = capsys.readouterr().out
    summary = json.loads(got)
    assert got == ref and summary and all(v["n"] == 2 for v in summary.values())
