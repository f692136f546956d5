"""``python -m avr_torch``: tests/test_cli.py's tests for the port's
commands, on the CPU (``--device cpu``), with the outputs of synth, doa,
das, whitenoise, make-configs and every kind of plot held equal to the JAX
package's CLI on the same arguments."""

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
from test_torch_aggregators import _same_tree
from test_torch_runner import port_cfg

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


COMMANDS = ("train", "render", "doa", "das", "rotate", "whitenoise", "make-configs", "synth", "plot", "tools", "hpo")


def test_cli_help(capsys):
    main(["--help"])
    out = capsys.readouterr().out
    for cmd in COMMANDS:
        assert cmd in out


def test_cli_unknown_command():
    with pytest.raises(SystemExit) as e:
        main(["frobnicate"])
    assert e.value.code == 2


@pytest.mark.parametrize("cmd", COMMANDS)
def test_cli_every_command_runs(cmd, capsys):
    """Every command parses its arguments (``--help`` exits 0): none is
    left that exits 2."""
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out


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


def _jax_and_port(tmp_path, capsys, build):
    """``build(root)`` makes the inputs under root and returns the command's
    arguments; runs the JAX CLI on tmp_path/jax and the port's on
    tmp_path/torch. Returns the two outputs with each root replaced by ROOT."""
    out = {}
    for name, cli in (("jax", jmain), ("torch", main)):
        root = tmp_path / name
        root.mkdir()
        cli(build(root))
        out[name] = capsys.readouterr().out.replace(str(root), "ROOT")
    return out["jax"], out["torch"]


def test_cli_whitenoise_matches_jax(tmp_path, capsys):
    import yaml
    from test_doa import _fake_npz

    def build(root):
        conf = {"npz": _fake_npz(root, [45.0, 135.0]), "outdir": str(root / "wn"), "fs": 16000, "seeds": [0],
                "long_noise_seconds": 1.0, "stft_grid": [{"nfft": 256, "hop": 128, "win": "hann"}],
                "T_use_list": [8, 16]}
        (root / "wn.yml").write_text(yaml.safe_dump(conf))
        return ["whitenoise", "--config", str(root / "wn.yml"), "--force"]

    ref, got = _jax_and_port(tmp_path, capsys, build)
    assert got == ref and "mean_pred_vs_gt" in got
    _same_tree(str(tmp_path / "jax" / "wn"), str(tmp_path / "torch" / "wn"))


def test_cli_make_configs_matches_jax(tmp_path, capsys):
    import yaml

    def build(root):
        d = root / "real_exp"
        d.mkdir()
        base = {"path": {"expname": "Real_exp_param_1_1", "dataset_type": "Real_env", "logdir": "logs/"},
                "train": {"lr": 1e-3}, "render": {"n_samples": 64}, "model": {"signal_network": {"n_neurons": 512}}}
        (d / "avr_real_exp_1.yml").write_text(yaml.safe_dump(base))
        (root / "sweep.yml").write_text(yaml.safe_dump(
            {"train": {"lr": [1e-4, 1e-5]}, "model": {"signal_network": {"n_neurons": [256]}}}))
        return ["make-configs", "--base_dir", str(d), "--params", str(root / "sweep.yml")]

    ref, got = _jax_and_port(tmp_path, capsys, build)
    assert got == ref and got.count("wrote") == 3
    for n in ("2", "3", "4"):
        f = f"real_exp/avr_real_exp_{n}.yml"
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _plot_inputs(root, kind):
    """tests/test_plotting_tools.py's and tests/test_aggregators.py's inputs
    for one kind of ``plot``, under root; returns its inputs."""
    import pickle
    import shutil

    import yaml
    from test_aggregators import _fake_condition
    from test_doa import _fake_npz
    from test_plotting_tools import _fake_doa_pkls

    from avr_torch.utils.logging import MetricsWriter

    if kind in ("loss", "loss-epoch"):
        w = MetricsWriter(str(root / "run"))
        for step in (100, 200, 300):
            w.scalar("train_loss", 1.0 / step, step)
            w.scalars({"spec": 1.0 / step, "time": 3.0 / step}, step, prefix="train_loss/")
            w.scalars({"spec": 2.0 / step}, step, prefix="test_loss/")
        w.close()
        return [str(root / "run" / "metrics.jsonl") if kind == "loss" else str(root / "run")]
    if kind == "doa-scatter":
        with open(root / "doa.pkl", "wb") as f:
            pickle.dump({"NormMUSIC": {"pred_vs_gt_error": [1.0, 2.0, None, 4.0]}}, f)
        return [str(root / "doa.pkl")]
    if kind in ("doa-detail", "das-detail"):
        sub, method = (("doa_results", "NormMUSIC") if kind == "doa-detail"
                       else ("beamform_results", ["NormDAS_soft-argmax", "NormDAS_argmax"]))
        _fake_doa_pkls(str(root / "exp" / sub), method, {1000: 40.0, 2000: 10.0})
        return [str(root / "exp")]
    if kind in ("frame-errors", "frame-scatter", "median-summary", "waveform-level"):
        (root / "conds").mkdir()
        paths = [_fake_condition(root / "conds", "results_a.pkl"), _fake_condition(root / "conds", "results_b.pkl")]
        return {"frame-errors": paths, "frame-scatter": paths[:1]}.get(kind, [str(root / "conds")])
    if kind in ("stft-compare", "band-response"):
        return [_fake_npz(root, [60.0, 300.0])]
    if kind == "rotate":
        np.savez(root / "rot.npz", pred_deg=np.asarray([10, 50, 100], np.int16),
                 true_deg=np.asarray([12, 48, 95], np.int16), deg_step=np.float32(30.0))
        return [str(root / "rot.npz")]
    assert kind == "report"
    base = root / "logs" / "exp1"
    (base / "val_result").mkdir(parents=True)
    shutil.copy(_fake_npz(root, [45.0, 120.0]), base / "val_result" / "val_iter000100.npz")
    with open(base / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"tag": "train_loss", "value": 0.01, "step": 100}) + "\n")
    (root / "conf.yml").write_text(yaml.safe_dump(
        {"path": {"expname": "exp1", "logdir": str(root / "logs"), "dataset_type": "Real_env"},
         "render": {"fs": 16000}, "train": {}, "model": {}}))
    return [str(root / "conf.yml")]


PLOT_KINDS = ("loss", "loss-epoch", "doa-scatter", "doa-detail", "das-detail", "frame-errors", "frame-scatter",
              "stft-compare", "band-response", "median-summary", "waveform-level", "rotate", "report")


@pytest.mark.parametrize("kind", PLOT_KINDS)
def test_cli_plot_matches_jax(tmp_path, capsys, kind):
    """Each kind of ``plot`` prints what the JAX CLI prints and writes the
    same files. ``stft-compare`` is held against the JAX function: the JAX
    CLI passes it ``save_path=``, which it does not take."""
    save = {"median-summary": "summary.csv", "stft-compare": "stft.csv", "waveform-level": "wl"}.get(kind, "fig.png")

    def build(root):
        return ["plot", kind, *_plot_inputs(root, kind), "--save", str(root / save)]

    if kind == "stft-compare":
        from avr_tpu.eval import aggregators as jagg

        root = tmp_path / "jax"
        root.mkdir()
        df = jagg.compare_stft_conditions(_plot_inputs(root, kind), save_csv=str(root / save))
        ref = f"{df.to_string()}\nwrote {root / save}\n".replace(str(root), "ROOT")
        (tmp_path / "torch").mkdir()
        main(build(tmp_path / "torch"))
        got = capsys.readouterr().out.replace(str(tmp_path / "torch"), "ROOT")
    else:
        ref, got = _jax_and_port(tmp_path, capsys, build)
    assert got == ref and got.endswith(f"wrote ROOT/{save}\n")
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_cli_train_under_torchrun_builds_the_plan(tmp_path):
    """``torchrun -m avr_torch train`` with 2 CPU ranks and ``--data_parallel
    2``: the ranks join gloo from torchrun's environment, train on the plan,
    and rank 0 alone writes; the checkpoint matches a single-process run's
    to tests/test_train.py's tolerances."""
    import subprocess
    import sys

    d = str(tmp_path / "simu")
    synthetic.write_simu_dataset(d, synthetic.RoomSpec(**ROOM), n=8)
    confs = {}
    for name in ("plan", "single"):
        confs[name] = str(tmp_path / f"{name}.yml")
        tiny_cfg(tmp_path / name, "tr", "Simu", total_iterations=1, save_freq=1, log_freq=1,
                 energy_loss_weight=0.0, multistft_loss_weight=0.0).to_yaml(confs[name])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "avr_torch", "train", "--config", confs["plan"], "--dataset_dir", d, "--device", "cpu",
         "--data_parallel", "2"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    main(["train", "--config", confs["single"], "--dataset_dir", d, "--device", "cpu"])
    plan_dir, single_dir = tmp_path / "plan" / "tr", tmp_path / "single" / "tr"
    assert open(plan_dir / "command_log.txt").read().count("\n") == 1
    keys = [(json.loads(l)["tag"], json.loads(l)["step"]) for l in open(plan_dir / "metrics.jsonl")]
    assert keys and len(keys) == len(set(keys))
    got = torch.load(plan_dir / "ckpts" / "1" / "state.pt", weights_only=True)
    want = torch.load(single_dir / "ckpts" / "1" / "state.pt", weights_only=True)
    assert int(got["step"]) == int(want["step"]) == 1
    from avr_torch.train.state import named_leaves

    for (n, a), (_, b) in zip(named_leaves(got["params"]), named_leaves(want["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6, err_msg=n)
