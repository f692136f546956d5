"""avr_torch's HPO engine, trial driver and ``python -m avr_torch hpo``
against the JAX package's (``avr_tpu/hpo``), on the CPU at tiny sizes."""

import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from avr_tpu.config import AVRConfig as JAVRConfig
from avr_tpu.config import PathConfig, TrainConfig
from avr_tpu.hpo import runner as jrunner
from avr_tpu.hpo.study import Study as JStudy
from conftest import tiny_model_config, tiny_render_config
from test_doa import _fake_npz
from test_torch_runner import port_cfg

from avr_torch.__main__ import main
from avr_torch.config import AVRConfig
from avr_torch.data import synthetic
from avr_torch.hpo import runner as trunner
from avr_torch.hpo.study import Study, create_study

torch.set_num_threads(2)

VARIANTS = ["base", "ch", "ch_without_das", "ch_only_das", "das", "runtime"]
# a value for every parameter any variant suggests (categoricals among their choices)
SEEDED = {
    "batch_size": 2, "lr": 3e-5, "eta_min_ratio": 0.1, "n_samples": 50, "n_azi": 60,
    "weight_decay": 1e-4, "spec_loss_weight": 3.0, "angle_loss_weight": 0.5,
    "time_loss_weight": 90.0, "energy_loss_weight": 5.0, "multistft_loss_weight": 1.0,
    "sigma_encoder_network_n_neurons": 6, "sigma_decoder_network_n_neurons": 7,
    "signal_network_n_neurons": 8, "is_embed": True, "connection_type": "concat",
    "is_sigma_encoder": True, "is_sigma_decoder": False, "is_signal_network": True,
    "emb_dim_sigma_encoder": 3, "emb_dim_sigma_decoder": 4, "emb_dim_signal_network": 5,
    "das_reg_loss_weight": 10.0, "das_ce_loss_weight": 2.0, "emb_dim": 4,
}


def test_ask_tell_enqueue():
    """ask() hands out distinct numbers before any tell(); tell() records
    values and FAILs; enqueue_trial serves fixed values (clamped) to the
    next asked trial only."""
    study = Study("s", n_startup=2)
    study.enqueue_trial({"lr": 1e-3, "x": 5})
    a, b, c = study.ask(), study.ask(), study.ask()
    assert [a.number, b.number, c.number] == [0, 1, 2]
    assert a.suggest_float("lr", 1e-6, 2e-3, log=True) == 1e-3
    assert a.suggest_int("x", 0, 3) == 3  # clamped to high
    v = b.suggest_float("lr", 1e-6, 2e-3, log=True)
    assert 1e-6 <= v <= 2e-3 and v != 1e-3  # sampled, not replayed
    c.suggest_float("lr", 1e-6, 2e-3, log=True)
    study.tell(b, 5.0)
    study.tell(a, 9.0)
    study.tell(c, None, state="FAIL")
    assert study.best_value == 5.0 and study.best_trial["number"] == 1
    assert study.ask().number == 3  # past told and failed trials


@pytest.mark.parametrize("storage", [False, True], ids=["memory", "sqlite"])
def test_optimize_after_ask_numbers_past_pending_trials(tmp_path, storage):
    """A trial asked but not yet told keeps its number: ``optimize`` in the
    same process numbers past it. The JAX copy hands that number out again."""
    def numbers(cls, name):
        db = f"sqlite:///{tmp_path}/{name}.db" if storage else None
        study = cls(name, storage=db, n_startup=2)
        pending = study.ask()
        study.optimize(lambda t: t.suggest_float("x", 0.0, 1.0), n_trials=2)
        study.tell(pending, 0.5)
        return pending.number, sorted(t["number"] for t in study.trials)

    assert numbers(JStudy, "jax") == (0, [0, 0, 1])  # the duplicate
    assert numbers(Study, "port") == (0, [0, 1, 2])
    study = Study("after", n_startup=2)
    study.optimize(lambda t: 1.0, n_trials=2)
    assert study.ask().number == 2  # ask after optimize continues too


def _jax_base():
    cfg = JAVRConfig()
    cfg.path = PathConfig(expname="real_exp_param_0_1")
    cfg.train.batch_size = 4
    cfg.train.total_iterations = cfg.train.T_max = 33200
    cfg.train.save_freq = cfg.train.val_freq = 3320
    cfg.train.das_reg_loss_weight = 10.0
    return cfg


@pytest.mark.parametrize("seeded", [True, False], ids=["enqueued", "sampled"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_update_config_matches_jax(variant, seeded):
    """Every variant's search space mutates the config as JAX's does, for
    enqueued values and for values the two studies sample from one seed."""
    jcfg = _jax_base()
    tcfg = port_cfg(jcfg)
    js, ts = JStudy("j", seed=3), Study("t", seed=3)
    if seeded:
        js.enqueue_trial(SEEDED)
        ts.enqueue_trial(SEEDED)
    jt, tt = js.ask(), ts.ask()
    jout = jrunner.update_config(jcfg, 40, jt.number, jt, variant)
    tout = trunner.update_config(tcfg, 40, tt.number, tt, variant)
    assert tt.params == jt.params and tt.params
    assert tout.to_dict() == port_cfg(jout).to_dict()
    assert tout.path.expname == "real_exp_param_40_1"
    assert tcfg.to_dict() == port_cfg(jcfg).to_dict()  # the base is left as it was


def test_doa_objective_matches_jax(tmp_path):
    """The objective and its per-checkpoint curve equal JAX's on one npz,
    and an empty logdir scores 999 in both."""
    src = _fake_npz(tmp_path, [45.0, 200.0])
    values = {}
    for name, mod in (("jax", jrunner), ("port", trunner)):
        logdir = str(tmp_path / name)
        os.makedirs(os.path.join(logdir, "val_result"))
        shutil.copy(src, os.path.join(logdir, "val_result", "val_iter000010.npz"))
        values[name] = mod.doa_objective_from_logdir(logdir, 16000, return_curve=True)
        assert mod.doa_objective_from_logdir(str(tmp_path / "none"), 16000) == 999.0
    assert values["port"] == values["jax"]
    assert values["port"][0] < 15


def _tiny_yaml(tmp_path, logdir, **train_kw):
    """tests/test_hpo_population.py's tiny config as a YAML file for the CLI."""
    rc = tiny_render_config(n_samples=4, n_azi=4, n_ele=2, fs=4000)
    rc.far = 6.0
    rc.xyz_min, rc.xyz_max = [0.0] * 3, [4.0] * 3
    train = dict(lr=5e-3, T_max=50, eta_min=1e-4, total_iterations=2, save_freq=2, val_freq=2,
                 batch_size=4, log_freq=1, compute_dtype="float32", seed=0)
    train.update(train_kw)
    jcfg = JAVRConfig(
        path=PathConfig(expname="tiny_param_0_1", dataset_type="Simu", logdir=str(logdir)),
        render=rc, train=TrainConfig(**train), model=tiny_model_config(signal_output_dim=256),
    )
    path = str(tmp_path / "hpo.yml")
    port_cfg(jcfg).to_yaml(path)
    return path


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("simu_hpo"))
    synthetic.write_simu_dataset(d, synthetic.RoomSpec(size=(4.0, 3.0, 2.5), max_order=1, fs=4000,
                                                       seq_len=256), n=12)
    return d


@pytest.mark.parametrize("pop", [0, 2], ids=["serial", "pop2"])
def test_cli_hpo_runs_a_study(tmp_path, dataset_dir, pop, capsys):
    """``python -m avr_torch hpo`` at a tiny size: 2 runtime-variant trials,
    one at a time or as one population of 2; both are told with a finite
    objective, and each trial's logdir holds its val_iter npz."""
    yml = _tiny_yaml(tmp_path, tmp_path / "logs")
    db = tmp_path / "study.db"
    argv = ["hpo", "--config", yml, "--dataset_dir", dataset_dir, "--variant", "runtime",
            "--n_trials", "2", "--storage", f"sqlite:///{db}", "--device", "cpu"]
    main(argv + (["--pop", str(pop)] if pop else []))
    assert "best:" in capsys.readouterr().out
    rows = sqlite3.connect(str(db)).execute(
        "SELECT number, state, value FROM trials ORDER BY number").fetchall()
    assert [(n, st) for n, st, _ in rows] == [(0, "COMPLETE"), (1, "COMPLETE")]
    assert all(np.isfinite(v) for _, _, v in rows)
    for n in (0, 1):
        npz = tmp_path / "logs" / f"tiny_param_{n}_1" / "val_result" / "val_iter000002.npz"
        assert npz.exists(), npz


def test_cli_hpo_pop_needs_the_runtime_variant(tmp_path, dataset_dir, capsys):
    yml = _tiny_yaml(tmp_path, tmp_path / "logs")
    with pytest.raises(SystemExit) as e:
        main(["hpo", "--config", yml, "--dataset_dir", dataset_dir, "--pop", "2", "--device", "cpu"])
    assert e.value.code == 2 and "--variant runtime" in capsys.readouterr().err


def test_population_study_counts_failed_trials(tmp_path, dataset_dir):
    """A population that fails to train is told as FAIL and counts toward
    n_trials, so the study ends (the JAX script's loop counts COMPLETE
    trials only)."""
    from avr_torch.hpo.population import run_population_study

    cfg = AVRConfig.from_yaml(_tiny_yaml(tmp_path, tmp_path / "logs", batch_size=64))  # no batch fits
    study = create_study("fails")
    lines = []
    told = run_population_study(study, cfg, dataset_dir, n_trials=3, K=2, device="cpu", log=lines.append)
    assert told == [(0, None), (1, None), (2, None), (3, None)]
    assert study.trials == [] and len(lines) == 2 and "failed to train" in lines[0]
