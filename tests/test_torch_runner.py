"""avr_torch's training runner against the JAX package's
(``avr_tpu/train/runner.py``), on the CPU at the tiny size of
tests/test_train.py, fp32 compute.

One JAX runner is shared by the module: it trains 2 steps (its state is
kept), then on to 12 with validations at 6 and 12. The port is given the
JAX state through ``state_from_jax`` and JAX's ray directions, since torch
cannot draw JAX's random numbers; runs of the port's own runner are held
to the JAX run's structure (files, keys, dtypes, shapes, tags), not its
values.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu import geometry as jgeo
from avr_tpu.config import AVRConfig as JAVRConfig
from avr_tpu.config import PathConfig, TrainConfig
from avr_tpu.data import synthetic as jsynth
from avr_tpu.data.sampler import BatchSampler
from avr_tpu.losses import CriterionConfig as JCrit
from avr_tpu.train import state as jstate_lib
from avr_tpu.train.runner import AVRRunner as JRunner
from conftest import tiny_model_config, tiny_render_config

from avr_torch.config import AVRConfig
from avr_torch.convert import state_from_jax, state_to_numpy
from avr_torch.losses import CriterionConfig as TCrit
from avr_torch.train import state as tstate_lib
from avr_torch.train.runner import AVRRunner

torch.set_num_threads(2)

FS = 4000


def jax_cfg(logdir: str) -> JAVRConfig:
    """tests/test_train.py's tiny config."""
    rc = tiny_render_config(n_samples=8, n_azi=6, n_ele=3, fs=FS)
    rc.far = 6.0
    rc.xyz_min, rc.xyz_max = [0.0] * 3, [4.0] * 3
    return JAVRConfig(
        path=PathConfig(expname="tiny", dataset_type="Simu", logdir=logdir),
        render=rc,
        train=TrainConfig(
            lr=5e-3, T_max=50, eta_min=1e-4, total_iterations=12,
            save_freq=6, val_freq=6, batch_size=4, log_freq=2,
            compute_dtype="float32", seed=0,
        ),
        model=tiny_model_config(signal_output_dim=256),
    )


def port_cfg(jcfg: JAVRConfig, logdir: str = None, **train_kw) -> AVRConfig:
    """The same config in the port's classes (``extra`` keys lifted back to
    their section, as a YAML file has them)."""
    def lift(d):
        if not isinstance(d, dict):
            return d
        out = {k: lift(v) for k, v in d.items() if k != "extra"}
        out.update(d.get("extra", {}))
        return out

    cfg = AVRConfig.from_dict(lift(jcfg.to_dict()))
    if logdir is not None:
        cfg.path.logdir = logdir
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """tests/test_train.py's Simu set with reflections up to order 6 (not
    2), so that the targets hold energy after 50 ms: with order 2 their
    tail is fp32 noise of the irfft, and C50 would compare noise."""
    room = jsynth.RoomSpec(size=(4.0, 3.0, 2.5), max_order=6, fs=FS, seq_len=256)
    d = str(tmp_path_factory.mktemp("simu"))
    jsynth.write_simu_dataset(d, room, n=24)
    return d


@pytest.fixture(scope="module")
def jax_run(dataset_dir, tmp_path_factory):
    cfg = jax_cfg(str(tmp_path_factory.mktemp("jax_logs")))
    cfg.train.total_iterations = 2
    runner = JRunner(cfg, dataset_dir)
    runner.train()
    state2 = jax.device_get(runner.state)
    cfg.train.total_iterations = 12
    runner.train()
    return SimpleNamespace(runner=runner, cfg=cfg, state2=state2, state12=jax.device_get(runner.state))


def read_metrics(logdir):
    """{(tag, step): value} of a run's metrics.jsonl (the last write wins)."""
    out = {}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[(r["tag"], r["step"])] = r["value"]
    return out


def jax_eval_dirs(cfg):
    return np.array(jgeo.ray_directions(cfg.render.n_azi, cfg.render.n_ele, key=jax.random.PRNGKey(1234)))


def assert_states_equal(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    assert a["step"] == b["step"]
    for k in ("params", "mu", "nu"):
        la, lb = jax.tree_util.tree_leaves(a[k]), jax.tree_util.tree_leaves(b[k])
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode_set", ["test", "train"])
def test_validation_matches_jax(jax_run, dataset_dir, tmp_path, mode_set):
    runner = AVRRunner(port_cfg(jax_run.cfg, str(tmp_path)), dataset_dir, device="cpu")
    runner.state = state_from_jax(jax_run.state12, device="cpu")
    runner.validate(12, mode_set, dirs=jax_eval_dirs(jax_run.cfg))
    got, ref = read_metrics(runner.logdir), read_metrics(jax_run.runner.logdir)
    tags = [t for t, s in ref if s == 12 and t.startswith((f"{mode_set}_loss/", f"{mode_set}_metric/"))]
    assert len(tags) == 14 and all((t, 12) in got for t in tags)
    for tag in tags:
        a, b = got[(tag, 12)], ref[(tag, 12)]
        name = tag.split("/")[1]
        if tag.startswith(f"{mode_set}_loss/"):
            assert abs(a - b) <= 1e-4 * abs(b), (tag, a, b)
        elif name == "T60":
            assert abs(a - b) <= 5e-2 * abs(b), (tag, a, b)
        elif name == "EDT":
            assert abs(a - b) <= 6.0 / FS, (tag, a, b)
        else:
            assert abs(a - b) <= 1e-3 * abs(b), (tag, a, b)
    if mode_set == "test":
        name = "val_iter000012.npz"
        with np.load(os.path.join(runner.logdir, "val_result", name)) as t, \
                np.load(os.path.join(jax_run.runner.logdir, "val_result", name)) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
                if k != "pred_sig":
                    np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            scale = np.abs(j["pred_sig"]).max()
            assert np.abs(t["pred_sig"] - j["pred_sig"]).max() <= 5e-5 * scale


def test_one_step_from_a_carried_jax_state(jax_run, dataset_dir):
    """The JAX state after 2 runner steps, carried over with its Adam
    moments, then one more step of each framework on the same batch and
    directions, to 1e-4 of scale.

    The energy-decay and multi-resolution STFT terms have weight 0 here:
    their fp32 gradients are not reproducible to that tolerance (logs of
    near-zero energies and magnitudes). The energy term is
    tests/test_torch_train.py's case; for the STFT term, JAX's own jitted
    and eager steps from this state differ by 5.9e-4, 2.5e-4 and 1.2e-4
    of scale in params, mu and nu with the full criterion, more than the
    port's jitted-JAX difference. Their values are held in
    test_validation_matches_jax."""
    jr, cfg = jax_run.runner, jax_run.cfg
    tc, rc = cfg.train, cfg.render
    crit_kw = dict(fs=rc.fs, speed=rc.speed, energy_loss_weight=0.0, multistft_loss_weight=0.0)
    batch = BatchSampler(jr.train_data, 4, shuffle=False).gather(np.arange(4))
    key, it = jax.random.PRNGKey(tc.seed + 1), 3
    jstep, _ = jstate_lib.make_train_step(jr.fstatic, jr.consts, rc, tc, JCrit(**crit_kw))
    jstate = jax.tree_util.tree_map(jnp.asarray, jax_run.state2)
    jnew, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.asarray(it, jnp.int32))
    jnew = jax.device_get(jnew)

    tcfg = port_cfg(cfg)
    from avr_torch.models import field as tfield
    from avr_torch.render.common import make_consts

    tfst = tfield.build_field(tcfg.model, "Simu")
    tstep, _ = tstate_lib.make_train_step(
        tfst, make_consts(tcfg.render, 256, device="cpu"), tcfg.render, tcfg.train, TCrit(**crit_kw)
    )
    dirs = np.array(jgeo.ray_directions(rc.n_azi, rc.n_ele, key=jax.random.fold_in(key, it)))
    tstate = state_from_jax(jax_run.state2, device="cpu")
    tnew, _ = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(dirs))

    got = state_to_numpy(tnew)
    ref = state_to_numpy(state_from_jax(jnew, device="cpu"))
    assert got["step"] == ref["step"] == 3
    for k in ("params", "mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(ref[k])):
            scale = max(float(np.abs(b).max()), 1e-30)
            assert np.abs(a - b).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("frac", [0, "1", "half", "T_max", "beyond"])
def test_current_lr_matches_jax_schedule(frac):
    tc = jax_cfg("unused").train
    step = {0: 0, "1": 1, "half": tc.T_max // 2, "T_max": tc.T_max, "beyond": 3 * tc.T_max}[frac]
    ref = float(jstate_lib.make_schedule(tc)(step))
    got = tstate_lib.current_lr(port_cfg(jax_cfg("unused")).train, step)
    assert abs(got - ref) <= 1e-6 * ref


def test_train_and_validate_structure_matches_jax(jax_run, dataset_dir, tmp_path):
    runner = AVRRunner(port_cfg(jax_run.cfg, str(tmp_path)), dataset_dir, device="cpu")
    runner.train()
    assert int(runner.state.step) == 12
    assert runner.checkpoint_steps() == [6, 12]
    jdir, tdir = (os.path.join(r.logdir, "val_result") for r in (jax_run.runner, runner))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == ["val_iter000006.npz", "val_iter000012.npz"]
    for name in names:
        with np.load(os.path.join(tdir, name)) as t, np.load(os.path.join(jdir, name)) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                assert (t[k].dtype, t[k].shape) == (j[k].dtype, j[k].shape), k
            assert np.isfinite(t["pred_sig"]).all()
    tags = lambda d: {t for t, _ in read_metrics(d)}  # noqa: E731
    assert tags(runner.logdir) == tags(jax_run.runner.logdir)
    train_loss = [v for (t, s), v in read_metrics(runner.logdir).items() if t == "train_loss"]
    assert len(train_loss) == 6 and np.isfinite(train_loss).all()
    for f in ("avr_conf.yml", "command_log.txt", "train.log"):
        assert os.path.exists(os.path.join(runner.logdir, f)), f


def test_resume_restores_state_bit_equal(dataset_dir, tmp_path):
    cfg = port_cfg(jax_cfg(str(tmp_path)), total_iterations=4, save_freq=2, val_freq=100)
    runner = AVRRunner(cfg, dataset_dir, device="cpu")
    runner.train()
    assert runner.checkpoint_steps() == [2, 4]
    cfg.train.load_ckpt = True
    resumed = AVRRunner(cfg, dataset_dir, device="cpu")
    assert_states_equal(resumed.state, runner.state)
    assert resumed.load_checkpoint(2)
    assert int(resumed.state.step) == 2
    # resuming from 2 goes on to 4 through the same directions and steps
    resumed.train()
    assert int(resumed.state.step) == 4


def test_checkpoints_keep_the_five_newest(dataset_dir, tmp_path):
    cfg = port_cfg(jax_cfg(str(tmp_path)), total_iterations=7, save_freq=1, val_freq=100, log_freq=100)
    runner = AVRRunner(cfg, dataset_dir, device="cpu")
    os.makedirs(os.path.join(runner.logdir, "ckpts", "99"))  # no state.pt: not a checkpoint
    runner.train()
    assert runner.checkpoint_steps() == [3, 4, 5, 6, 7] and runner.latest_step() == 7
    for step in runner.checkpoint_steps():
        assert os.listdir(os.path.join(runner.logdir, "ckpts", str(step))) == ["state.pt"]
    ckpt = torch.load(os.path.join(runner.logdir, "ckpts", "7", "state.pt"), weights_only=True)
    assert sorted(ckpt) == ["mu", "nu", "params", "step"] and ckpt["step"].dtype == torch.int32


def test_load_checkpoint_refuses_another_model(dataset_dir, tmp_path):
    cfg = port_cfg(jax_cfg(str(tmp_path)), total_iterations=1, val_freq=100)
    AVRRunner(cfg, dataset_dir, device="cpu").train()
    cfg.model.signal_network.n_neurons = 16
    cfg.train.load_ckpt = True
    with pytest.raises(ValueError, match="does not fit"):
        AVRRunner(cfg, dataset_dir, device="cpu")


def test_steps_per_call_is_bit_equal_to_single_steps(dataset_dir, tmp_path):
    runs = []
    for k in (1, 2):
        cfg = port_cfg(jax_cfg(str(tmp_path / f"k{k}")), total_iterations=4, save_freq=100,
                       val_freq=100, steps_per_call=k)
        r = AVRRunner(cfg, dataset_dir, device="cpu")
        r.train()
        runs.append(r)
    assert int(runs[0].state.step) == int(runs[1].state.step) == 4
    assert_states_equal(runs[0].state, runs[1].state)
    logged = [sorted(t for t, _ in read_metrics(r.logdir)) for r in runs]
    assert logged[0] == logged[1]


def test_validate_refuses_das_without_a_whole_group(dataset_dir, tmp_path):
    cfg = port_cfg(jax_cfg(str(tmp_path)), das_reg_loss_weight=1.0)
    runner = AVRRunner(cfg, dataset_dir, device="cpu")
    assert len(runner.test_data) < 8
    with pytest.raises(ValueError, match="fewer than one"):
        runner.validate(0)


def _with_adam(opt_state, rng, count):
    """``opt_state`` with its ScaleByAdamState moments replaced by random
    arrays and its count set."""
    if hasattr(opt_state, "_fields") and {"count", "mu", "nu"} <= set(opt_state._fields):
        rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: rng.normal(size=a.shape).astype(np.float32), t)
        return opt_state._replace(count=np.int32(count), mu=rand(opt_state.mu), nu=rand(opt_state.nu))
    if isinstance(opt_state, tuple):
        parts = [_with_adam(s, rng, count) for s in opt_state]
        return type(opt_state)(*parts) if hasattr(opt_state, "_fields") else tuple(parts)
    if isinstance(opt_state, dict):
        return {k: _with_adam(v, rng, count) for k, v in opt_state.items()}
    return opt_state


@pytest.mark.parametrize("chain", ["static", "weight_decay", "runtime_hparams"])
def test_state_from_jax_finds_adam_in_every_chain(chain):
    tc = TrainConfig(weight_decay=1e-3 if chain == "weight_decay" else 0.0,
                     runtime_hparams=chain == "runtime_hparams")
    from avr_tpu.models import field as jfield

    jfst = jfield.build_field(tiny_model_config(signal_output_dim=64), "Simu")
    params = jax.device_get(jfield.init(jax.random.PRNGKey(0), jfst))
    opt = _with_adam(jax.device_get(jstate_lib.make_optimizer(tc).init(params)), np.random.default_rng(0), 5)
    js = jstate_lib.TrainState(params, opt, np.int32(5))
    got = state_to_numpy(state_from_jax(js, device="cpu"))
    adam = [s for s in jax.tree_util.tree_leaves(opt, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu")]
    assert len(adam) == 1 and got["step"] == 5
    for k in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(getattr(adam[0], k))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="count"):
        state_from_jax(js._replace(step=np.int32(4)), device="cpu")


def test_runner_defaults_to_the_card(monkeypatch, dataset_dir, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AVRRunner(port_cfg(jax_cfg(str(tmp_path))), dataset_dir)


def test_config_backup_loads_as_written(dataset_dir, tmp_path):
    """The runner's avr_conf.yml backup keeps unknown keys where they were
    (``train.group_sampling`` stays in ``train.extra``). The JAX package's
    ``from_yaml`` nests them under ``extra.extra`` instead, which turns
    group sampling off for a run resumed from its backup."""
    cfg = port_cfg(jax_cfg(str(tmp_path)), extra={"group_sampling": True, "mystery_knob": 7})
    runner = AVRRunner(cfg, dataset_dir, device="cpu")
    backup = os.path.join(runner.logdir, "avr_conf.yml")
    loaded = AVRConfig.from_yaml(backup)
    assert loaded.train.extra == {"group_sampling": True, "mystery_knob": 7}
    assert loaded.model.extra == {} and loaded.path.extra == {} and loaded.render.extra == {}
    assert loaded.to_dict() == cfg.to_dict()
