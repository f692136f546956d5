"""The port's report figures and readers (``avr_torch/utils/plotting.py``,
``tb_events.py``, ``config_tools.py``, ``spatialization.py``) against the JAX
package's, on tests/test_plotting_tools.py's inputs: equal curves and
configs, the same files, and the beam pattern within 1e-6."""

import json
import os

import numpy as np
import pytest
import yaml

from avr_tpu.utils import config_tools as jct
from avr_tpu.utils import plotting as jplot
from avr_tpu.utils import tb_events as jtb
from avr_tpu.utils.spatialization import wide_cardioid_beam_pattern as jbeam

from avr_torch.utils import config_tools as tct
from avr_torch.utils import plotting as tplot
from avr_torch.utils import tb_events as ttb
from avr_torch.utils.logging import MetricsWriter
from avr_torch.utils.spatialization import wide_cardioid_beam_pattern as tbeam


@pytest.fixture
def metrics_jsonl(tmp_path):
    j = str(tmp_path / "metrics.jsonl")
    with open(j, "w") as f:
        for step in (20, 40, 60):
            f.write(json.dumps({"tag": "train_loss", "value": 1.0 / step, "step": step}) + "\n")
            f.write(json.dumps({"tag": "test_loss/spec_loss", "value": 2.0 / step, "step": step}) + "\n")
            f.write(json.dumps({"tag": "test_loss/time_loss", "value": 3.0 / step, "step": step}) + "\n")
        f.write("not json\n")
    return j


@pytest.fixture
def tb_logdir(tmp_path):
    """A logdir with both a metrics.jsonl and tensorboardX event files."""
    logdir = str(tmp_path / "run")
    w = MetricsWriter(logdir)
    for step in (100, 200, 300):
        w.scalar("train_loss", 1.0 / step, step)
        w.scalars({"spec": 1.0 / step, "time": 3.0 / step}, step, prefix="train_loss/")
        w.scalars({"spec": 2.0 / step}, step, prefix="test_loss/")
    w.close()
    return logdir


def test_metrics_readers_match_jax(metrics_jsonl):
    curves = tplot.read_metrics_jsonl(metrics_jsonl)
    assert curves == jplot.read_metrics_jsonl(metrics_jsonl)
    for prefix in ("test_loss/", "train_loss", "none/"):
        assert tplot.sum_curves_by_prefix(curves, prefix) == jplot.sum_curves_by_prefix(curves, prefix)
    assert tplot._load_curves(metrics_jsonl) == jplot._load_curves(metrics_jsonl)


def test_tb_event_readers_match_jax(tb_logdir):
    assert ttb.find_event_files(tb_logdir) == jtb.find_event_files(tb_logdir)
    tb = ttb.read_tb_scalars(tb_logdir)
    assert tb == jtb.read_tb_scalars(tb_logdir) and set(tb) >= {"train_loss", "test_loss/spec"}
    assert ttb.read_scalar_curves(tb_logdir) == jtb.read_scalar_curves(tb_logdir)  # prefers the jsonl
    for prefix, exact in (("train_loss/", True), ("train_loss", False), ("test_loss/", True)):
        assert ttb.accumulate_tags(tb, prefix, exact) == jtb.accumulate_tags(tb, prefix, exact)
    os.remove(os.path.join(tb_logdir, "metrics.jsonl"))
    assert ttb.read_scalar_curves(tb_logdir) == jtb.read_scalar_curves(tb_logdir)  # TB-only
    with pytest.raises(ValueError):
        ttb.read_scalar_curves(os.path.join(tb_logdir, "x.txt"))


@pytest.mark.parametrize("figure", ["prediction", "inference", "loss", "loss_epoch", "loss_and_doa", "doa_scatter"])
def test_figures_are_written_as_jax_writes_them(tmp_path, metrics_jsonl, tb_logdir, figure):
    rng = np.random.default_rng(0)
    F = 100
    pred = (rng.normal(size=F) + 1j * rng.normal(size=F)).astype(np.complex64)
    ori = (rng.normal(size=F) + 1j * rng.normal(size=F)).astype(np.complex64)
    x = rng.normal(size=500)
    draw = {
        "prediction": lambda m, p: m.plot_prediction_figure(
            pred, ori, np.fft.irfft(pred), np.fft.irfft(ori), np.asarray([1.0, 2.0, 1.0]),
            np.asarray([3.0, 1.0, 1.0]), "test", p),
        "inference": lambda m, p: m.plot_inference_figure(
            x, x * 0.9, {"Angle": 1.0, "Amplitude": 0.2, "Envelope": 0.1, "T60": 0.05, "C50": 1.2, "EDT": 0.02}, p),
        "loss": lambda m, p: m.plot_loss_curves(metrics_jsonl, p, prefixes=("train_loss", "test_loss/")),
        "loss_epoch": lambda m, p: m.plot_loss_by_epoch(tb_logdir, p),
        "loss_and_doa": lambda m, p: m.plot_loss_and_doa(metrics_jsonl, {20: 30.0, 40: 12.0, 60: 8.0}, p),
        "doa_scatter": lambda m, p: m.plot_doa_scatter(
            {"NormMUSIC": {"pred_vs_gt_error": [1.0, 2.0, None, 4.0]}, "SRP": {"pred_vs_gt_error": [None, None]}}, p),
    }[figure]
    for name, mod in (("jax", jplot), ("torch", tplot)):
        draw(mod, str(tmp_path / name / "img" / f"{figure}.png"))
    a, b = (tmp_path / n / "img" / f"{figure}.png" for n in ("jax", "torch"))
    assert os.path.getsize(b) > 10_000 and sorted(os.listdir(a.parent)) == sorted(os.listdir(b.parent))


def test_plot_loss_by_epoch_refuses_a_log_without_train_scalars(tmp_path, metrics_jsonl):
    for mod in (jplot, tplot):
        with pytest.raises(ValueError, match="no scalars"):
            mod.plot_loss_by_epoch(metrics_jsonl, str(tmp_path / "x.png"), train_prefix="absent/")


def test_config_variants_match_jax(tmp_path):
    base = {
        "path": {"expname": "Real_exp_param_1_1", "dataset_type": "Real_env", "logdir": "logs/"},
        "render": {"n_samples": 64, "fs": 16000},
        "train": {"lr": 1e-3, "batch_size": 4},
        "model": {"signal_output_dim": 1600, "signal_network": {"n_neurons": 512}},
    }
    sweep = {"train": {"lr": [1e-4, 1e-5]}, "render": {"n_samples": [32]},
             "model": {"signal_network": {"n_neurons": [256]}, "signal_output_dim": [800]}}
    written = {}
    for name, mod in (("jax", jct), ("torch", tct)):
        d = tmp_path / name / "real_exp"
        d.mkdir(parents=True)
        with open(d / "avr_real_exp_1.yml", "w") as f:
            yaml.safe_dump(base, f)
        written[name] = [os.path.relpath(p, tmp_path / name) for p in mod.generate_param_variants(str(d), sweep)]
    assert written["torch"] == written["jax"] and len(written["torch"]) == 5
    for rel in written["jax"] + ["real_exp/avr_real_exp_1.yml"]:
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    bad = tmp_path / "bad" / "x"
    bad.mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        tct.generate_param_variants(str(bad), sweep)


@pytest.mark.parametrize("facing,base", [(0.7, 2.0), (3.1, 0.0), (-1.2, 0.5)])
def test_wide_cardioid_beam_pattern_matches_jax(facing, base):
    import torch

    phi = np.linspace(0, 2 * np.pi, 73)
    want = np.asarray(jbeam(facing, phi, base))
    got = tbeam(facing, torch.tensor(phi, dtype=torch.float32), base)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got.max()) == 1.0
