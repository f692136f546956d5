"""The port's report aggregators (``avr_torch/eval/aggregators.py``) against
``avr_tpu/eval/aggregators.py`` on tests/test_aggregators.py's inputs:
equal DataFrames and returns, and the same files (CSV and pickle contents
equal; figures by name)."""

import json
import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest
import yaml

from avr_tpu.eval import aggregators as jagg
from avr_tpu.hpo.study import create_study as jcreate_study
from test_aggregators import _fake_condition
from test_doa import _fake_npz
from test_plotting_tools import _fake_doa_pkls

from avr_torch.eval import aggregators as tagg
from avr_torch.hpo.study import create_study as tcreate_study


def _same_tree(a, b):
    """The same relative file names under a and b, CSV and pickle contents
    equal (TensorBoard event files, named by time and host, left out)."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
                      if "tfevents" not in f)

    names = files(a)
    assert names and names == files(b)
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".csv"):
            assert open(pa).read() == open(pb).read(), n
        elif n.endswith(".pkl"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                np.testing.assert_equal(pickle.load(fa), pickle.load(fb), err_msg=n)


@pytest.fixture
def conditions(tmp_path):
    """Two condition pickles, one a level deeper, as results trees."""
    root = tmp_path / "conds"
    root.mkdir()
    _fake_condition(root, "results_a.pkl")
    (root / "deeper").mkdir()
    _fake_condition(root / "deeper", "results_b.pkl")
    return root


def test_frame_error_table_and_figures_match_jax(tmp_path, conditions):
    p = str(conditions / "results_a.pkl")
    pd.testing.assert_frame_equal(tagg.frame_error_table(p), jagg.frame_error_table(p))
    for name, mod in (("jax", jagg), ("torch", tagg)):
        mod.plot_frame_errors([p, str(conditions / "deeper" / "results_b.pkl")], str(tmp_path / name / "frames.png"))
        mod.plot_frame_scatter(p, str(tmp_path / name / "scatter.png"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_circular_median_and_waveform_level_summaries_match_jax(tmp_path, conditions):
    for name, mod in (("jax", jagg), ("torch", tagg)):
        d = tmp_path / name
        shutil.copytree(conditions, d)
        df = mod.circular_median_summary(str(d))
        wl = mod.waveform_level_summary(str(d), str(d / "wl"))
        if name == "jax":
            want = (df, wl)
        else:
            pd.testing.assert_frame_equal(df, want[0])
            pd.testing.assert_frame_equal(wl, want[1])
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_compare_stft_conditions_matches_jax(tmp_path):
    npz = _fake_npz(tmp_path, [60.0, 300.0])
    kw = dict(n_ffts=(256, 512), hops=(None, 64), wins=("hann", "none"))
    jdf = jagg.compare_stft_conditions([npz], save_csv=str(tmp_path / "jax" / "stft.csv"), **kw)
    tdf = tagg.compare_stft_conditions([npz], save_csv=str(tmp_path / "torch" / "stft.csv"), **kw)
    pd.testing.assert_frame_equal(tdf, jdf)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_study_report_matches_jax(tmp_path):
    """The port's Study against JAX's, seeded alike: the same trials, the
    same report."""
    reps = {}
    for name, create, mod in (("jax", jcreate_study, jagg), ("torch", tcreate_study, tagg)):
        study = create("rep", seed=0)
        study.optimize(lambda t: (t.suggest_float("x", -2, 2) - 0.5) ** 2, n_trials=15)
        reps[name] = mod.study_report(study, str(tmp_path / name / "study.png"))
    assert reps["torch"] == reps["jax"] and reps["torch"]["n_trials"] == 15
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_band_response_and_rotate_figures_match_jax(tmp_path):
    npz = _fake_npz(tmp_path, [100.0])
    rot = str(tmp_path / "val_rotate_pred.npz")
    np.savez(rot, pred_deg=np.asarray([10, 50, 100], np.int16), true_deg=np.asarray([12, 48, 95], np.int16),
             deg_step=np.float32(30.0))
    for name, mod in (("jax", jagg), ("torch", tagg)):
        mod.plot_band_response(npz, str(tmp_path / name / "band.png"))
        mod.plot_rotate_results(rot, str(tmp_path / name / "rotate.png"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


@pytest.mark.parametrize("kind,method", [("doa", "NormMUSIC"), ("das", ["NormDAS_soft-argmax", "NormDAS_argmax"])])
def test_detail_scatters_match_jax(tmp_path, kind, method):
    sub = "doa_results" if kind == "doa" else "beamform_results"
    for name, mod in (("jax", jagg), ("torch", tagg)):
        logdir = str(tmp_path / name)
        _fake_doa_pkls(os.path.join(logdir, sub), method, {1000: 40.0, 2000: 10.0, 3000: 25.0})
        fn = mod.plot_doa_detail_scatter if kind == "doa" else mod.plot_das_detail_scatter
        assert fn(logdir) == os.path.join(logdir, f"{kind}_detail_scatter.png")
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_experiment_report_matches_jax(tmp_path):
    """The config-driven report over two checkpoints' npz dumps: the same
    {iteration: error}, the same cached DoA pickles, and a rerun reuses
    them."""
    src = _fake_npz(tmp_path, [45.0, 120.0])
    got = {}
    for name, mod in (("jax", jagg), ("torch", tagg)):
        base = tmp_path / name / "logs" / "exp1"
        (base / "val_result").mkdir(parents=True)
        for it in (100, 200):
            shutil.copy(src, base / "val_result" / f"val_iter{it:06d}.npz")
        with open(base / "metrics.jsonl", "w") as f:
            for step in (100, 200):
                f.write(json.dumps({"tag": "train_loss", "value": 1.0 / step, "step": step}) + "\n")
        cfg = {"path": {"expname": "exp1", "logdir": str(tmp_path / name / "logs"), "dataset_type": "Real_env"},
               "render": {"fs": 16000}, "train": {}, "model": {}}
        conf = str(tmp_path / name / "conf.yml")
        with open(conf, "w") as f:
            yaml.safe_dump(cfg, f)
        got[name] = mod.experiment_report(conf, save_path=str(tmp_path / name / "report.png"))
        assert mod.experiment_report(conf, save_path=str(tmp_path / name / "report.png")) == got[name]
    assert got["torch"] == got["jax"] and set(got["torch"]) == {100, 200}
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
