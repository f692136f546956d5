"""avr_torch's data pipeline against the JAX package's (numpy on both
sides, so every comparison is exact): the synthetic dataset writers, the
loaders of the four reference formats, and the batch sampler."""

import os
import pickle

import numpy as np
import pytest

from avr_tpu.data import loaders as jloaders
from avr_tpu.data import sampler as jsampler
from avr_tpu.data import synthetic as jsynth
from avr_tpu.geometry import quaternion_to_direction as jquat

from avr_torch import geometry as tgeo
from avr_torch.data import loaders as tloaders
from avr_torch.data import sampler as tsampler
from avr_torch.data import synthetic as tsynth

ROOM = dict(size=(4.0, 3.5, 2.5), max_order=1, seq_len=256)

# writer name → (arguments after the room, format its output loads as)
WRITERS = {
    "write_simu_dataset": (dict(n=12, seed=1), "Simu"),
    "write_real_env_dataset": (dict(n_groups=5, seed=2), "Real_env"),
    "write_meshrir_dataset": (dict(n=10, seed=3), "MeshRIR"),
    "write_raf_dataset": (dict(n=8, seed=4), "RAF"),
    "write_raf_array_dataset": (dict(n_train=5, n_test_groups=1, seed=5), "RAF"),
}


def _write(pkg, name, out):
    kw, _ = WRITERS[name]
    getattr(pkg, name)(str(out), pkg.RoomSpec(**ROOM), **kw)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _assert_same_file(a, b):
    if a.endswith(".npy"):
        x, y = np.load(a), np.load(b)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    elif a.endswith(".npz"):
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
    elif a.endswith(".pkl"):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert pickle.load(fa) == pickle.load(fb)
    else:  # .wav, .txt
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_synthetic_writers_match_jax(tmp_path, name):
    a = _write(jsynth, name, tmp_path / "jax")
    b = _write(tsynth, name, tmp_path / "torch")
    files = _files(a)
    assert files and files == _files(b)
    for f in files:
        _assert_same_file(os.path.join(a, f), os.path.join(b, f))


def _assert_same_dataset(x, y):
    for f in ("wave", "pos_rx", "pos_tx", "rot_tx", "ch_idx"):
        a, b = getattr(x, f), getattr(y, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (x.dataset_type, x.fs, x.seq_len) == (y.dataset_type, y.fs, y.seq_len)


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_load_dataset_matches_jax(tmp_path, name):
    root = str(_write(jsynth, name, tmp_path / "data"))
    fmt = WRITERS[name][1]
    for split in (False, True):
        j = jloaders.load_dataset(root, fmt, eval=split, seq_len=200, fs=16000)
        t = tloaders.load_dataset(root, fmt, eval=split, seq_len=200, fs=16000)
        assert len(t) > 0
        _assert_same_dataset(t, j)
    if fmt == "Real_env":
        assert t.ch_idx.dtype == np.int32


def test_quaternion_to_direction_matches_jax():
    rng = np.random.default_rng(0)
    for q in [[0.0, 0.0, 0.0, 1.0], *rng.normal(size=(5, 4))]:
        assert tgeo.quaternion_to_direction(q) == jquat(q)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("write_simu_dataset", dict(batch_size=3)),
        ("write_simu_dataset", dict(batch_size=4, shuffle=False, drop_last=False)),
        ("write_real_env_dataset", dict(batch_size=8, group8=True)),
        ("write_real_env_dataset", dict(batch_size=16, group8=True, seed=7)),
        ("write_raf_dataset", dict(batch_size=2, jitter=True, seed=3)),
    ],
    ids=["shuffled", "ordered", "group8", "group8_16", "raf_jitter"],
)
def test_batch_sampler_matches_jax(tmp_path, name, kw):
    root = str(_write(jsynth, name, tmp_path / "data"))
    fmt = WRITERS[name][1]
    data = jloaders.load_dataset(root, fmt, seq_len=200)
    js = jsampler.BatchSampler(data, **kw)
    ts = tsampler.BatchSampler(tloaders.load_dataset(root, fmt, seq_len=200), **kw)
    assert len(ts) == len(js) > 0
    for _ in range(2):  # two epochs: the generator's state carries over
        jb, tb = list(js.epoch()), list(ts.epoch())
        assert len(tb) == len(jb) > 0
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if kw.get("group8"):
        np.testing.assert_array_equal(tb[0]["ch_idx"], np.tile(np.arange(8), kw["batch_size"] // 8))


def test_group8_refuses_partial_groups(tmp_path):
    root = str(_write(tsynth, "write_real_env_dataset", tmp_path / "data"))
    data = tloaders.load_dataset(root, "Real_env", seq_len=200)
    with pytest.raises(ValueError, match="batch_size"):
        tsampler.BatchSampler(data, batch_size=4, group8=True)
