"""The port's native npy/wav decoder (``avr_torch.native``) and the loaders
that call it, against the JAX package (``avr_tpu.native``,
``avr_tpu.data.wav.read_wav``, ``avr_tpu.data.loaders``) and the port's
plain numpy decode, on the same seeded files.

Tolerances: every mono decode is bit-equal (both sides round the decoded
double to float32 once). A multi-channel WAV is downmixed by the decoder
as a double sum (as JAX's decoder does) and by numpy as a float32 mean:
held within rtol 1e-6, or one float32 ulp of full scale (2^-23) where the
channels cancel. Tests that need the library skip where there is no g++;
the plain decode and the no-compiler route run everywhere.
"""

import ctypes
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from avr_tpu import native as jnative
from avr_tpu.data import loaders as jloaders
from avr_tpu.data import wav as jwav

from avr_torch import native
from avr_torch.data import loaders as tloaders
from avr_torch.data import synthetic as tsynth
from avr_torch.data import wav as twav

ROOT = Path(__file__).resolve().parents[1]
DOWNMIX = dict(rtol=1e-6, atol=2.0**-23)
ROOM = dict(size=(4.0, 3.5, 2.5), max_order=1, fs=16000, seq_len=300)


@pytest.fixture
def lib():
    if native.compiler() is None:
        pytest.skip("no g++ on PATH: the native decoder cannot be built here")
    return native.get_lib()


@pytest.fixture
def counts():
    native.reset_counts()
    yield native.COUNTS
    native.reset_counts()


# (sample format, channels, extensible, odd-sized chunk before data)
WAVS = [
    *[(f, 1, False, False) for f in twav.SAMPLE_FORMATS],
    *[(f, 2, False, False) for f in twav.SAMPLE_FORMATS],
    *[(f, 1, True, False) for f in ("pcm16", "pcm24", "float32", "float64")],
    ("pcm32", 3, True, False),
    ("pcm16", 1, False, True),
    ("float32", 2, True, True),
    ("pcm8", 1, False, True),
]
WAV_IDS = [f"{f}-{c}ch{'-ext' if e else ''}{'-oddchunk' if o else ''}" for f, c, e, o in WAVS]


def _write_wav(tmp_path, case, seed=0, n=700):
    fmt, ch, ext, odd = case
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.95, 0.95, (n, ch) if ch > 1 else n)
    p = str(tmp_path / f"{fmt}_{ch}_{int(ext)}_{int(odd)}_{seed}.wav")
    twav.write_wav_as(p, x, 48000, fmt, extensible=ext, chunks_before_data=[(b"LIST", b"abc")] if odd else ())
    return p


def _read_wav_window(p, seq_len, stride):
    """JAX's plain decode of one file: read_wav, strided, zero-padded."""
    a = jwav.read_wav(p)[0][: seq_len * stride : stride]
    return np.pad(a, (0, seq_len - len(a)))


@pytest.mark.parametrize("case", WAVS, ids=WAV_IDS)
def test_plain_wav_decode_matches_jax_read_wav(tmp_path, case):
    paths = [_write_wav(tmp_path, case, seed=s) for s in range(3)]
    for seq_len, stride in ((150, 3), (400, 2)):  # the second runs past the end: zero tail
        ref = np.stack([_read_wav_window(p, seq_len, stride) for p in paths])
        np.testing.assert_array_equal(tloaders._decode_wav_plain(paths, seq_len, stride), ref)


@pytest.mark.parametrize("case", WAVS, ids=WAV_IDS)
def test_native_wav_matches_plain_and_jax(tmp_path, lib, counts, case):
    paths = [_write_wav(tmp_path, case, seed=s) for s in range(3)]
    fmt, ch, _, odd = case
    for seq_len, stride in ((150, 3), (400, 2)):
        got = native.load_wav_batch(paths, seq_len, stride)
        plain = tloaders._decode_wav_plain(paths, seq_len, stride)
        assert got.dtype == np.float32 and got.shape == (3, seq_len)
        if ch == 1:
            np.testing.assert_array_equal(got, plain)
        else:
            np.testing.assert_allclose(got, plain, **DOWNMIX)
        if not jnative.available():
            continue
        if odd or fmt == "pcm8":  # the two faults of JAX's decoder, repaired here
            with pytest.raises(IOError):
                jnative.load_wav_batch(paths, seq_len, stride)
        else:
            np.testing.assert_array_equal(got, jnative.load_wav_batch(paths, seq_len, stride))
    assert counts == {"calls": 2, "files": 6, "rejected": 0}


@pytest.mark.parametrize("dtype", ["<f4", "<f8"])
def test_native_npy_matches_plain_and_jax(tmp_path, lib, counts, dtype):
    rng = np.random.default_rng(1)
    paths = []
    for i, n in enumerate((600, 611, 90)):  # the last one ends inside the window
        p = str(tmp_path / f"ir_{i}.npy")
        np.save(p, rng.normal(size=(1, n)).astype(dtype))
        paths.append(p)
    for seq_len, stride, start in ((50, 2, 5), (120, 3, 40), (64, 1, 0)):
        got = native.load_npy_batch(paths, seq_len, stride, start)
        ref = np.stack([
            np.pad(w, (0, seq_len - len(w)))
            for w in (np.load(p)[0, ::stride][start : start + seq_len].astype(np.float32) for p in paths)
        ])
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, tloaders._decode_npy_plain(paths, seq_len, stride, start))
        if jnative.available():
            np.testing.assert_array_equal(got, jnative.load_npy_batch(paths, seq_len, stride, start))
    assert counts == {"calls": 3, "files": 9, "rejected": 0}


def test_error_index_and_reason(tmp_path, lib, counts):
    """The C ABI returns -(i + 1) for the first failing file i; Rejected
    names that file and why."""
    good = str(tmp_path / "good.npy")
    np.save(good, np.ones((1, 20), np.float32))
    bad = {
        "missing": (str(tmp_path / "nope.npy"), "cannot be opened"),
        "int16": (str(tmp_path / "i2.npy"), "dtype"),
        "fortran": (str(tmp_path / "f.npy"), "Fortran"),
        "truncated": (str(tmp_path / "t.npy"), "truncated"),
        "not_npy": (str(tmp_path / "x.npy"), "not a .npy"),
    }
    np.save(bad["int16"][0], np.ones((1, 20), np.int16))
    np.save(bad["fortran"][0], np.asfortranarray(np.ones((2, 20), np.float32)))
    with open(good, "rb") as f:
        head = f.read()
    with open(bad["truncated"][0], "wb") as f:
        f.write(head[:-7])
    with open(bad["not_npy"][0], "wb") as f:
        f.write(b"hello world, not an array")
    for k, (path, why) in enumerate(bad.values()):
        for i in (0, 3):
            paths = [good] * 5
            paths[i] = path
            if i == 0:
                paths[4] = path  # two failing files: the first one is reported
            arr = (ctypes.c_char_p * 5)(*[os.fsencode(p) for p in paths])
            out = np.empty((5, 8), np.float32)
            rc = lib.avr_load_npy_batch(arr, 5, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 8, 1, 0)
            assert rc == -(i + 1)
            with pytest.raises(native.Rejected, match=why) as e:
                native.load_npy_batch(paths, 8)
            assert e.value.path == path
    assert counts["rejected"] == 2 * len(bad) and counts["files"] == 0
    wavs = [_write_wav(tmp_path, ("pcm16", 1, False, False)), bad["not_npy"][0]]
    with pytest.raises(native.Rejected, match="not a RIFF/WAVE") as e:
        native.load_wav_batch(wavs, 8)
    assert e.value.path == wavs[1]


def test_bad_window_raises_before_the_call(tmp_path, lib, counts):
    p = str(tmp_path / "ir.npy")
    np.save(p, np.ones((1, 20), np.float32))
    for kw in (dict(stride=0), dict(start=-1), dict(seq_len=-1)):
        args = {**dict(seq_len=8, stride=1, start=0), **kw}
        with pytest.raises(ValueError, match="stride >= 1"):
            native.load_npy_batch([p], **args)
    with pytest.raises(ValueError, match="stride >= 1"):
        native.load_wav_batch([p], 8, stride=0)
    empty = str(tmp_path / "empty.npy")
    np.save(empty, np.ones((0, 20), np.float32))  # no row 0: rejected, not read past its end
    with pytest.raises(native.Rejected):
        native.load_npy_batch([empty], 8)
    assert counts == {"calls": 1, "files": 0, "rejected": 1}


def test_library_builds_under_build_not_avr_tpu(lib):
    path = Path(lib._name).resolve()
    assert path == native.lib_path(native.compiler()).resolve()
    assert path.parent == ROOT / "build" / "avr_torch_native"
    assert path.name.startswith("libavrfastload-") and "avr_tpu" not in str(path)
    assert lib.avr_fastload_version() == 1


def test_import_builds_nothing():
    code = (
        "import subprocess\n"
        "def refuse(*a, **k): raise AssertionError('a process was started at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import avr_torch.native as n, avr_torch.data.loaders, avr_torch.train.runner\n"
        "assert n._LIB is None and n.COUNTS == {'calls': 0, 'files': 0, 'rejected': 0}\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _write_sets(tmp_path):
    mesh, raf = str(tmp_path / "mesh"), str(tmp_path / "raf")
    tsynth.write_meshrir_dataset(mesh, tsynth.RoomSpec(**ROOM), n=10, seed=3)
    tsynth.write_raf_dataset(raf, tsynth.RoomSpec(**ROOM), n=8, seed=4)
    return (mesh, "MeshRIR"), (raf, "RAF")


def _assert_same_dataset(x, y):
    for f in ("wave", "pos_rx", "pos_tx", "rot_tx", "ch_idx"):
        a, b = getattr(x, f), getattr(y, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_load_dataset_native_matches_jax(tmp_path, lib, counts):
    for root, fmt in _write_sets(tmp_path):
        for split in (False, True):
            native.reset_counts()
            t = tloaders.load_dataset(root, fmt, eval=split, seq_len=256, fs=16000)
            assert counts == {"calls": 1, "files": len(t), "rejected": 0}
            _assert_same_dataset(t, jloaders.load_dataset(root, fmt, eval=split, seq_len=256, fs=16000))


def test_no_compiler_takes_the_plain_decode_and_warns_once(tmp_path, monkeypatch, caplog, counts):
    sets = _write_sets(tmp_path)
    refs = [jloaders.load_dataset(root, fmt, seq_len=256, fs=16000) for root, fmt in sets]
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(tloaders, "_warned_no_compiler", False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert native.compiler() is None and not native.available()
    with caplog.at_level(logging.WARNING, logger=tloaders.__name__):
        for _ in range(2):
            for (root, fmt), ref in zip(sets, refs):
                _assert_same_dataset(tloaders.load_dataset(root, fmt, seq_len=256, fs=16000), ref)
    warned = [r for r in caplog.records if "no g++" in r.getMessage()]
    assert len(warned) == 1
    assert counts == {"calls": 0, "files": 0, "rejected": 0}


def test_rejected_batch_is_decoded_plain_warned_and_counted(tmp_path, lib, counts, caplog):
    (mesh, _), (raf, _) = _write_sets(tmp_path)
    name = sorted(os.listdir(os.path.join(mesh, "train")))[2]
    bad = os.path.join(mesh, "train", name)
    np.save(bad, (np.load(bad) * 3e4).astype("<i2"))  # int16: the decoder takes float only
    ref = jloaders.load_dataset(mesh, "MeshRIR", seq_len=256, fs=16000)
    with caplog.at_level(logging.WARNING, logger=tloaders.__name__):
        got = tloaders.load_dataset(mesh, "MeshRIR", seq_len=256, fs=16000)
    _assert_same_dataset(got, ref)
    assert np.abs(got.wave[2]).max() > 0
    assert counts == {"calls": 1, "files": 0, "rejected": 1}
    msgs = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(msgs) == 1 and bad in msgs[0] and "dtype" in msgs[0]
    # a file that neither decode takes raises the plain decode's error, as in JAX
    wav = sorted(Path(raf, "train").glob("*/rir.wav"))[1]
    wav.write_bytes(b"RIFX" + wav.read_bytes()[4:])
    with pytest.raises(ValueError, match="RIFF/WAVE") as e:
        tloaders.load_dataset(raf, "RAF", seq_len=256, fs=16000)
    with pytest.raises(ValueError, match="RIFF/WAVE") as j:
        jloaders.load_dataset(raf, "RAF", seq_len=256, fs=16000)
    assert str(e.value) == str(j.value)
    assert counts["rejected"] == 2


def test_compiler_failure_raises_with_its_output(tmp_path, monkeypatch):
    """A g++ that fails raises with what it printed; nothing is loaded."""
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\nif [ \"$1\" = --version ]; then echo 'fake g++ 0'; exit 0; fi\n"
                    "echo 'fastload.cpp:1: error: no compiler here' >&2; exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.available()
    assert native._LIB is None and not list((tmp_path / "build").glob("*.so"))
