"""The port's native npy/wav decoder (``fastload.cpp``), loaded with ctypes.

The same names as the JAX package's ``avr_tpu/native``: ``get_lib``,
``available``, ``load_npy_batch`` and ``load_wav_batch``, each loader
returning float32 ``[n, seq_len]``. Nothing happens at import. The first
call builds the library with g++ (``CXX_FLAGS``) into
``build/avr_torch_native/libavrfastload-<hash>.so`` at the repository root;
the hash covers the source, the flags and ``g++ --version``, so a library
built for another source, compiler or host (``-march=native``) is never
loaded. The build writes a temporary file and renames it, so processes that
build at the same moment never see a partial library.

With no ``g++`` on ``PATH`` there is no library: ``get_lib`` returns None
and ``available`` False, and the loaders of ``avr_torch.data`` decode the
plain way. A compiler that fails raises with its output. A batch the
decoder cannot take raises ``Rejected``, naming the first such file and
why. ``COUNTS`` holds the calls, the files decoded and the batches
rejected; ``reset_counts`` sets them to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "fastload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "avr_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

# calls of the batch loaders, files they decoded, batches they rejected
COUNTS = {"calls": 0, "files": 0, "rejected": 0}

# fastload.cpp's Status codes → why a file does not decode
_REASONS = {
    "npy": {
        1: "the file cannot be opened",
        2: "not a .npy file",
        3: "dtype is not little-endian float32 or float64",
        4: "array is in Fortran order",
        5: "truncated or malformed .npy file",
    },
    "wav": {
        1: "the file cannot be opened",
        2: "not a RIFF/WAVE file",
        3: "sample format is not PCM 8/16/24/32-bit or IEEE float 32/64",
        5: "truncated file, or a fmt or data chunk missing or malformed",
    },
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class Rejected(IOError):
    """The decoder could not take a batch: ``path`` is its first file that
    does not decode, ``reason`` says why."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"native decoder rejected {path}: {reason}")
        self.path, self.reason = path, reason


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def compiler() -> Optional[str]:
    """The g++ on PATH, or None."""
    return shutil.which("g++")


def compiler_version(cxx: str) -> str:
    return subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60, check=True).stdout


def lib_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` from this source lives."""
    key = SRC.read_bytes() + " ".join(CXX_FLAGS).encode() + compiler_version(cxx).encode()
    return BUILD_DIR / f"libavrfastload-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC), "-lpthread"],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC} (exit {r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        Path(tmp).unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when there is no g++."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        cxx = compiler()
        if cxx is None:
            return None
        path = lib_path(cxx)
        if not path.exists():
            _build(cxx, path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load the native decoder {path}: {e}") from e
        paths_t, f32p, i64 = ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        lib.avr_load_npy_batch.argtypes = [paths_t, ctypes.c_int, f32p, i64, i64, i64]
        lib.avr_load_wav_batch.argtypes = [paths_t, ctypes.c_int, f32p, i64, i64]
        lib.avr_npy_status.argtypes = lib.avr_wav_status.argtypes = [ctypes.c_char_p]
        lib.avr_fastload_version.argtypes = []
        for fn in (lib.avr_load_npy_batch, lib.avr_load_wav_batch, lib.avr_npy_status, lib.avr_wav_status,
                   lib.avr_fastload_version):
            fn.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the decoder runs here: False when there is no g++; raises
    when g++ is there and the build or the load fails."""
    return get_lib() is not None


def _run(kind: str, paths: List[str], seq_len: int, stride: int, start: int, call) -> np.ndarray:
    if seq_len < 0 or stride < 1 or start < 0:
        raise ValueError(f"need seq_len >= 0, stride >= 1 and start >= 0, got {seq_len}, {stride}, {start}")
    lib = get_lib()
    if lib is None:
        raise RuntimeError("no g++ on PATH: the native decoder cannot be built")
    out = np.empty((len(paths), seq_len), np.float32)
    encoded = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * len(paths))(*encoded)
    COUNTS["calls"] += 1
    rc = call(lib, arr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        COUNTS["rejected"] += 1
        bad = paths[-rc - 1]
        status = getattr(lib, f"avr_{kind}_status")(os.fsencode(bad))
        raise Rejected(bad, _REASONS[kind].get(status, f"status {status}"))
    COUNTS["files"] += len(paths)
    return out


def load_npy_batch(paths: List[str], seq_len: int, stride: int = 1, start: int = 0) -> np.ndarray:
    """Decode .npy IR files → float32 [n, seq_len]: row 0 of each array,
    every ``stride``-th sample from index ``start`` of the strided row (the
    MeshRIR loader's window), zero-padded."""
    return _run("npy", paths, seq_len, stride, start,
                lambda lib, arr, out: lib.avr_load_npy_batch(arr, len(paths), out, seq_len, stride, start))


def load_wav_batch(paths: List[str], seq_len: int, stride: int = 1) -> np.ndarray:
    """Decode WAV files → float32 [n, seq_len]: downmixed to mono, every
    ``stride``-th sample, zero-padded."""
    return _run("wav", paths, seq_len, stride, 0,
                lambda lib, arr, out: lib.avr_load_wav_batch(arr, len(paths), out, seq_len, stride))
