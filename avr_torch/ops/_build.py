"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/avr_torch_kernels/lib<name>-<hash>.so`` at the repository root.
The hash covers the source text, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header builds anew and an unchanged one
loads from the cache. Nothing here runs at
import: the first wrapper call on a CUDA tensor builds and loads its
library. ``build_all`` starts one nvcc per source, all at once.
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
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "avr_torch_kernels"
SOURCES = ("hash_scatter", "hashgrid_encode", "hashgrid_encode_bwd", "signal_contract", "mlp_act")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register/spill report of the last build of each source
PTXAS_REPORT: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build avr_torch kernels")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (popen, tmp_out, final_path) or None if cached."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    PTXAS_REPORT[name] = log
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file


def build_all() -> List[str]:
    """Build every kernel source in parallel (one nvcc each). Returns the
    names that were compiled (cached ones are skipped)."""
    jobs = {n: _start(n) for n in SOURCES}
    built = []
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
            built.append(n)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
