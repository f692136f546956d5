"""Table-gradient scatter-add (kernel A) and its plain version.

Port of ``avr_tpu/ops/hash_scatter.py:scatter_add_rows`` (:114), whose TPU
implementation is the Pallas ``_tile_kernel`` (:872). The encode's own
backward (``hashgrid_encode.encode_backward``) computes the table gradient
of the training path without an update stream; this generic scatter and
its plain version, which that backward's plain version uses, stay. The sort
and tile schedule around that kernel exists only because the TPU has no
atomics and is not ported. The Hopper kernel (``csrc/hash_scatter.cu``)
makes one pass over the stream in chunks of 2048 rows: it folds runs of
equal adjacent indices in registers and across the warp; where the grid is
more than one wave, it sums a chunk whose span of rows fits a shared-memory
slab there and flushes one vector RED per touched row; every other folded
run is one vector RED. ``kernel_layout`` reads those sizes from the built
kernel.

A CPU tensor goes to :func:`scatter_add_rows_reference` (``index_add_``);
a CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from avr_torch.ops import _build

_FEATURE_WIDTHS = (1, 2, 4)


def scatter_add_rows_reference(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[r] = Σ_{i: idx[i]=r} upd[i], as ``zeros(...).index_add_``.

    Rows whose index lies outside [0, n_rows) are dropped, as the kernel
    drops them: they go to a spare row past the end that is not returned.
    """
    F = upd.shape[-1]
    idx = idx.reshape(-1).long()
    idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = torch.zeros((n_rows + 1, F), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx, upd.reshape(-1, F).to(torch.float32))[:n_rows]


def _lib():
    lib = _build.load("hash_scatter")
    fn = lib.avr_scatter_add_rows
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def kernel_layout(F: int) -> dict:
    """The built kernel's layout for feature width F on the current CUDA
    device (builds the library): stream rows per block (``chunk_rows``),
    rows of the shared-memory slab (``slab_rows``), and the blocks with the
    slab the device holds at once (``resident_blocks``); a launch of more
    blocks than that uses the slab."""
    if F not in _FEATURE_WIDTHS:
        raise ValueError(f"kernel_layout: feature width {F} not in {_FEATURE_WIDTHS}")
    fn = _build.load("hash_scatter").avr_scatter_add_rows_layout
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int
    vals = (ctypes.c_longlong * 3)()
    rc = fn(F, vals)
    if rc != 0:
        raise RuntimeError(f"kernel_layout: CUDA error {rc}")
    return dict(zip(("chunk_rows", "slab_rows", "resident_blocks"), vals))


def scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Sum update rows into bins: out[r] = Σ_{i: idx[i]=r} upd[i].

    idx: int32 [M]; upd: float32 [M, F], F ∈ {1, 2, 4}, contiguous, rows
    aligned to their width. Returns float32 [n_rows, F]. Rows whose index
    lies outside [0, n_rows) are dropped on both paths (JAX's scatter drops
    those past the end too). On the card the sum order changes from run to
    run (atomics).
    """
    if idx.device != upd.device:
        raise ValueError(
            f"scatter_add_rows: idx on {idx.device} and upd on {upd.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if idx.dtype != torch.int32 or upd.dtype != torch.float32:
        raise TypeError(
            f"scatter_add_rows: need int32 idx and float32 upd, got {idx.dtype} / {upd.dtype}"
        )
    if upd.dim() != 2 or idx.dim() != 1 or idx.shape[0] != upd.shape[0]:
        raise ValueError(
            f"scatter_add_rows: need idx [M] and upd [M, F], got {tuple(idx.shape)} / {tuple(upd.shape)}"
        )
    F = upd.shape[1]
    if F not in _FEATURE_WIDTHS:
        raise ValueError(f"scatter_add_rows: feature width {F} not in {_FEATURE_WIDTHS}")
    if not (idx.is_contiguous() and upd.is_contiguous()):
        raise ValueError("scatter_add_rows: idx and upd must be contiguous")
    if upd.data_ptr() % (4 * F):
        raise ValueError("scatter_add_rows: upd rows must be aligned to their width")
    if upd.device.type == "cpu":
        return scatter_add_rows_reference(idx, upd, n_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: tensors on {upd.device}; need a CUDA device or the CPU")
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=upd.device)
    stream = torch.cuda.current_stream(upd.device).cuda_stream
    rc = _lib()(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), idx.shape[0], n_rows, F, stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add_rows: kernel launch failed with CUDA error {rc}")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
