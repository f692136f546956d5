#!/usr/bin/env python3
"""On-card smoke test of the avr_torch port (NVIDIA H100).

    python3 chip_smoke.py [--profile DIR] [--kernel-a-earlier SOURCE]

Builds the port's CUDA kernels from ``avr_torch/ops/csrc`` (nvcc, cached
in ``build/avr_torch_kernels/``) and drives six paths of the port, each
at full width with random weights from a seed:

  * the flagship training step (complex field, ``avr_torch/flagship.py``):
    3 steps, 5 + 5 encode launches per step;
  * the 8-channel array training step of ``configs/avr_synthetic_array.yml``
    (standard field with channel embeddings and DAS losses) on a synthetic
    Real_env dataset that the port writes, loads and samples, with the
    precomputed plan (``train_array``: 3 steps, 3 + 3 launches per step) and
    once with the streaming plan (1 step, 34 + 18);
  * the same recipe through the training runner and the CLI
    (``runner_array``): ``AVRRunner.train`` for 4 iterations with
    checkpoints and validations every 2 (3 + 3 launches per iteration,
    3 + 0 per validation batch), a bit-equal resume on the card and a
    restore on the CPU, ``python -m avr_torch render`` from the checkpoint
    (bit-equal to ``make_render_fn``) and ``rotate`` at 90° steps;
  * population training of the same recipe (``population_array``): 4
    runtime-variant HPO trials (the known-good seed trial and 3 asked) per
    step, 3 steps with 3 + 3 launches of the K-batched encode kernels per
    step, each trial held against a single-trial step of its own; then
    ``python -m avr_torch hpo --pop 4 --variant runtime`` with the iteration
    budget cut to 2, which tells 4 trials;
  * the flagship RAF recipe through the runner on decoded data
    (``runner_flagship``): after ``native_decode`` builds the port's g++
    npy/wav decoder (``avr_torch/native``) and holds it against the plain
    numpy decode on every WAV layout and on RAF and MeshRIR sets of 4096
    and 1024 files (timed against it), ``AVRRunner`` loads a port-written
    RAF set of 80 samples through the decoder (80 files, 0 rejected
    batches, bit-equal to the plain decode) and trains 4 iterations with
    checkpoints and validations every 2 (5 + 5 encode launches per
    iteration, 5 + 0 per validation batch), resumes bit-equal on the card
    and renders from the checkpoint through ``python -m avr_torch render``;
  * multi-device training of the same recipe (``parallel_array``): the
    data × ray plan on gloo ranks that share the card, spawned with
    torchrun's environment and joined through ``initialize_multihost`` into
    ``AVRRunner(..., mesh_plan=)``, 4 ranks as data 2 × ray 2 and 3 ranks
    as ray 3 (2050 rays padded to 2052), 2 steps each with a checkpoint
    after each, 3 + 3 encode launches per rank per step, held against
    single-process steps (losses, the summed gradient's norm, updates);
    each rank's encode calls held against the plain versions at its
    shapes; prints each rank's step, all-reduce time and bytes and peak
    memory.

Before each path it holds each kernel against its plain PyTorch version
at that path's shapes and checks the card against the plain CPU path on a
small config of the same field variant; after it, it shows that the path
went through the encode forward and backward kernels (the generic scatter
kernel is held and timed, but is off every path: ``kernel_a_scatter`` holds
it on boundary streams in a grid of one wave and in one past it, F = 1, 2,
4, and at the flagship and array streams prints its runs, its share of rows
summed in shared memory, its global REDs and its time split into dense
levels, hashed levels and zero fill; ``--kernel-a-earlier SOURCE`` times
kernel A built from an earlier commit's source beside it). Prints one JSON
object per phase, the ``nvidia-smi`` name/power line, a ``kernels`` summary, and
as its last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the exit code is non-zero. Without a CUDA device it exits with 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# Card peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s and fp32
# (non-tensor-core) operations/s. The bound of a kernel is the larger of
# bytes/HBM rate and operations/peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Train steps driven on the card per path; the first one is not steady.
TRAIN_STEPS = 3
# Iterations of the runner on the array recipe (checkpoints and
# validations every 2), and timed render calls after it.
RUNNER_ITERATIONS = 4
RENDER_REPEATS = 5
# RAF samples of the flagship runner's set (the last 20% are the test split)
FLAGSHIP_RAF_FILES = 80
# the native decoder's timing sets, and the timed runs of each decode
NATIVE_RAF_FILES = 4096
NATIVE_MESHRIR_FILES = 1024
DECODE_REPEATS = 3

ROOT = os.path.dirname(os.path.abspath(__file__))
ARRAY_CONFIG = os.path.join(ROOT, "configs", "avr_synthetic_array.yml")
# synthetic Real_env groups written for the array path: the last one is
# the test split, leaving 4 train groups = 32 rows
ARRAY_GROUPS = 5
# shell chunk of the array step's streaming run
STREAMING_SHELL_CHUNK = 8
# runs of the parallel_array phase (name, ranks, data axis) and their steps
PARALLEL_RUNS = (("data2_ray2", 4, 2), ("ray3", 3, 1))
PARALLEL_STEPS = 2
# trials per population step, and the known-good seed trial of the array
# recipe's runtime-variant study (scripts/hpo_real_study.py:126-131)
POP_K = 4
SEED_TRIAL = {
    "lr": 1e-3, "eta_min_ratio": 0.1, "weight_decay": 0.0,
    "spec_loss_weight": 1.0, "angle_loss_weight": 0.5,
    "time_loss_weight": 100.0, "energy_loss_weight": 5.0,
    "multistft_loss_weight": 1.0, "das_reg_loss_weight": 10.0,
}

# Device kernels of a profiled step, grouped by kind: the first kind with
# a key in the (lower-cased) kernel name.
TRACE_KINDS = (
    ("port", ("hashgrid_encode_kernel", "hashgrid_encode_bwd_kernel", "scatter_add_rows_kernel")),
    ("matmul", ("nvjet", "gemm")),
    ("fft", ("fft",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "copy")),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Profiler sessions of device_ms whose trace held no device events, and
# the device_ms values that fell back to CUDA events because of them.
PROFILER_MISSES = {"empty_sessions": 0, "event_timed": 0}


def device_ms(fn, iters: int = 10, warmup: int = 2, attempts: int = 3) -> float:
    """Mean device kernel time of ``fn`` (torch.profiler, kernels and
    memsets summed): no host gaps, for launches too small to keep the card
    busy back to back. Now and then a profiler session on the card returns
    a trace without device events: such a session is run again, and after
    ``attempts`` empty ones the time is taken with CUDA events instead
    (``time_ms``, host gaps included). Both are counted in PROFILER_MISSES."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset")]
        if kern:
            return sum(e["dur"] for e in kern) / 1e3 / iters
        PROFILER_MISSES["empty_sessions"] += 1
    PROFILER_MISSES["event_timed"] += 1
    return time_ms(fn, iters=iters, warmup=0)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def step_points(torch, dev, cfg, seed: int, lo: float, hi: float):
    """A train step's encoded streams for batch_size random receivers in
    [lo, hi)³: the sample points x01 [bs·R·S, 3] and the view directions
    (1 − dir)/2 [R, 3], in the unit cube."""
    from avr_torch import geometry
    from avr_torch.render.common import make_consts

    g = torch.Generator(device=dev).manual_seed(seed)
    rc, bs = cfg.render, cfg.train.batch_size
    consts = make_consts(rc, cfg.model.signal_output_dim, device=dev)
    rays_o = lo + torch.rand((bs, 3), generator=g, device=dev) * (hi - lo)
    dirs = geometry.ray_directions(rc.n_azi, rc.n_ele, generator=g, device=dev)
    pts = geometry.ray_points(rays_o, dirs, consts.d_vals)
    box_lo = torch.tensor(rc.xyz_min, device=dev)
    box_hi = torch.tensor(rc.xyz_max, device=dev)
    pts_n = geometry.normalize_points(pts, box_lo, box_hi)
    x = ((pts_n + 1.0) / 2.0).reshape(-1, 3).contiguous()
    return x, ((1.0 - dirs) / 2.0).contiguous()


def flagship_points(torch, dev, cfg, seed: int):
    """The flagship step's encoded points: x01 [bs·R·S, 3] in the unit cube."""
    return step_points(torch, dev, cfg, seed, -2.0, 2.0)[0]


def array_config():
    """The array recipe, as the yml has it."""
    from avr_torch.config import AVRConfig

    return AVRConfig.from_yaml(ARRAY_CONFIG)


def corner_updates(torch, he, levels, x, g):
    """The encode backward as a stream of row updates: corner rows idx
    (int32 [M]) from the kernels' shared header, and (a function that
    fills) upd [M, F] = w·g per corner, level-major as ``corners`` gives;
    it takes another g [N, L, F] as its argument)."""
    idx, w = he.corners(levels, x)
    N, F = x.shape[0], g.shape[-1]
    upd = torch.empty((idx.shape[0], F), device=x.device)
    groups, start = [], 0
    for lo, hi in he.level_groups(levels):
        n = (hi - lo) * levels[lo].K * N
        groups.append((lo, hi, levels[lo].K, start, n))
        start += n

    def mul(g=g):
        for lo, hi, K, s0, n in groups:
            torch.mul(w[s0 : s0 + n].view(hi - lo, K, N, 1), g[:, lo:hi].permute(1, 0, 2).unsqueeze(1),
                      out=upd[s0 : s0 + n].view(hi - lo, K, N, F))

    return idx, upd, mul


def boundary_streams(F: int, chunk_rows: int, slab_rows: int, chunks: int, seed: int = 0,
                     one_row_rows: int = 0) -> dict:
    """Streams that put kernel A's runs and spans on its lane (8 rows), warp
    (256) and block (``chunk_rows``) boundaries and at its slab's capacity
    (``slab_rows``), most of them ``chunks`` chunks long: name → (idx int32
    [M], upd float32 [M, F], n_rows), numpy. The updates are small integers,
    so every sum is exact in fp32 in any order. ``one_row`` holds one index
    for ``one_row_rows`` rows (default: the chunks' length)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    C, S, n_rows = chunk_rows, slab_rows, 1 << 20
    n = chunks * C
    def in_slab(count):  # rows inside one slab's span, no two adjacent equal
        return 1000 + np.cumsum(rng.integers(1, S, count)) % S

    idx = {"one_row": np.full(one_row_rows or n, 12_345)}
    for r in (33, 1025, C + 1):  # runs across lanes, warps, blocks
        idx[f"runs_{r}"] = np.repeat(in_slab(n // r + 2), r)[: n + 7]
    for name, span in (("span_slab", S), ("span_slab_plus_1", S + 1)):
        ids = 1000 + rng.integers(0, span, n)
        ids[::C], ids[C - 1 :: C] = 1000, 1000 + span - 1  # every chunk spans both ends
        idx[name] = ids
    # C distinct rows per chunk, spread past the slab: nothing to fold
    idx["distinct_chunk"] = (rng.integers(0, n_rows) + 7919 * np.arange(n)) % n_rows
    # rows out of [0, n_rows) inside runs and at their ends
    ids = np.repeat(in_slab(n // 40 + 2), 40)[: n + 3]
    ids[5::40], ids[39::40], ids[20::97] = -1, n_rows, n_rows + 5
    idx["out_of_range"] = ids
    idx["ragged"] = rng.integers(0, 5000, n + 5)  # M not a multiple of the chunk
    idx["m_31"] = rng.integers(0, 64, 31)
    idx["m_7"] = np.full(7, 3)
    return {
        name: (ids.astype(np.int32), rng.integers(-8, 9, (ids.shape[0], F)).astype(np.float32), n_rows)
        for name, ids in idx.items()
    }


def scatter_counts(torch, lay: dict, idx, n_rows: int) -> dict:
    """What kernel A does with a stream, computed from the stream with torch
    by the kernel's rule (csrc/hash_scatter.cu) and its layout ``lay``
    (``hash_scatter.kernel_layout``): the runs, 1 + Σ[idx[i] ≠ idx[i−1]];
    whether the launch may use the slab (more chunks than resident blocks);
    per chunk, the slab if it may and the span of the chunk's in-range rows
    fits, else L2; the share of the stream's rows summed in shared memory;
    and the global REDs the design issues: one per touched row of a slab
    chunk, one per run and warp (256 rows) of the rest. ``row_reds`` counts
    one RED per in-range row, what a kernel that neither folds nor
    privatises issues."""
    C, W, M = lay["chunk_rows"], 256, idx.shape[0]
    use_slab = -(-M // C) > lay["resident_blocks"]
    valid = (idx >= 0) & (idx < n_rows)
    keys = torch.where(valid, idx, -1)
    keys = torch.cat([keys, keys.new_full(((-M) % C,), -1)]).view(-1, C)
    hi = keys.max(1).values
    lo = torch.where(keys >= 0, keys, torch.iinfo(torch.int32).max).min(1).values
    live = hi >= 0
    slab = live & (hi.long() - lo.long() + 1 <= lay["slab_rows"]) & use_slab
    direct = live & ~slab
    srt = keys.sort(1).values
    distinct = (srt[:, :1] >= 0).sum(1) + ((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(1)
    w = keys.view(-1, W)
    warp_runs = ((w[:, :1] >= 0).sum(1) + ((w[:, 1:] != w[:, :-1]) & (w[:, 1:] >= 0)).sum(1)).view(-1, C // W).sum(1)
    rows = torch.full((keys.shape[0],), C, device=idx.device)
    rows[-1] = M - C * (keys.shape[0] - 1)
    del srt, w, keys
    return {
        "runs": 1 + int((idx[1:] != idx[:-1]).sum()), "in_range_rows": int(valid.sum()),
        "use_slab": use_slab, "chunks": {"slab": int(slab.sum()), "l2": int(direct.sum())},
        "smem_row_share": float(rows[slab].sum()) / M,
        "reds": int(distinct[slab].sum() + warp_runs[direct].sum()),
        "row_reds": int(valid.sum()),
    }


def time_kernel_a(torch, hs, idx, upd, n_rows: int, iters: int, earlier=None) -> dict:
    """Kernel A, its library route (``zero_`` and ``index_add_`` into an
    [n_rows, F] buffer) and, where given, an earlier build of kernel A
    (``earlier_kernel_a``), each timed twice with the same iterations in
    the order kernel, library, earlier, earlier, library, kernel: the mean
    of each pair."""
    buf = torch.zeros((n_rows, upd.shape[1]), device=upd.device)

    def library():
        buf.zero_()
        buf.index_add_(0, idx, upd)

    fns = {"kernel_ms": lambda: hs.scatter_add_rows(idx, upd, n_rows), "library_ms": library}
    if earlier is not None:
        fns["earlier_kernel_ms"] = lambda: earlier(idx, upd, n_rows)
    ms = dict.fromkeys(fns, 0.0)
    for key in [*fns, *reversed(fns)]:
        ms[key] += time_ms(fns[key], iters=iters) / 2
    return ms


def earlier_kernel_a(torch, source: str):
    """Kernel A built from another source with the same C entry
    (``avr_scatter_add_rows``; an earlier commit's ``hash_scatter.cu``), to
    time beside the repo's: a function (idx, upd, n_rows) → out that zeroes
    the output and launches as the wrapper does."""
    import ctypes
    import hashlib

    from avr_torch.ops import _build

    text = open(source, "rb").read()
    lib = _build.BUILD_DIR / f"libearlier_hash_scatter-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), source],
                       check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).avr_scatter_add_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(idx, upd, n_rows):
        out = torch.zeros((n_rows, upd.shape[1]), device=upd.device)
        rc = fn(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), idx.shape[0], n_rows, upd.shape[1],
                torch.cuda.current_stream(upd.device).cuda_stream)
        check(rc == 0, f"earlier kernel A from {source}: CUDA error {rc}")
        return out

    return run


def explain_kernel_a(torch, dev, hs, idx, upd, n_rows: int, m_dense: int, iters: int) -> dict:
    """Kernel A at a level-major stream: the time and counts
    (``scatter_counts``) of the whole stream, of its dense levels (the first
    m_dense rows) and of its hashed levels (every part's launch zeroes the
    whole output), and the zero fill alone."""
    F = upd.shape[1]
    lay = hs.kernel_layout(F)
    parts = {"all": slice(0, idx.shape[0]), "dense_levels": slice(0, m_dense),
             "hashed_levels": slice(m_dense, idx.shape[0])}
    rec = {"zero_fill_ms": time_ms(lambda: torch.zeros((n_rows, F), device=dev), iters=iters)}
    for part, s in parts.items():
        i_s, u_s = idx[s], upd[s]
        rec[part] = {
            "M": i_s.shape[0], "distinct_rows": int(torch.unique(i_s).numel()),
            "kernel_ms": time_ms(lambda: hs.scatter_add_rows(i_s, u_s, n_rows), iters=iters),
            **scatter_counts(torch, lay, i_s, n_rows),
        }
    return rec


def hold_kernel_a(torch, hs, idx, upd, n_rows: int, what: str) -> dict:
    """Kernel A against its plain version: max|err| within 1e-5 of the
    largest |sum|."""
    ref = hs.scatter_add_rows_reference(idx, upd, n_rows)
    got = hs.scatter_add_rows(idx, upd, n_rows)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= 1e-5 * scale, f"kernel A {what}: max|err| {err} > 1e-5 × {scale}")
    return {"max_abs_err": err, "scale": scale}


def phase_scatter(torch, dev, static, x, results, earlier=None):
    """Kernel A, the generic scatter, against its plain version and
    ``index_add_``: first on the boundary streams (``boundary_streams``:
    integer updates, so every sum is exact), each whole and shifted by a row
    (scalar loads), F = 1, 2, 4, at two lengths: 5 chunks (one wave: every
    run to L2) and one chunk more than the card holds at once (the slab
    where a chunk's span fits); then at the flagship pos_pair stream (the
    corner indices of the flagship points, plain version), F = 4, 2, 1, and
    that stream permuted (no runs, full spans). Off the training path since
    the encode backward has its own kernel. ``earlier``
    (``earlier_kernel_a``) is timed beside the kernel."""
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he

    out = {"phase": "kernel_a_scatter", "boundary": {}}
    for F in (1, 2, 4):
        lay = hs.kernel_layout(F)
        out[f"layout_F{F}"] = lay
        for size, chunks, one_row in (("wave", 5, 1 << 20), ("queued", lay["resident_blocks"] + 1, 0)):
            streams = boundary_streams(F, lay["chunk_rows"], lay["slab_rows"], chunks, seed=F, one_row_rows=one_row)
            for name, (i_np, u_np, n_rows) in streams.items():
                i_t, u_t = torch.from_numpy(i_np).to(dev), torch.from_numpy(u_np).to(dev)
                errs = [hold_kernel_a(torch, hs, i_t, u_t, n_rows, f"{name} ({size}) F={F}")["max_abs_err"]]
                if i_t.shape[0] > 1:
                    errs.append(hold_kernel_a(torch, hs, i_t[1:], u_t[1:], n_rows,
                                              f"{name}[1:] ({size}) F={F}")["max_abs_err"])
                out["boundary"][f"{name}_{size}_F{F}"] = {
                    "M": i_t.shape[0], "max_abs_err": max(errs), **scatter_counts(torch, lay, i_t, n_rows),
                }

    idx, _ = he.corners_reference(static.levels, x)
    n_rows, M = static.padded_entries, idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    out.update({"M": M, "n_rows": n_rows})
    for F in (4, 2, 1):
        upd = torch.randn((M, F), generator=g, device=dev)
        rec = hold_kernel_a(torch, hs, idx, upd, n_rows, f"flagship F={F}")
        b_ms, b_by = bound(M * 4 + M * F * 4 + n_rows * F * 4, M * F)
        rec.update({
            **time_kernel_a(torch, hs, idx, upd, n_rows, iters=20, earlier=earlier),
            "plain_ms": time_ms(lambda: hs.scatter_add_rows_reference(idx, upd, n_rows)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
        out[f"F{F}"] = rec
        if F == 4:
            results["scatter"] = rec
            m_dense = x.shape[0] * sum(lv.K for lv in static.levels[: static.hashed.index(True)])
            rec.update(explain_kernel_a(torch, dev, hs, idx, upd, n_rows, m_dense, iters=20))
            perm = torch.randperm(M, generator=g, device=dev)
            i_p, u_p = idx[perm].contiguous(), upd[perm].contiguous()
            rec["permuted"] = {
                **hold_kernel_a(torch, hs, i_p, u_p, n_rows, "flagship permuted"),
                **time_kernel_a(torch, hs, i_p, u_p, n_rows, iters=20, earlier=earlier),
                "counts": scatter_counts(torch, hs.kernel_layout(F), i_p, n_rows),
            }
            del perm, i_p, u_p
        del upd
    emit(out)


def small_streams(cfg, x):
    """The training step's four small encode streams (F = 2): the ray
    directions (N = rays) and three per-batch transmitter encodes (N = batch)."""
    n_dir, bs = cfg.render.n_rays, cfg.train.batch_size
    return {"dir": x[:n_dir].contiguous(), "tx": x[:bs].contiguous()}


def level_kinds(static):
    """The pos_pair encode's levels by kind, name → (slice of the levels,
    levels, table rows), and its hashed levels once more with 4,096-row
    tables packed one after another, so that every row they gather stays in
    L2: where the encode kernels' time goes, and what the gathers cost."""
    levels, n_rows = static.levels, static.padded_entries
    n_dense = static.hashed.index(True)
    n_tri = static.level_modes.count("t")  # the trilinear levels come first
    hashed = slice(n_dense, len(levels))
    small = tuple(lv._replace(size=4096, offset=4096 * i) for i, lv in enumerate(levels[hashed]))
    return {
        "dense": (slice(0, n_dense), levels[:n_dense], n_rows),
        "hashed_trilinear": (slice(n_dense, n_tri), levels[n_dense:n_tri], n_rows),
        "hashed_simplex": (slice(n_tri, len(levels)), levels[n_tri:], n_rows),
        "hashed_l2_resident": (hashed, small, 4096 * len(small)),
    }


def phase_encode(torch, dev, cfg, static, x, results):
    """The encode forward against its plain version at the flagship pos_pair
    stream, and the corner indices of the shared header against the plain
    ones. fp32 within 1e-6 of scale; bf16 bit-equal (same roundings, same
    fp32 sum order). ``kernel_ms`` is fp32, as in the first slice's record;
    the step runs this stream in bf16 (``bf16_kernel_ms``)."""
    from avr_torch.ops import hashgrid_encode as he

    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn((static.padded_entries, 4), generator=g, device=dev)
    levels = static.levels
    N, L, F = x.shape[0], len(levels), 4
    out = {"phase": "encode_forward", "N": N, "levels": L, "F": F}
    ridx, rw = he.corners_reference(levels, x)
    gidx, gw = he.corners(levels, x)
    torch.cuda.synchronize()
    check(torch.equal(gidx, ridx), "corner indices of the shared header differ from the plain version")
    w_err = float((gw - rw).abs().max())
    check(w_err <= 1e-6, f"corner weights: max|err| {w_err} > 1e-6")
    ref = he.encode_rows_reference(table, levels, x)
    got = he.encode_rows(table, levels, x)
    ref16 = he.encode_rows_reference(table, levels, x, round_bf16=True)
    got16 = he.encode_rows(table, levels, x, round_bf16=True)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(err <= 1e-6 * scale, f"encode forward fp32: max|err| {err} > 1e-6 × {scale}")
    err16 = float((got16 - ref16).abs().max())
    n_diff16 = int((got16 != ref16).sum())
    check(n_diff16 == 0, f"encode forward bf16: {n_diff16} values differ from the plain version (max {err16})")
    check(torch.equal(got16, got16.to(torch.bfloat16).to(torch.float32)), "bf16 output holds non-bf16 values")
    M = gidx.shape[0]
    rows = int(torch.unique(gidx).numel())
    b_ms, b_by = bound(N * 12 + rows * F * 4 + N * L * F * 4, M * 2 * F)
    rec = {
        "max_abs_err": err, "bf16_max_abs_err": err16, "scale": scale, "bf16_values_differing": n_diff16,
        "weights_max_abs_err": w_err, "corner_rows": M, "distinct_rows": rows,
        "kernel_ms": time_ms(lambda: he.encode_rows(table, levels, x)),
        "bf16_kernel_ms": time_ms(lambda: he.encode_rows(table, levels, x, round_bf16=True)),
        "plain_ms": time_ms(lambda: he.encode_rows_reference(table, levels, x), iters=5),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "corners_only_ms": time_ms(lambda: he.corners(levels, x)),
        "device_ms": device_ms(lambda: he.encode_rows(table, levels, x)),
    }
    rec["by_level_kind_device_ms"] = {}
    for name, (_, lvs, n) in level_kinds(static).items():
        t = table if n == table.shape[0] else torch.randn((n, F), generator=g, device=dev)
        rec["by_level_kind_device_ms"][name] = device_ms(lambda: he.encode_rows(t, lvs, x))
    # the step's four other launches: F = 2 on a table of the same geometry,
    # fp32 as the step runs them
    t2 = torch.randn((static.padded_entries, 2), generator=g, device=dev)
    for name, xs in small_streams(cfg, x).items():
        n = xs.shape[0]
        k_rows = int(torch.unique(he.corners(levels, xs)[0]).numel())
        sb, _ = bound(n * 12 + k_rows * 8 + n * L * 8, n * sum(lv.K for lv in levels) * 4)
        rec[f"{name}_stream"] = {  # back to back, the host's per-call cost bounds the events' time
            "N": n, "F": 2, "bound_ms": sb,
            "back_to_back_ms": time_ms(lambda: he.encode_rows(t2, levels, xs)),
            "device_ms": device_ms(lambda: he.encode_rows(t2, levels, xs)),
        }
    # an odd level count leaves the last level group partial, 650 points the last point tile
    odd, xs = levels[:5], x[:650].contiguous()
    rec["partial_tiles_bit_equal"] = torch.equal(
        he.encode_rows(table, odd, xs, round_bf16=True),
        he.encode_rows_reference(table, odd, xs, round_bf16=True),
    )
    check(rec["partial_tiles_bit_equal"], "encode forward bf16 on partial tiles differs from the plain version")
    out.update(rec)
    results["encode"] = rec
    emit(out)


def phase_encode_bwd(torch, dev, cfg, static, x, results):
    """The encode backward (table gradient, zero fill included) against its
    plain version at the flagship pos_pair stream, F = 4 and 2, fp32 and
    bf16: within 1e-5 of scale (atomics sum in run-dependent order).
    ``kernel_ms`` is fp32, ``bf16_kernel_ms`` the step's mode. Also times the
    split by level kind and, once, the route it replaced (corner streams,
    torch.mul into an [M, F] update buffer, then the scatter kernel or
    index_add_)."""
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he

    gen = torch.Generator(device=dev).manual_seed(5)
    levels, n_rows = static.levels, static.padded_entries
    N, L = x.shape[0], len(levels)
    out = {"phase": "encode_backward", "N": N, "levels": L, "n_rows": n_rows}
    M = N * sum(lv.K for lv in levels)
    for F in (4, 2):
        g = torch.randn((N, L, F), generator=gen, device=dev)
        for rb in (False, True):
            ref = he.encode_backward_reference(g, levels, x, n_rows, round_bf16=rb)
            got = he.encode_backward(g, levels, x, n_rows, round_bf16=rb)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            tag = f"F{F}_{'bf16' if rb else 'fp32'}"
            check(err <= 1e-5 * scale, f"encode backward {tag}: max|err| {err} > 1e-5 × {scale}")
            b_ms, b_by = bound(N * 12 + N * L * F * 4 + n_rows * F * 4, M * 2 * F)
            rec = {
                "max_abs_err": err, "scale": scale,
                "kernel_ms": time_ms(lambda: he.encode_backward(g, levels, x, n_rows, round_bf16=rb)),
                "plain_ms": time_ms(
                    lambda: he.encode_backward_reference(g, levels, x, n_rows, round_bf16=rb), iters=5
                ),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            }
            del ref, got
            out[tag] = rec
        if F == 4:
            main = out["F4_fp32"]
            results["encode_bwd"] = main
            main["bf16_kernel_ms"] = out["F4_bf16"]["kernel_ms"]
            main["bf16_max_abs_err"] = out["F4_bf16"]["max_abs_err"]
            main["zero_fill_ms"] = time_ms(lambda: torch.zeros((n_rows, F), device=dev))
            main["device_ms"] = device_ms(lambda: he.encode_backward(g, levels, x, n_rows))
            main["by_level_kind_device_ms"] = {}  # each with its own zero fill
            for name, (sl, lvs, n) in level_kinds(static).items():
                g_s = g[:, sl].contiguous()
                main["by_level_kind_device_ms"][name] = device_ms(lambda: he.encode_backward(g_s, lvs, x, n))
            # The route this kernel replaced, timed once for the record (fp32).
            idx, upd, mul = corner_updates(torch, he, levels, x, g)
            buf = torch.zeros((n_rows, F), device=dev)

            def via_index_add():
                mul()
                buf.zero_()
                buf.index_add_(0, idx, upd)

            main["old_route"] = {
                "mul_ms": time_ms(mul),
                "mul_then_scatter_kernel_ms": time_ms(lambda: (mul(), hs.scatter_add_rows(idx, upd, n_rows))),
                "mul_then_index_add_ms": time_ms(via_index_add),
            }
            del idx, upd, buf
        del g
    # an odd level count leaves the last level group partial, 650 points the last point tile
    odd, xs = levels[:5], x[:650].contiguous()
    g5 = torch.randn((xs.shape[0], len(odd), 4), generator=gen, device=dev)
    ref = he.encode_backward_reference(g5, odd, xs, n_rows)
    err = float((he.encode_backward(g5, odd, xs, n_rows) - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= 1e-5 * scale, f"encode backward on partial tiles: max|err| {err} > 1e-5 × {scale}")
    out["partial_tiles"] = {"max_abs_err": err, "scale": scale}
    gs = torch.Generator(device=dev).manual_seed(6)
    for name, xs in small_streams(cfg, x).items():
        n = xs.shape[0]
        g2 = torch.randn((n, L, 2), generator=gs, device=dev)
        ref = he.encode_backward_reference(g2, levels, xs, n_rows)
        err = float((he.encode_backward(g2, levels, xs, n_rows) - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= 1e-5 * scale, f"encode backward {name} stream: max|err| {err} > 1e-5 × {scale}")
        sb, _ = bound(n * 12 + n * L * 8 + n_rows * 8, n * sum(lv.K for lv in levels) * 4)
        out[f"{name}_stream"] = {
            "N": n, "F": 2, "max_abs_err": err, "scale": scale, "bound_ms": sb,
            "back_to_back_ms": time_ms(lambda: he.encode_backward(g2, levels, xs, n_rows)),
            "device_ms": device_ms(lambda: he.encode_backward(g2, levels, xs, n_rows)),
        }
    emit(out)


def phase_encode_array(torch, dev, fst, x, view, results, earlier=None):
    """The encode pair against its plain versions at the array step's two
    large streams: ``pos`` (bs·R·S ray points, F = 2, in the bf16 rule the
    step runs and in fp32) and ``dir`` (the R view directions through the
    2^20-row table, fp32 as the step runs it). Forward fp32 within 1e-6 of
    scale and bf16 bit-equal; backward within 1e-5 of scale. The backward's
    library route is ``index_add_`` of the fp32 corner update stream (the
    stream itself not timed); the generic scatter kernel is held and timed
    on the same stream with the same iterations, ``earlier``
    (``earlier_kernel_a``) beside it."""
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he

    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"phase": "encode_array"}
    for name, xs, modes in (("pos", x, ("bf16", "fp32")), ("dir", view, ("fp32",))):
        grid = fst.encodings[name].grid
        levels, n_rows = grid.levels, grid.padded_entries
        N, L, F = xs.shape[0], len(levels), grid.n_features
        M = N * sum(lv.K for lv in levels)
        table = torch.randn((n_rows, F), generator=gen, device=dev)
        g = torch.randn((N, L, F), generator=gen, device=dev)
        rows = int(torch.unique(he.corners(levels, xs)[0]).numel())
        f_ms, f_by = bound(N * 12 + rows * F * 4 + N * L * F * 4, M * 2 * F)
        b_ms, b_by = bound(N * 12 + N * L * F * 4 + n_rows * F * 4, M * 2 * F)
        rec = {"N": N, "levels": L, "F": F, "n_rows": n_rows, "corner_rows": M, "distinct_rows": rows}
        plain_iters = 3 if name == "pos" else 5
        for mode in modes:
            rb = mode == "bf16"
            ref = he.encode_rows_reference(table, levels, xs, round_bf16=rb)
            got = he.encode_rows(table, levels, xs, round_bf16=rb)
            torch.cuda.synchronize()
            scale, err = float(ref.abs().max()), float((got - ref).abs().max())
            if rb:
                n_diff = int((got != ref).sum())
                check(n_diff == 0, f"{name} encode forward bf16: {n_diff} values differ (max {err})")
            else:
                check(err <= 1e-6 * scale, f"{name} encode forward fp32: max|err| {err} > 1e-6 × {scale}")
            del ref, got
            rec[f"forward_{mode}"] = {
                "max_abs_err": err, "scale": scale,
                "kernel_ms": time_ms(lambda: he.encode_rows(table, levels, xs, round_bf16=rb)),
                "device_ms": device_ms(lambda: he.encode_rows(table, levels, xs, round_bf16=rb)),
                "plain_ms": time_ms(lambda: he.encode_rows_reference(table, levels, xs, round_bf16=rb),
                                    iters=plain_iters, warmup=1),
                "bound_ms": f_ms, "bound_by": f_by, "library_ms": None,
            }
            ref = he.encode_backward_reference(g, levels, xs, n_rows, round_bf16=rb)
            got = he.encode_backward(g, levels, xs, n_rows, round_bf16=rb)
            torch.cuda.synchronize()
            scale, err = float(ref.abs().max()), float((got - ref).abs().max())
            check(err <= 1e-5 * scale, f"{name} encode backward {mode}: max|err| {err} > 1e-5 × {scale}")
            del got
            if not rb:
                ref_fp32 = ref
            del ref
            rec[f"backward_{mode}"] = {
                "max_abs_err": err, "scale": scale,
                "kernel_ms": time_ms(lambda: he.encode_backward(g, levels, xs, n_rows, round_bf16=rb)),
                "device_ms": device_ms(lambda: he.encode_backward(g, levels, xs, n_rows, round_bf16=rb)),
                "plain_ms": time_ms(
                    lambda: he.encode_backward_reference(g, levels, xs, n_rows, round_bf16=rb),
                    iters=plain_iters, warmup=1,
                ),
                "bound_ms": b_ms, "bound_by": b_by,
            }
        # the fp32 update stream: index_add_ (the library route) and kernel A
        idx, upd, mul = corner_updates(torch, he, levels, xs, g)
        mul()
        iters = 5 if name == "pos" else 20
        timed = time_kernel_a(torch, hs, idx, upd, n_rows, iters=iters, earlier=earlier)
        for mode in modes:
            rec[f"backward_{mode}"]["library_ms"] = timed["library_ms"]
        got = hs.scatter_add_rows(idx, upd, n_rows)
        torch.cuda.synchronize()
        scale, err = float(ref_fp32.abs().max()), float((got - ref_fp32).abs().max())
        check(err <= 1e-5 * scale, f"kernel A at the {name} stream: max|err| {err} > 1e-5 × {scale}")
        a_ms, a_by = bound(M * 4 + M * F * 4 + n_rows * F * 4, M * F)
        m_dense = N * sum(lv.K for lv in levels[: grid.hashed.index(True)])
        rec["kernel_a_scatter"] = {
            "max_abs_err": err, "scale": scale, **timed,
            "plain_ms": time_ms(lambda: hs.scatter_add_rows_reference(idx, upd, n_rows), iters=3, warmup=1),
            "bound_ms": a_ms, "bound_by": a_by,
            **explain_kernel_a(torch, dev, hs, idx, upd, n_rows, m_dense, iters=iters),
        }
        del idx, upd, mul, got, ref_fp32, table, g
        out[name] = rec
    results["encode_array"] = {k: v for k, v in out.items() if k != "phase"}
    emit(out)


def phase_encode_population(torch, dev, fst, x, view, results):
    """The K-trial encode pair (``encode_rows_pop``, ``encode_backward_pop``:
    the same two kernels, one launch for POP_K tables) at the array step's
    streams: against their plain versions (a loop of the single-table plain
    versions; forward bf16 bit-equal and fp32 within 1e-6 of scale, backward
    within 1e-5 of scale) and against POP_K single-table launches (forward
    bit-equal: same arithmetic per table; backward within 1e-5 of scale:
    atomics in another order), timed against those POP_K launches. The
    bound counts each table's rows that the points reach once, x once and
    the outputs once. The backward's library route is, per trial, ``mul``
    of its fp32 corner update stream and ``index_add_`` into its table."""
    from avr_torch.ops import hashgrid_encode as he

    gen = torch.Generator(device=dev).manual_seed(8)
    K = POP_K
    out = {"phase": "encode_population", "K": K}
    for name, xs, modes in (("pos", x, ("bf16", "fp32")), ("dir", view, ("fp32",))):
        grid = fst.encodings[name].grid
        levels, n_rows = grid.levels, grid.padded_entries
        N, L, F = xs.shape[0], len(levels), grid.n_features
        M = N * sum(lv.K for lv in levels)
        tables = torch.randn((K, n_rows, F), generator=gen, device=dev)
        g = torch.randn((K, N, L, F), generator=gen, device=dev)
        rows = int(torch.unique(he.corners(levels, xs)[0]).numel())
        f_ms, f_by = bound(N * 12 + K * (rows * F * 4 + N * L * F * 4), K * M * 2 * F)
        b_ms, b_by = bound(N * 12 + K * (N * L * F * 4 + n_rows * F * 4), K * M * 2 * F)
        rec = {"N": N, "levels": L, "F": F, "n_rows": n_rows, "distinct_rows": rows}
        plain_iters = 2 if name == "pos" else 5
        for mode in modes:
            rb = mode == "bf16"
            ref = he.encode_rows_pop_reference(tables, levels, xs, round_bf16=rb)
            got = he.encode_rows_pop(tables, levels, xs, round_bf16=rb)
            single = torch.stack([he.encode_rows(tables[k], levels, xs, round_bf16=rb) for k in range(K)])
            torch.cuda.synchronize()
            scale, err = float(ref.abs().max()), float((got - ref).abs().max())
            if rb:
                n_diff = int((got != ref).sum())
                check(n_diff == 0, f"{name} population forward bf16: {n_diff} values differ (max {err})")
            else:
                check(err <= 1e-6 * scale, f"{name} population forward fp32: max|err| {err} > 1e-6 × {scale}")
            check(torch.equal(got, single), f"{name} population forward {mode} differs from {K} single launches")
            del ref, got, single
            rec[f"forward_{mode}"] = {
                "max_abs_err": err, "scale": scale,
                "kernel_ms": time_ms(lambda: he.encode_rows_pop(tables, levels, xs, round_bf16=rb)),
                "device_ms": device_ms(lambda: he.encode_rows_pop(tables, levels, xs, round_bf16=rb)),
                "k1_loop_ms": time_ms(
                    lambda: [he.encode_rows(tables[k], levels, xs, round_bf16=rb) for k in range(K)]),
                "plain_ms": time_ms(lambda: he.encode_rows_pop_reference(tables, levels, xs, round_bf16=rb),
                                    iters=plain_iters, warmup=1),
                "bound_ms": f_ms, "bound_by": f_by, "library_ms": None,
            }
            ref = he.encode_backward_pop_reference(g, levels, xs, n_rows, round_bf16=rb)
            got = he.encode_backward_pop(g, levels, xs, n_rows, round_bf16=rb)
            single = torch.stack([he.encode_backward(g[k], levels, xs, n_rows, round_bf16=rb) for k in range(K)])
            torch.cuda.synchronize()
            scale, err = float(ref.abs().max()), float((got - ref).abs().max())
            check(err <= 1e-5 * scale, f"{name} population backward {mode}: max|err| {err} > 1e-5 × {scale}")
            err_single = float((got - single).abs().max())
            check(err_single <= 1e-5 * scale,
                  f"{name} population backward {mode} against {K} single launches: {err_single} > 1e-5 × {scale}")
            del ref, got, single
            rec[f"backward_{mode}"] = {
                "max_abs_err": err, "scale": scale, "vs_single_launches_max_abs": err_single,
                "kernel_ms": time_ms(lambda: he.encode_backward_pop(g, levels, xs, n_rows, round_bf16=rb)),
                "device_ms": device_ms(lambda: he.encode_backward_pop(g, levels, xs, n_rows, round_bf16=rb)),
                "k1_loop_ms": time_ms(
                    lambda: [he.encode_backward(g[k], levels, xs, n_rows, round_bf16=rb) for k in range(K)]),
                "plain_ms": time_ms(
                    lambda: he.encode_backward_pop_reference(g, levels, xs, n_rows, round_bf16=rb),
                    iters=plain_iters, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
            }
        idx, upd, mul = corner_updates(torch, he, levels, xs, g[0])
        buf = torch.zeros((K, n_rows, F), device=dev)

        def library():
            buf.zero_()
            for k in range(K):
                mul(g[k])
                buf[k].index_add_(0, idx, upd)

        lib_ms = time_ms(library, iters=3, warmup=1)
        for mode in modes:
            rec[f"backward_{mode}"]["library_ms"] = lib_ms
        del idx, upd, mul, buf, tables, g
        out[name] = rec
    results["encode_population"] = {k: v for k, v in out.items() if k != "phase"}
    emit(out)


def card_vs_cpu(torch, dev, cfg, dataset_type: str, box, ch_idx=None, **render_kw):
    """render_fused on the card (kernels) against the CPU (plain versions)
    on a small config, fp32, from the same params (tables N(0,1), so that
    relative tolerances mean something) and inputs: forward within 5e-5 and
    the gradient of every leaf within 1e-4 of scale. ``box`` (lo, hi) is
    where receivers and transmitters are drawn."""
    from avr_torch import geometry
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.render.fused import render_fused
    from avr_torch.train.state import named_leaves, tree_map

    fst = field.build_field(cfg.model, dataset_type)
    params_cpu = field.init(torch.Generator().manual_seed(3), fst, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for k, t in params_cpu["enc"].items():
        params_cpu["enc"][k] = torch.randn(t.shape, generator=gen)
    bs, (lo, hi) = cfg.train.batch_size, box
    inputs = {
        "rays_o": lo + torch.rand((bs, 3), generator=gen) * (hi - lo),
        "position_tx": lo + torch.rand((bs, 3), generator=gen) * (hi - lo),
    }
    if fst.variant == "complex":
        inputs["direction_tx"] = torch.nn.functional.normalize(torch.randn((bs, 3), generator=gen), dim=-1)
    inputs["dirs"] = geometry.ray_directions(cfg.render.n_azi, cfg.render.n_ele, generator=gen, device="cpu")
    if ch_idx is not None:
        inputs["ch_idx"] = ch_idx
    target = torch.randn((bs, cfg.model.signal_output_dim // 2 + 1, 2), generator=gen)
    res = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.detach().to(d).requires_grad_(True), params_cpu)
        out = render_fused(
            params, fst, make_consts(cfg.render, cfg.model.signal_output_dim, device=d), cfg.render,
            **{k: v.to(d) for k, v in inputs.items()}, compute_dtype=None, **render_kw,
        )
        torch.mean((out - target.to(d)) ** 2).backward()
        res[str(d)] = (out.detach().cpu(), {n: t.grad.cpu() for n, t in named_leaves(params)})
    (o_cpu, g_cpu), (o_dev, g_dev) = res["cpu"], res[str(dev)]
    fwd = float((o_dev - o_cpu).abs().max() / o_cpu.abs().max())
    check(fwd <= 5e-5, f"card vs CPU render forward: {fwd} > 5e-5 of scale")
    grad = {n: float((g_dev[n] - g_cpu[n]).abs().max() / (g_cpu[n].abs().max() + 1e-30)) for n in g_cpu}
    worst = max(grad, key=grad.get)
    check(grad[worst] <= 1e-4, f"card vs CPU gradient of {worst}: {grad[worst]} > 1e-4 of scale")
    return {
        "forward_rel_err": fwd, "worst_grad": worst, "worst_grad_rel_err": grad[worst], "leaves": len(grad),
    }


def phase_small_parity(torch, dev):
    """The card path against the CPU path on the small flagship config."""
    from avr_torch.flagship import flagship_config

    rec = card_vs_cpu(torch, dev, flagship_config(small=True), "RAF", (-2.0, 2.0), shell_chunk=2)
    emit({"phase": "small_card_vs_cpu", **rec})


def small_standard_config(mode: str):
    """The array recipe with every width cut (4 levels of 2^8 rows, MLPs
    32 wide, 20 rays × 4 shells, T = 128); channel "add" as the recipe has
    it, or "concat" into all three subnets with the recipe's widths."""
    from avr_torch.config import EncodingConfig, MLPConfig

    cfg = array_config()
    rc, m = cfg.render, cfg.model
    rc.n_samples, rc.n_azi, rc.n_ele = 4, 6, 3
    m.signal_output_dim = 128
    enc = EncodingConfig(n_levels=4, log2_hashmap_size=8, base_resolution=4, per_level_scale=1.5)
    m.pos_encoding_sigma = m.dir_encoding_sig = m.tx_encoding_sig = enc
    for name in ("sigma_encoder_network", "sigma_decoder_network", "signal_network"):
        setattr(m, name, MLPConfig(n_neurons=32, n_hidden_layers=2))
    if mode == "concat":
        ch = m.channel_embed
        ch.connection_type = "concat"
        ch.is_sigma_encoder = ch.is_sigma_decoder = ch.is_signal_network = True
    return cfg


def phase_small_standard(torch, dev):
    """The card path against the CPU path on the small standard config,
    channel add and concat, precomputed and streaming plans, one 8-mic group."""
    out = {"phase": "small_standard_card_vs_cpu"}
    for mode in ("add", "concat"):
        cfg = small_standard_config(mode)
        for plan, budget in (("precomputed", 4_000_000), ("streaming", 0)):
            out[f"{mode}_{plan}"] = card_vs_cpu(
                torch, dev, cfg, cfg.path.dataset_type, (0.5, 2.5), ch_idx=torch.arange(8),
                shell_chunk=2, point_budget=budget,
            )
    emit(out)


def drive_steps(torch, dev, step, state, batches, gen):
    """One train step per batch, timed on the host clock to a synchronise.
    The kernels' launch counts are set to 0 just before and read just
    after. Checks finite loss terms in every step, the step count, and that
    every param moved. Returns (state, step_ms, bundles, launches, peak
    memory)."""
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he
    from avr_torch.train.state import named_leaves

    before = {n: t.clone() for n, t in named_leaves(state.params)}
    step0 = int(state.step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    step_ms, bundles = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, bundle = step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bundles.append({k: float(v) for k, v in bundle.as_dict().items()})
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, b in enumerate(bundles):
        bad = [k for k, v in b.items() if v != v or v in (float("inf"), float("-inf"))]
        check(not bad, f"train step {i}: non-finite loss terms {bad}")
    check(int(state.step) == step0 + len(batches), f"step count {int(state.step)} != {step0 + len(batches)}")
    unchanged = [n for n, t in named_leaves(state.params) if torch.equal(t, before[n])]
    check(not unchanged, f"params unchanged by training: {unchanged}")
    return state, step_ms, bundles, launches, peak


def train_record(phase, cfg, step_ms, bundles, launches, peak, **extra):
    """The printed record of a training phase."""
    tc, rc = cfg.train, cfg.render
    n = len(step_ms)
    steady_ms = sum(step_ms[1:]) / (n - 1) if n > 1 else step_ms[0]
    return {
        "phase": phase, "steps": n, "compute_dtype": tc.compute_dtype,
        "batch": tc.batch_size, "rays": rc.n_rays, "shells": rc.n_samples, "T": cfg.model.signal_output_dim,
        **extra, "step_ms": step_ms, "steady_ms_per_step": steady_ms,
        "rays_per_s_fwd_bwd": tc.batch_size * rc.n_rays / (steady_ms / 1e3),
        "peak_mem_bytes": peak, "launches_per_step": {k: v / n for k, v in launches.items()},
        "losses_last": bundles[-1],
    }


def phase_train(torch, dev, profile_dir, results):
    """The port's flagship training step at full width, bf16 compute."""
    from avr_torch.flagship import flagship_config
    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.train.state import init_state, make_train_step

    cfg = flagship_config()
    tc, rc = cfg.train, cfg.render
    fst = field.build_field(cfg.model, "RAF")
    consts = make_consts(rc, cfg.model.signal_output_dim, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(gen, fst, tc, device=dev)
    step, _ = make_train_step(fst, consts, rc, tc, CriterionConfig.from_configs(tc, rc))
    bs, F = tc.batch_size, cfg.model.signal_output_dim // 2 + 1
    batch = {
        "wave": torch.randn((bs, F, 2), generator=gen, device=dev) * 1e-2,
        "pos_rx": torch.rand((bs, 3), generator=gen, device=dev) * 4 - 2,
        "pos_tx": torch.rand((bs, 3), generator=gen, device=dev) * 4 - 2,
        "rot_tx": torch.tensor([[1.0, 0.0, 0.0]], device=dev).repeat(bs, 1),
    }
    state, step_ms, bundles, launches, peak = drive_steps(torch, dev, step, state, [batch] * TRAIN_STEPS, gen)
    # five encodes per step (pos_pair, dir, tx_pos, tx_dir, tx_pos_sig), each
    # one forward and one backward launch; the generic scatter is off the path
    for k in ("encode", "encode_bwd"):
        check(launches[k] == 5 * TRAIN_STEPS, f"kernel {k}: {launches[k]} launches in {TRAIN_STEPS} steps")
    results["launches"] = launches
    rec = train_record("train_flagship", cfg, step_ms, bundles, launches, peak)
    results["flagship_steady_ms"] = rec["steady_ms_per_step"]
    emit(rec)
    if profile_dir:
        profile_step(torch, step, state, batch, gen, rec["steady_ms_per_step"], profile_dir, "train_step")


def array_batches(torch, dev, cfg):
    """The array path's data: a synthetic Real_env dataset written by the
    port (image-source rooms, seed 0) into a temporary directory, loaded,
    and drawn as whole 8-mic groups, each batch moved to the card."""
    import tempfile

    from avr_torch.data import BatchSampler, load_dataset
    from avr_torch.data.synthetic import RoomSpec, write_real_env_dataset

    rc, T = cfg.render, cfg.model.signal_output_dim
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        write_real_env_dataset(d, RoomSpec(speed=rc.speed, fs=rc.fs, seq_len=T), ARRAY_GROUPS, seed=0)
        data = load_dataset(d, cfg.path.dataset_type, seq_len=T, fs=rc.fs)
    sampler = BatchSampler(data, cfg.train.batch_size, seed=cfg.train.seed, group8=True)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in sampler.epoch()]
    check(len(data) == 8 * (ARRAY_GROUPS - 1), f"{len(data)} train rows")
    group = torch.arange(8, dtype=torch.int32)
    for b in batches:
        check(torch.equal(b["ch_idx"].cpu(), group.repeat(len(b["ch_idx"]) // 8)), "a batch is not whole 8-mic groups")
    return batches, {"rows": len(data), "batches": len(batches), "data_s": time.perf_counter() - t0}


def phase_train_array(torch, dev, profile_dir, results):
    """The array recipe's training step at full width, bf16 compute, on
    port-written data: ``train_array`` runs TRAIN_STEPS steps with the
    precomputed plan (3 encodes per step, pos, dir and tx, each one forward
    and one backward launch), ``train_array_streaming`` one step of the same
    model and batch with the streaming plan, whose launch count the phase
    derives from the plan's structure."""
    import dataclasses

    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.render.fused import _pick_chunk
    from avr_torch.train.state import init_state, make_train_step, named_leaves

    cfg = array_config()
    tc, rc = cfg.train, cfg.render
    batches, data_rec = array_batches(torch, dev, cfg)
    fst = field.build_field(cfg.model, cfg.path.dataset_type)
    check(fst.variant == "standard" and fst.enc_mode == fst.sig_mode == "add", "the array recipe's field")
    consts = make_consts(rc, cfg.model.signal_output_dim, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(gen, fst, tc, device=dev)
    crit = CriterionConfig.from_configs(tc, rc)
    check(crit.das_reg_loss_weight > 0, "the recipe's DAS regression weight")
    emb = [n for n, _ in named_leaves(state.params) if ".emb." in n]
    check(len(emb) == 6, f"channel embeddings of the injected layers: {emb}")
    points = tc.batch_size * rc.n_rays * rc.n_samples
    check(points <= tc.point_budget, f"{points} points take the streaming plan")
    step, _ = make_train_step(fst, consts, rc, tc, crit)
    run = [batches[i % len(batches)] for i in range(TRAIN_STEPS)]
    state, step_ms, bundles, launches, peak = drive_steps(torch, dev, step, state, run, gen)
    for k in ("encode", "encode_bwd"):
        check(launches[k] == 3 * TRAIN_STEPS, f"kernel {k}: {launches[k]} launches in {TRAIN_STEPS} steps")
    check(launches["scatter"] == 0, f"kernel A: {launches['scatter']} launches")
    check(all(b["das_reg"] > 0 for b in bundles), "the DAS regression term is zero")
    results["array_launches"] = launches
    rec = train_record("train_array", cfg, step_ms, bundles, launches, peak, points=points,
                       shell_chunk=tc.shell_chunk, emb_leaves=emb, data=data_rec)
    results["array_steady_ms"] = rec["steady_ms_per_step"]
    emit(rec)
    if profile_dir:
        steady_ms = rec["steady_ms_per_step"]
        profile_step(torch, step, state, run[0], gen, steady_ms, profile_dir, "train_array_step")

    # The streaming plan: per shell chunk, one pos encode in the attenuation
    # pass and one in the signal pass, each recomputed once more in the
    # backward when checkpointed; dir and tx encode once per step.
    tcs = dataclasses.replace(tc, point_budget=0, shell_chunk=STREAMING_SHELL_CHUNK)
    n_chunks = rc.n_samples // _pick_chunk(rc.n_samples, tcs.shell_chunk)
    n_ctx = sum(fst.encodings[k].otype == "hashgrid" for k in ("dir", "tx"))
    expected = counts(
        encode=n_ctx + 2 * n_chunks * (2 if tcs.remat else 1),
        encode_bwd=n_ctx + 2 * n_chunks,
    )
    step_s, _ = make_train_step(fst, consts, rc, tcs, crit)
    state, s_ms, s_bundles, s_launches, s_peak = drive_steps(torch, dev, step_s, state, run[:1], gen)
    check(s_launches == expected, f"streaming step launches {s_launches}, the plan predicts {expected}")
    results["array_streaming_launches"] = s_launches
    emit(train_record("train_array_streaming", cfg, s_ms, s_bundles, s_launches, s_peak,
                      point_budget=tcs.point_budget, shell_chunk=tcs.shell_chunk, n_chunks=n_chunks,
                      predicted_launches=expected))


# the keys of the ``kernels`` line → the wrappers' launch counters in
# ``avr_torch.utils.profiling``; ``*_pop`` are the K-trial wrappers of the
# same two encode kernels
LAUNCH_COUNTERS = {"scatter": "scatter.launches", "encode": "encode.fwd_launches",
                   "encode_bwd": "encode.bwd_launches", "encode_pop": "encode.fwd_pop_launches",
                   "encode_bwd_pop": "encode.bwd_pop_launches"}


def launch_counts():
    """The wrappers' launch counts, by the keys of the ``kernels`` line."""
    from avr_torch.utils import profiling

    now = profiling.counters()
    return {k: now.get(name, 0) for k, name in LAUNCH_COUNTERS.items()}


def counts(**nonzero) -> dict:
    """A launch-count dict with every key of ``launch_counts``, 0 unless given."""
    return {**dict.fromkeys(LAUNCH_COUNTERS, 0), **nonzero}


def reset_launch_counts() -> None:
    """Clears the registry's counters (and any span recorded)."""
    from avr_torch.utils import profiling

    profiling.drain()


def since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def read_jsonl(path: str) -> dict:
    """{tag: {step: value}} of a runner's metrics.jsonl."""
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return out


def equal_states(torch, a, b) -> bool:
    from avr_torch.train.state import named_leaves

    trees = lambda s: (s.params, s.opt_state.mu, s.opt_state.nu)  # noqa: E731
    leaves = [(x, y) for ta, tb in zip(trees(a), trees(b)) for (_, x), (_, y) in zip(named_leaves(ta), named_leaves(tb))]
    return bool(leaves) and int(a.step) == int(b.step) and all(
        torch.equal(x.to(y.device), y) for x, y in leaves
    )


def instrumented_train(torch, dev, runner):
    """``runner.train()`` with its validations, saves and ``metric_cal``
    timed, the launch counts set to 0 just before and read just after.
    Returns (seconds, launches, peak memory, validations, save seconds);
    each validation holds its iteration, split, seconds, seconds in
    ``metric_cal`` and launches."""
    from avr_torch.train import runner as runner_lib

    vals, saves, metric_s = [], [], [0.0]
    validate, save, metric_cal = runner.validate, runner.save_checkpoint, runner_lib.metric_cal

    def timed_validate(it, mode_set="test", dirs=None):
        c0, m0, t0 = launch_counts(), metric_s[0], time.perf_counter()
        out = validate(it, mode_set, dirs)
        vals.append({"it": it, "mode": mode_set, "s": time.perf_counter() - t0,
                     "metric_cal_s": metric_s[0] - m0, "launches": since(c0)})
        return out

    def timed_save():
        t0 = time.perf_counter()
        step = save()
        saves.append(time.perf_counter() - t0)
        return step

    def timed_metric_cal(*a, **k):
        t0 = time.perf_counter()
        out = metric_cal(*a, **k)
        metric_s[0] += time.perf_counter() - t0
        return out

    runner.validate, runner.save_checkpoint, runner_lib.metric_cal = timed_validate, timed_save, timed_metric_cal
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        runner.train()
    finally:
        runner_lib.metric_cal = metric_cal
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, launch_counts(), torch.cuda.max_memory_allocated(dev), vals, saves


def check_runner_run(runner, launches, vals, encodes: int, npz_keys=()) -> dict:
    """The checks of a RUNNER_ITERATIONS run with checkpoints and
    validations every 2: the step, the checkpoints, finite train losses
    and metrics of both splits, each test validation's npz (with
    ``npz_keys``), ``encodes`` forward launches per validation render batch
    and ``encodes`` + ``encodes`` per training iteration. Returns the
    run's part of the phase record."""
    import numpy as np

    from avr_torch.train import runner as runner_lib

    tc, T = runner.cfg.train, runner.cfg.model.signal_output_dim
    bs, n_test, n_train = runner.batch_size, len(runner.test_data), len(runner.train_data)
    check(int(runner.state.step) == RUNNER_ITERATIONS, f"runner step {int(runner.state.step)}")
    check(runner.checkpoint_steps() == [2, 4], f"checkpoints {runner.checkpoint_steps()}")
    m = read_jsonl(os.path.join(runner.logdir, "metrics.jsonl"))
    loss = m.get("train_loss", {})
    check(sorted(loss) == [1, 2, 3, 4] and all(np.isfinite(list(loss.values()))), f"train_loss {loss}")
    for mode in ("test", "train"):
        for it in (2, 4):
            got = {k: m.get(f"{mode}_metric/{k}", {}).get(it) for k in runner_lib.METRIC_KEYS}
            check(all(v is not None and np.isfinite(v) for v in got.values()), f"{mode}_metric@{it}: {got}")
    for it in (2, 4):
        with np.load(os.path.join(runner.logdir, "val_result", f"val_iter{it:06d}.npz")) as z:
            p = z["pred_sig"]
            check(p.shape == (n_test, T // 2 + 1) and p.dtype == np.complex64 and np.isfinite(p).all()
                  and all(k in z.files for k in npz_keys), f"val_iter{it:06d}.npz pred_sig {p.shape} {p.dtype}")
    # the validations' launches: the forward encodes and no backward per render batch
    val_launch = {k: sum(v["launches"][k] for v in vals) for k in launches}
    for v in vals:
        n_rows = n_test if v["mode"] == "test" else min(n_train, runner_lib.TRAIN_VAL_BATCHES * bs)
        n_b = -(-n_rows // bs)
        want = counts(encode=encodes * n_b)
        check(v["launches"] == want, f"validate {v['mode']}@{v['it']}: launches {v['launches']} != {want}")
        v["batches"] = n_b
    train_launch = {k: launches[k] - val_launch[k] for k in launches}
    want = counts(encode=encodes * RUNNER_ITERATIONS, encode_bwd=encodes * RUNNER_ITERATIONS)
    check(train_launch == want, f"training iterations' launches {train_launch} != {want}")

    sps = m["samples_per_sec"]
    iter_ms = {it: bs / sps[it] * 1e3 for it in sorted(sps)}
    # the interval logged at `it` holds iteration it alone unless it-1 saved or validated
    steady = [iter_ms[it] for it in iter_ms if it > 1 and (it - 1) % tc.save_freq and (it - 1) % tc.val_freq]
    return {
        "iterations": RUNNER_ITERATIONS, "batch": bs, "rays": runner.cfg.render.n_rays,
        "shells": runner.cfg.render.n_samples, "T": T, "compute_dtype": tc.compute_dtype,
        "rows": {"train": n_train, "test": n_test},
        "ms_per_iteration": iter_ms, "steady_ms_per_iteration": sum(steady) / len(steady),
        "validate_s": {mode: [v["s"] for v in vals if v["mode"] == mode] for mode in ("test", "train")},
        "validate_batches": {v["mode"]: v["batches"] for v in vals},
        "metric_cal_share": sum(v["metric_cal_s"] for v in vals) / sum(v["s"] for v in vals),
        "launches": launches, "train_launches": train_launch,
        "launches_per_iteration": {k: v / RUNNER_ITERATIONS for k, v in train_launch.items()},
        "validation_launches": val_launch,
        "launches_per_validation_batch": {k: v / sum(x["batches"] for x in vals) for k, v in val_launch.items()},
        "test_metric_4": {k: m[f"test_metric/{k}"][4] for k in runner_lib.METRIC_KEYS}, "train_loss": loss,
    }


def check_render_cli(torch, dev, tmp, runner, resumed, encodes: int, keys=()):
    """``python -m avr_torch render`` from ``runner``'s last checkpoint on the
    test split of ``resumed`` (the optional query columns ``keys``), against
    ``make_render_fn(resumed)`` called on the CLI's batches (another batch
    shape rounds differently): bit-equal spectra, finite IRs, ``encodes``
    forward launches per batch. Returns (render launches, the timed render
    ms per batch)."""
    import numpy as np

    from avr_torch import __main__ as cli
    from avr_torch.eval.rotate import make_render_fn

    data, T, bs = resumed.test_data, runner.cfg.model.signal_output_dim, runner.batch_size
    n_test = len(data)
    q = os.path.join(tmp, "queries.npz")
    np.savez(q, pos_rx=data.pos_rx, pos_tx=data.pos_tx, **{k: getattr(data, k) for k in keys})
    out = os.path.join(tmp, "irs.npz")
    conf = os.path.join(runner.logdir, "avr_conf.yml")
    c0 = launch_counts()
    cli.main(["render", "--config", conf, "--queries", q, "--out", out, "--time_domain", "--device", str(dev)])
    render_launch = since(c0)
    check(n_test % bs == 0, f"{n_test} test rows are no whole batches of {bs}")
    render_fn = make_render_fn(resumed)
    cols = dict(pos_rx=data.pos_rx, pos_tx=data.pos_tx, **{k: getattr(data, k) for k in keys})
    batches = [{k: v[s : s + bs] for k, v in cols.items()} for s in range(0, n_test, bs)]

    def render():  # ends in a copy to the host
        return np.concatenate([render_fn(**b) for b in batches])

    ref = render()
    with np.load(out) as z:
        spec, ir = z["spec"], z["ir"]
    check(spec.shape == (n_test, T // 2 + 1) and spec.dtype == np.complex64 and np.isfinite(spec).all(),
          f"render spec {spec.shape} {spec.dtype}")
    check(np.array_equal(spec, ref), f"render CLI differs from make_render_fn: max {np.abs(spec - ref).max()}")
    check(ir.shape == (n_test, T) and np.isfinite(ir).all(), f"render ir {ir.shape}")
    want = counts(encode=encodes * -(-n_test // bs))
    check(render_launch == want, f"render launches {render_launch} != {want}")
    t0 = time.perf_counter()
    for _ in range(RENDER_REPEATS):
        render()
    return render_launch, (time.perf_counter() - t0) / (RENDER_REPEATS * len(batches)) * 1e3


def phase_runner_array(torch, dev, cfg, results) -> None:
    """The port's runner and CLI on the array recipe ``cfg`` at full width,
    on port-written data of ARRAY_GROUPS groups: train RUNNER_ITERATIONS
    iterations with checkpoints and validations every 2
    (``AVRRunner.train``), resume on the card and on the CPU, ``python -m
    avr_torch render`` from the checkpoint and ``rotate``, in a temporary
    directory that is removed at the end. Only the schedule and the log
    directory of ``cfg`` are overridden."""
    import copy
    import shutil
    import tempfile

    import numpy as np

    from avr_torch import __main__ as cli
    from avr_torch.data.synthetic import RoomSpec, write_real_env_dataset
    from avr_torch.train import runner as runner_lib

    rc, tc, T = cfg.render, cfg.train, cfg.model.signal_output_dim
    tmp = tempfile.mkdtemp(prefix="avr_runner_array_")
    try:
        d = os.path.join(tmp, "data")
        write_real_env_dataset(d, RoomSpec(speed=rc.speed, fs=rc.fs, seq_len=T), ARRAY_GROUPS, seed=0)
        tc.total_iterations, tc.save_freq, tc.val_freq, tc.log_freq = RUNNER_ITERATIONS, 2, 2, 1
        cfg.path.logdir = os.path.join(tmp, "logs")
        runner = runner_lib.AVRRunner(cfg, d, device=dev)
        train_s, launches, peak, vals, saves = instrumented_train(torch, dev, runner)
        run = check_runner_run(runner, launches, vals, encodes=3, npz_keys=("ch_idx",))

        # resume: on the device bit-equal, on the CPU equal params
        cfg2 = copy.deepcopy(cfg)
        cfg2.train.load_ckpt = True
        resumed = runner_lib.AVRRunner(cfg2, d, device=dev)
        check(equal_states(torch, resumed.state, runner.state), "resumed state differs from the trained one")
        t0 = time.perf_counter()
        resumed.load_checkpoint()
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        on_cpu = runner_lib.AVRRunner(cfg2, d, device="cpu")
        check(equal_states(torch, on_cpu.state, runner.state), "CPU restore differs from the trained state")
        t0 = time.perf_counter()
        on_cpu.load_checkpoint()
        restore_cpu_s = time.perf_counter() - t0
        del on_cpu
        ckpt_bytes = os.path.getsize(os.path.join(runner.logdir, "ckpts", "4", runner_lib.CHECKPOINT_FILE))

        # render from the checkpoint through the CLI, against make_render_fn
        render_launch, render_ms = check_render_cli(torch, dev, tmp, runner, resumed, 3, keys=("ch_idx",))

        # rotate the test groups by 90° steps and re-render them
        rot_dir = os.path.join(tmp, "rotate")
        conf = os.path.join(runner.logdir, "avr_conf.yml")
        c0 = launch_counts()
        cli.main(["rotate", "--config", conf, "--dataset_dir", d, "--deg_step", "90", "--out_dir", rot_dir,
                  "--device", str(dev)])
        rotate_launch = since(c0)
        with np.load(os.path.join(rot_dir, "val_rotate_pred.npz")) as z:
            rot_pred, n_rot = z["pred_sig"], len(z["pred_deg"])
        check(os.path.exists(os.path.join(rot_dir, "summary.csv")) and np.isfinite(rot_pred).all(),
              "rotate outputs")
        check(rotate_launch["encode"] == 3 * n_rot and rotate_launch["encode_bwd"] == 0,
              f"rotate launches {rotate_launch} for {n_rot} rotations")

        rec = {
            "phase": "runner_array", **run, "train_s": train_s,
            "checkpoint_bytes": ckpt_bytes, "save_s": saves, "restore_s": restore_s,
            "restore_cpu_s": restore_cpu_s, "render_ms_per_batch": render_ms,
            "peak_mem_bytes": peak, "render_launches": render_launch,
            "rotate": {"rotations": n_rot, "launches": rotate_launch},
            "train_array_steady_ms_per_step": results["array_steady_ms"],
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["runner"] = rec
    emit(rec)


def phase_native_decode(results) -> None:
    """The port's native npy/wav decoder (``avr_torch.native``, g++, host
    code) on this machine: its build (seconds, ``g++ --version``); every
    WAV layout it must take against the plain numpy decode (mono bit-equal,
    a downmix within rtol 1e-6 or one float32 ulp of full scale, 2^-23);
    its time against the plain decode (median of DECODE_REPEATS, files in
    the page cache) on a RAF set of NATIVE_RAF_FILES and a MeshRIR set of
    NATIVE_MESHRIR_FILES files written by the port, with equal results;
    and its -(i + 1) error on a missing file, named and counted."""
    import ctypes
    import glob
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from avr_torch import native
    from avr_torch.data import loaders
    from avr_torch.data import wav as wav_lib
    from avr_torch.data.synthetic import RoomSpec, write_meshrir_dataset, write_raf_dataset

    cxx = native.compiler()
    check(cxx is not None, "no g++ on PATH: the native decoder cannot be built")
    cached = native.lib_path(cxx).exists()
    t0 = time.perf_counter()
    lib = native.get_lib()
    rec = {"phase": "native_decode", "compiler": native.compiler_version(cxx).splitlines()[0],
           "built": not cached, "build_s": time.perf_counter() - t0, "cpu_count": os.cpu_count()}
    tmp = tempfile.mkdtemp(prefix="avr_native_")
    try:
        # every layout, at the flagship's RAF window (1600 samples, stride 3)
        rng = np.random.default_rng(0)
        layouts = [(f, 1, False, False) for f in wav_lib.SAMPLE_FORMATS] + [
            ("pcm16", 2, False, False), ("float32", 2, False, False), ("pcm32", 2, False, False),
            ("float64", 3, False, False), ("pcm24", 1, True, False), ("float32", 2, True, False),
            ("pcm16", 1, False, True), ("pcm8", 2, True, True),
        ]
        formats = {}
        for fmt, ch, ext, odd in layouts:
            name = f"{fmt}-{ch}ch{'-ext' if ext else ''}{'-oddchunk' if odd else ''}"
            p = os.path.join(tmp, f"{name}.wav")
            x = rng.uniform(-0.95, 0.95, (6000, ch) if ch > 1 else 6000)
            wav_lib.write_wav_as(p, x, 48000, fmt, extensible=ext,
                                 chunks_before_data=[(b"LIST", b"abc")] if odd else ())
            got = native.load_wav_batch([p], 1600, 3)
            plain = loaders._decode_wav_plain([p], 1600, 3)
            err = float(np.abs(got - plain).max())
            if ch == 1:
                check(np.array_equal(got, plain), f"native decode of {name} differs from numpy: {err}")
            else:
                ok = np.abs(got - plain) <= np.maximum(1e-6 * np.abs(plain), 2.0**-23)
                check(bool(ok.all()), f"native downmix of {name}: max |err| {err}")
            formats[name] = err
        rec["formats_max_abs_err"] = formats

        room = RoomSpec(speed=346.8, fs=16000, seq_len=1600)
        t0 = time.perf_counter()
        write_raf_dataset(os.path.join(tmp, "raf"), room, n=NATIVE_RAF_FILES, seed=0)
        write_meshrir_dataset(os.path.join(tmp, "mesh"), room, n=NATIVE_MESHRIR_FILES, seed=0)
        rec["write_s"] = time.perf_counter() - t0
        wavs = sorted(glob.glob(os.path.join(tmp, "raf", "*", "*", "rir.wav")))
        npys = sorted(glob.glob(os.path.join(tmp, "mesh", "*", "ir_*.npy")))
        check(len(wavs) == NATIVE_RAF_FILES and len(npys) == NATIVE_MESHRIR_FILES, "timing sets")
        down = 48000 // room.fs
        start = int(9100 / down)
        native.reset_counts()
        for name, paths, nat, plain in (
            ("raf_wav", wavs, lambda: native.load_wav_batch(wavs, room.seq_len, down),
             lambda: loaders._decode_wav_plain(wavs, room.seq_len, down)),
            ("meshrir_npy", npys, lambda: native.load_npy_batch(npys, room.seq_len, down, start),
             lambda: loaders._decode_npy_plain(npys, room.seq_len, down, start)),
        ):
            ms = {"native": [], "plain": []}
            for _ in range(DECODE_REPEATS):
                t0 = time.perf_counter()
                got = nat()
                ms["native"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                ref = plain()
                ms["plain"].append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(got, ref), f"{name}: native decode differs from numpy")
            med = {k: statistics.median(v) for k, v in ms.items()}
            rec[name] = {
                "files": len(paths), "bytes": sum(os.path.getsize(p) for p in paths),
                "native_ms": med["native"], "plain_ms": med["plain"], "runs_ms": ms,
                "native_files_per_s": len(paths) / med["native"] * 1e3,
                "plain_files_per_s": len(paths) / med["plain"] * 1e3,
                "plain_over_native": med["plain"] / med["native"],
            }
        want = {"calls": 2 * DECODE_REPEATS, "files": DECODE_REPEATS * (len(wavs) + len(npys)), "rejected": 0}
        check(native.COUNTS == want, f"decoder counts {native.COUNTS} != {want}")

        # the error path: file 2 of 5 is missing
        paths = wavs[:5]
        paths[2] = os.path.join(tmp, "missing.wav")
        arr = (ctypes.c_char_p * 5)(*[os.fsencode(p) for p in paths])
        out = np.empty((5, 16), np.float32)
        rc = lib.avr_load_wav_batch(arr, 5, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 16, 1)
        check(rc == -3, f"missing file 2 of 5: return code {rc}")
        native.reset_counts()
        try:
            native.load_wav_batch(paths, 16)
            check(False, "a batch with a missing file decoded")
        except native.Rejected as e:
            check(e.path == paths[2], f"rejected {e.path}, not the missing file")
        check(native.COUNTS == {"calls": 1, "files": 0, "rejected": 1}, f"decoder counts {native.COUNTS}")
        rec["missing_file_rc"] = rc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["native_decode"] = rec
    emit(rec)


def phase_runner_flagship(torch, dev, results) -> None:
    """The flagship RAF recipe (``flagship_config()`` at full width) through
    the runner on port-written RAF data decoded by the native decoder:
    FLAGSHIP_RAF_FILES samples (64 train, 16 test), loaded by
    ``AVRRunner(cfg, d)``; decoded files and rejected batches counted, and
    the loaded splits held bit-equal to a load through the plain decode.
    Then RUNNER_ITERATIONS iterations with checkpoints and validations
    every 2 (5 + 5 encode launches per iteration, 5 + 0 per validation
    batch, no scatter), params moved, bit-equal resume on the card, and
    ``python -m avr_torch render`` from the checkpoint with ``rot_tx``. Only
    the schedule and the log directory of the config are overridden."""
    import copy
    import shutil
    import tempfile

    import numpy as np

    from avr_torch import native
    from avr_torch.data import loaders
    from avr_torch.data.synthetic import RoomSpec, write_raf_dataset
    from avr_torch.flagship import flagship_config
    from avr_torch.train import runner as runner_lib
    from avr_torch.train.state import named_leaves

    cfg = flagship_config()
    rc, tc, T = cfg.render, cfg.train, cfg.model.signal_output_dim
    tmp = tempfile.mkdtemp(prefix="avr_runner_flagship_")
    try:
        d = os.path.join(tmp, "data")
        write_raf_dataset(d, RoomSpec(speed=rc.speed, fs=rc.fs, seq_len=T), n=FLAGSHIP_RAF_FILES, seed=0)
        tc.total_iterations, tc.save_freq, tc.val_freq, tc.log_freq = RUNNER_ITERATIONS, 2, 2, 1
        cfg.path.logdir = os.path.join(tmp, "logs")
        native.reset_counts()
        t0 = time.perf_counter()
        runner = runner_lib.AVRRunner(cfg, d, device=dev)
        setup_s = time.perf_counter() - t0
        decoded = dict(native.COUNTS)
        check(decoded == {"calls": 2, "files": FLAGSHIP_RAF_FILES, "rejected": 0}, f"decoder counts {decoded}")
        n_train, n_test = len(runner.train_data), len(runner.test_data)
        check((n_train, n_test) == (64, 16), f"RAF splits {n_train} / {n_test}")

        # the same splits through the plain decode
        batched = loaders._batched_wav
        loaders._batched_wav = loaders._decode_wav_plain
        try:
            plain = [loaders.load_dataset(d, "RAF", eval=e, seq_len=T, fs=rc.fs) for e in (False, True)]
        finally:
            loaders._batched_wav = batched
        for data, ref in zip((runner.train_data, runner.test_data), plain):
            for f in ("wave", "pos_rx", "pos_tx", "rot_tx"):
                a, b = getattr(data, f), getattr(ref, f)
                check(a is not None and a.dtype == b.dtype and np.array_equal(a, b),
                      f"{f} loaded through the native decoder differs from the plain decode")

        before = {n: t.clone() for n, t in named_leaves(runner.state.params)}
        train_s, launches, peak, vals, saves = instrumented_train(torch, dev, runner)
        run = check_runner_run(runner, launches, vals, encodes=5)
        unchanged = [n for n, t in named_leaves(runner.state.params) if torch.equal(t, before[n])]
        check(not unchanged, f"params unchanged by the runner: {unchanged}")
        del before

        cfg2 = copy.deepcopy(cfg)
        cfg2.train.load_ckpt = True
        resumed = runner_lib.AVRRunner(cfg2, d, device=dev)
        check(equal_states(torch, resumed.state, runner.state), "resumed state differs from the trained one")
        t0 = time.perf_counter()
        resumed.load_checkpoint()
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(runner.logdir, "ckpts", "4", runner_lib.CHECKPOINT_FILE))
        render_launch, render_ms = check_render_cli(torch, dev, tmp, runner, resumed, 5, keys=("rot_tx",))
        rec = {
            "phase": "runner_flagship", **run, "decoder": decoded, "setup_s": setup_s, "train_s": train_s,
            "checkpoint_bytes": ckpt_bytes, "save_s": saves, "restore_s": restore_s,
            "render_ms_per_batch": render_ms, "render_launches": render_launch, "peak_mem_bytes": peak,
            "train_flagship_steady_ms_per_step": results["flagship_steady_ms"],
        }
        rec["iteration_over_step"] = rec["steady_ms_per_iteration"] / results["flagship_steady_ms"]
        del runner, resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    results["runner_flagship"] = rec
    emit(rec)


def population_trials(cfg):
    """POP_K runtime-variant trials of the array recipe ``cfg``: the known-good
    seed trial and POP_K − 1 asked from a fresh study, as configs."""
    from avr_torch.hpo.runner import update_config
    from avr_torch.hpo.study import Study

    study = Study("population_array", n_startup=4)
    study.enqueue_trial(SEED_TRIAL)
    return [update_config(cfg, 0, t.number, t, "runtime") for t in (study.ask() for _ in range(POP_K))]


def compare_lane(torch, k, lane_after, lane_before, serial_after, pop_bundle, serial_bundle):
    """Lane k of a population step against a single-trial step of that trial
    from the same state, batch and directions. The two differ by cuBLAS's
    batched against single matmuls and by the order of the table gradient's
    atomics, which moves gradients by about 1e-6 of their scale. The loss
    terms (forward only, no atomics) are held to 1e-3 of each term. Adam
    turns that noise into a large update difference only for the few
    entries whose gradient is within it of 0 (on a fresh state each entry
    moves by lr·g/(|g| + eps), so such an entry can move the other way): per
    leaf, at most 10% of the entries (at least one) may differ in their
    update (after − before) by more than 1% of the leaf's largest
    single-trial move, and no entry by more than twice that move. On the
    array recipe up to 2.7% of a leaf's entries did, all at the first step.
    A lane given another trial's bundle differs in nearly every entry. The
    update's relative L2 difference is printed."""
    terms = {}
    for name, a, b in zip(serial_bundle._fields, pop_bundle, serial_bundle):
        a, b = float(a[k]), float(b)
        terms[name] = abs(a - b) / max(abs(b), 1e-12)
        check(abs(a - b) <= 1e-3 * abs(b) + 1e-12, f"lane {k} loss {name}: {a} against the single-trial step's {b}")
    check(int(lane_after.step) == int(serial_after.step), f"lane {k} step count")
    updates, failures = compare_updates(torch, f"lane {k}", lane_after.params, lane_before.params, serial_after.params)
    check(not failures, "; ".join(failures))
    return {"loss_rel_err": max(terms.values()), **updates}


def compare_updates(torch, label, after, before, reference):
    """The update after − before of every leaf against the reference
    update reference − before (``compare_lane``'s rule): at most 10% of a
    leaf's entries (at least one) may differ by more than 1% of the leaf's
    largest reference move, and none by more than twice that move. Returns
    (the worst relative L2 difference and the worst share, with their
    leaves, and per leaf with more than 1% of its entries off: that share
    and the share of those entries whose reference move is below half the
    largest, i.e. whose gradient is within Adam's eps of 0 on a fresh
    state; the rule's violations, as messages)."""
    from avr_torch.train.state import named_leaves

    worst_rel, worst_leaf, worst_share, share_leaf = 0.0, None, 0.0, None
    leaves, failures = {}, []
    before = dict(named_leaves(before))
    ref = dict(named_leaves(reference))
    for n, p in named_leaves(after):
        d_got, d_ref = p - before[n], ref[n] - before[n]
        diff, move = (d_got - d_ref).abs(), float(d_ref.abs().max())
        rel = float(torch.linalg.vector_norm(d_got - d_ref) / torch.linalg.vector_norm(d_ref).clamp_min(1e-30))
        if rel > worst_rel:
            worst_rel, worst_leaf = rel, n
        off = diff > 1e-2 * move
        n_off = int(off.sum())
        if n_off / diff.numel() > worst_share:
            worst_share, share_leaf = n_off / diff.numel(), n
        if n_off > 0.01 * diff.numel():
            small = int((off & (d_ref.abs() < 0.5 * move)).sum())
            leaves[n] = {"share_off": n_off / diff.numel(), "off_with_small_move": small / n_off}
        if n_off > max(1, 0.1 * diff.numel()):
            failures.append(f"{label} leaf {n}: {n_off} of {diff.numel()} entries' updates differ from the reference step's")
        if float(diff.max()) > 2 * move + 1e-12:
            failures.append(f"{label} leaf {n}: an entry moves beyond twice the reference step's largest move")
    return {"worst_update_rel_l2": worst_rel, "worst_leaf": worst_leaf, "worst_share_off": worst_share,
            "worst_share_leaf": share_leaf, "leaves_off": leaves}, failures


def phase_population_array(torch, dev, profile_dir, results):
    """Population training of the array recipe at full width, bf16 compute:
    POP_K runtime-variant trials (``population_trials``) per step, TRAIN_STEPS
    steps on the port-written set of ``train_array``. Per step: 3 + 3 launches
    of the K-trial encode wrappers and none of the single-table ones (read
    just after the step, the counts set to 0 just before); finite losses;
    each lane against a single-trial step of its trial from the lane's state
    before the step (``compare_lane``), whose times give the serial rate."""
    from avr_torch import geometry
    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.train.state import (
        init_state, lane, make_hparams, make_train_step, named_leaves, stack_hparams, stack_states,
    )

    cfg = array_config()
    tcfgs = population_trials(cfg)
    tc, rc = tcfgs[0].train, cfg.render
    hps = [make_hparams(c.train, dev) for c in tcfgs]
    lrs = [c.train.lr for c in tcfgs]
    check(len(set(lrs)) == POP_K and lrs[0] == SEED_TRIAL["lr"], f"trial learning rates {lrs}")
    batches, data_rec = array_batches(torch, dev, cfg)
    fst = field.build_field(cfg.model, cfg.path.dataset_type)
    consts = make_consts(rc, cfg.model.signal_output_dim, device=dev)
    crit = CriterionConfig.from_configs(tc, rc)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = stack_states([init_state(gen, fst, tc, device=dev)] * POP_K)
    init = {n: t.clone() for n, t in named_leaves(state.params)}
    hp = stack_hparams(hps)
    step_pop, _ = make_train_step(fst, consts, rc, tc, crit, population=POP_K)
    step_one, _ = make_train_step(fst, consts, rc, tc, crit)
    dgen = torch.Generator(device=dev).manual_seed(1)
    pop_ms, serial_ms, peaks, lanes, bundles = [], [], [], [], []
    per_step = []
    for i in range(TRAIN_STEPS):
        batch = batches[i % len(batches)]
        dirs = geometry.ray_directions(rc.n_azi, rc.n_ele, generator=dgen, device=dev)
        before = clone_state(torch, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        state, bundle = step_pop(state, batch, dirs, hp)
        torch.cuda.synchronize()
        pop_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        peaks.append(torch.cuda.max_memory_allocated(dev))
        per_step.append(launches)
        check(launches == counts(encode_pop=3, encode_bwd_pop=3),
              f"population step {i}: launches {launches}, want 3 + 3 of the K-trial encodes")
        vals = {k: v.tolist() for k, v in bundle.as_dict().items()}
        bundles.append(vals)
        for name, v in vals.items():
            check(all(x == x and abs(x) != float("inf") for x in v), f"population step {i}: {name} {v}")
        check(all(x > 0 for x in vals["das_reg"]), f"the DAS regression term is zero: {vals}")
        step_lanes = []
        for k in range(POP_K):
            lb = lane(before, k)
            t0 = time.perf_counter()
            s_k, b_k = step_one(lb, batch, dirs, hps[k])
            torch.cuda.synchronize()
            serial_ms.append({"step": i, "ms": (time.perf_counter() - t0) * 1e3})
            step_lanes.append(compare_lane(torch, k, lane(state, k), lb, s_k, bundle, b_k))
            del s_k, lb
        lanes.append(step_lanes)
        del before
    check(state.step.tolist() == [TRAIN_STEPS] * POP_K, f"population step counts {state.step.tolist()}")
    for n, t in named_leaves(state.params):
        for k in range(POP_K):
            check(not torch.equal(t[k], init[n][k]), f"lane {k} leaf {n} did not move")
        for k in range(1, POP_K):
            check(not torch.equal(t[k], t[0]), f"lanes 0 and {k} of leaf {n} are equal")
    pop_steady = sum(pop_ms[1:]) / (len(pop_ms) - 1)
    ser = [r["ms"] for r in serial_ms if r["step"] > 0]
    serial_steady = sum(ser) / len(ser)
    rec = {
        "phase": "population_array", "K": POP_K, "steps": TRAIN_STEPS, "compute_dtype": tc.compute_dtype,
        "batch": tc.batch_size, "rays": rc.n_rays, "shells": rc.n_samples, "T": cfg.model.signal_output_dim,
        "trials": [{k: c.train.__dict__[k] for k in ("lr", "eta_min", "weight_decay", "spec_loss_weight",
                                                      "time_loss_weight", "das_reg_loss_weight")}
                   for c in tcfgs],
        "step_ms": pop_ms, "steady_ms_per_step": pop_steady, "serial_step_ms": serial_ms,
        "serial_steady_ms_per_step": serial_steady,
        "trial_steps_per_s": POP_K / (pop_steady / 1e3), "serial_trial_steps_per_s": 1 / (serial_steady / 1e3),
        "trial_throughput_gain": (POP_K / pop_steady) / (1 / serial_steady),
        "peak_mem_bytes": max(peaks), "peak_mem_per_step": peaks,
        # the peak includes the lanes' pre-step copy (params, mu, nu)
        "state_snapshot_bytes": 3 * sum(t.numel() * t.element_size() for t in init.values()),
        "launches_per_step": per_step[-1], "lanes": lanes, "losses_last": bundles[-1], "data": data_rec,
        "train_array_steady_ms_per_step": results.get("array_steady_ms"),
    }
    results["population"] = {"launches": {k: sum(c[k] for c in per_step) for k in per_step[0]},
                             "steady_ms": pop_steady}
    emit(rec)
    if profile_dir:
        profile_step(torch, lambda st, b, d: step_pop(st, b, d, hp), state, batches[0], dirs, pop_steady,
                     profile_dir, "population_array_step")


def state_on(state, device):
    """A train state's tensors on ``device`` (a copy where it moves them)."""
    from avr_torch.train.state import AdamState, TrainState, tree_map

    def to(tree):
        return tree_map(lambda t: t.detach().to(device), tree)

    return TrainState(to(state.params), AdamState(to(state.opt_state.mu), to(state.opt_state.nu)),
                      state.step.detach().to(device))


def clone_state(torch, state):
    """A copy of a train state on the device (the lanes' state before a step)."""
    from avr_torch.train.state import AdamState, TrainState, tree_map

    return TrainState(tree_map(torch.clone, state.params),
                      AdamState(tree_map(torch.clone, state.opt_state.mu), tree_map(torch.clone, state.opt_state.nu)),
                      state.step.clone())


def phase_hpo_cli(torch, dev, results):
    """``python -m avr_torch hpo --pop POP_K --variant runtime`` on the
    array recipe with its iteration budget cut to 2 (``total_iterations``,
    ``val_freq``, ``save_freq``; nothing else), on the port-written set:
    POP_K trials told with finite objectives, each logdir with its
    val_iter npz, and the K-trial encodes' launches as derived from the
    loop (2 steps, one validation render of the test split)."""
    import sqlite3
    import shutil
    import tempfile

    from avr_torch import __main__ as cli
    from avr_torch.data.synthetic import RoomSpec, write_real_env_dataset

    cfg = array_config()
    rc, T = cfg.render, cfg.model.signal_output_dim
    tmp = tempfile.mkdtemp(prefix="avr_hpo_cli_")
    try:
        d = os.path.join(tmp, "data")
        write_real_env_dataset(d, RoomSpec(speed=rc.speed, fs=rc.fs, seq_len=T), ARRAY_GROUPS, seed=0)
        cfg.train.total_iterations, cfg.train.val_freq, cfg.train.save_freq = 2, 2, 2
        cfg.path.logdir = os.path.join(tmp, "logs")
        yml = os.path.join(tmp, "hpo.yml")
        cfg.to_yaml(yml)
        db = os.path.join(tmp, "study.db")
        torch.cuda.synchronize(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(["hpo", "--config", yml, "--dataset_dir", d, "--variant", "runtime", "--pop", str(POP_K),
                  "--n_trials", str(POP_K), "--storage", f"sqlite:///{db}", "--device", str(dev)])
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        rows = sqlite3.connect(db).execute("SELECT number, state, value FROM trials ORDER BY number").fetchall()
        check([(n, st) for n, st, _ in rows] == [(k, "COMPLETE") for k in range(POP_K)], f"study rows {rows}")
        check(all(v is not None and v == v and abs(v) != float("inf") for _, _, v in rows), f"objectives {rows}")
        npzs = []
        for k in range(POP_K):
            npz = os.path.join(cfg.path.logdir, f"synthetic_array_param_{k}_1", "val_result", "val_iter000002.npz")
            check(os.path.exists(npz), f"missing {npz}")
            npzs.append(npz)
        n_test = 8  # the last of ARRAY_GROUPS groups
        want = counts(encode_pop=3 * 2 + 3 * -(-n_test // cfg.train.batch_size), encode_bwd_pop=3 * 2)
        check(launches == want, f"hpo --pop launches {launches} != {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "hpo_cli_population", "K": POP_K, "trials": len(rows),
           "objectives": [v for _, _, v in rows], "wall_s": wall_s, "launches": launches}
    results["hpo_cli"] = rec
    emit(rec)


def params_digest(torch, params) -> str:
    """sha256 over the bytes of every leaf, in tree order."""
    import hashlib

    from avr_torch.train.state import named_leaves

    h = hashlib.sha256()
    for n, t in named_leaves(params):
        h.update(n.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_grad_norms(torch):
    """Inside: the global L2 norm (on the device; each leaf's in fp32, their
    combination in fp64) of the gradients that each optimizer step is given
    (under a plan, after their all-reduce), appended to the yielded list."""
    from avr_torch.train import state as tstate

    real, norms = tstate.apply_optimizer, []

    def recording(state, grads, *args, **kwargs):
        leaves = [torch.linalg.vector_norm(g).double() for _, g in tstate.named_leaves(grads)]
        norms.append(torch.linalg.vector_norm(torch.stack(leaves)))
        return real(state, grads, *args, **kwargs)

    tstate.apply_optimizer = recording
    try:
        yield norms
    finally:
        tstate.apply_optimizer = real


@contextlib.contextmanager
def recorded_encode_calls():
    """Inside: the inputs of every encode forward and backward that the
    field runs (``models/hashgrid.py``'s calls of the two wrappers), the
    table and the cotangent cloned, appended to the yielded lists."""
    from avr_torch.models import hashgrid

    real_fwd, real_bwd = hashgrid.encode_rows, hashgrid.encode_backward
    calls = {"encode": [], "encode_bwd": []}

    def fwd(table, levels, x, round_bf16=False):
        calls["encode"].append((table.detach().clone(), levels, x, round_bf16))
        return real_fwd(table, levels, x, round_bf16=round_bf16)

    def bwd(g, levels, x, n_rows, round_bf16=False):
        calls["encode_bwd"].append((g.detach().clone(), levels, x, n_rows, round_bf16))
        return real_bwd(g, levels, x, n_rows, round_bf16=round_bf16)

    hashgrid.encode_rows, hashgrid.encode_backward = fwd, bwd
    try:
        yield calls
    finally:
        hashgrid.encode_rows, hashgrid.encode_backward = real_fwd, real_bwd


def check_encode_calls(torch, calls) -> list:
    """Each recorded encode call again through its wrapper on the card,
    against its plain version on the same inputs, by ``phase_encode_array``'s
    rules for the forward (bf16 bit-equal, fp32 within 1e-6 of scale); the
    backward row by row within the bound of two fp32 sums of the row's terms
    taken in different orders (below). One record per call, with ``ok``."""
    from avr_torch.ops import hashgrid_encode as he

    recs = []
    for table, levels, x, rb in calls["encode"]:
        ref = he.encode_rows_reference(table, levels, x, round_bf16=rb)
        got = he.encode_rows(table, levels, x, round_bf16=rb)
        scale, err, n_diff = float(ref.abs().max()), float((got - ref).abs().max()), int((got != ref).sum())
        recs.append({"kernel": "encode", "N": x.shape[0], "n_rows": table.shape[0], "bf16": rb,
                     "max_abs_err": err, "scale": scale, "values_differ": n_diff,
                     "ok": n_diff == 0 if rb else err <= 1e-6 * scale})
        del ref, got
    u = 2.0 ** -24  # fp32 unit roundoff
    for g, levels, x, n_rows, rb in calls["encode_bwd"]:
        ref = he.encode_backward_reference(g, levels, x, n_rows, round_bf16=rb)
        got = he.encode_backward(g, levels, x, n_rows, round_bf16=rb)
        again = he.encode_backward_reference(g, levels, x, n_rows, round_bf16=rb)
        scale, err = float(ref.abs().max()), float((got - ref).abs().max())
        plain_err = float((again - ref).abs().max())
        del again
        # Kernel and plain version add the same terms in fp32 in different
        # orders (the plain version's index_add_ itself in no fixed order),
        # so each is within gamma_n · Σ|t| of the exact sum of a row of n
        # terms (gamma_n = n·u / (1 - n·u), any order) and the two within
        # twice that.
        idx = he.corners_reference(levels, x)[0].long()
        n = torch.bincount(idx[(idx >= 0) & (idx < n_rows)], minlength=n_rows).double()[:, None]
        del idx
        abs_sum = he.encode_backward_reference(g.abs(), levels, x, n_rows, round_bf16=rb).double()
        bound = 2 * n * u / (1 - n * u) * abs_sum
        ratio = float(((got - ref).abs().double() / bound).nan_to_num(0.0, posinf=float("inf")).max())
        recs.append({"kernel": "encode_bwd", "N": x.shape[0], "n_rows": n_rows, "bf16": rb,
                     "max_abs_err": err, "scale": scale, "plain_vs_plain_max_abs_err": plain_err,
                     "max_terms_per_row": int(n.max()), "worst_err_over_bound": ratio, "ok": ratio <= 1.0})
        del ref, got, n, abs_sum, bound
    return recs


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_rank(rank: int, world: int, n_data: int, tmp: str, name: str, port: int) -> None:
    """One rank of a ``parallel_array`` run, spawned by the phase with the
    environment torchrun gives a rank (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` localhost, ``MASTER_PORT`` ``port``).
    It goes through the port's multi-device entry: ``initialize_multihost``
    with a bare ``cuda`` and gloo (every rank on cuda:0 of the one card),
    ``make_mesh_plan``, and ``AVRRunner(..., mesh_plan=)`` on the
    port-written set in ``tmp/data`` with its logs in ``tmp/logs_{name}``
    (the seed state broadcast from rank 0). Then PARALLEL_STEPS of the
    runner's plan step on the phase's batches and directions, each followed
    by ``save_checkpoint`` (rank 0 writes, every rank waits). Every
    ``all_reduce`` is timed to a synchronise on either side (the wait for
    the other ranks included) and the global norm of the all-reduced
    gradient is recorded. The encode calls of the first step are recorded
    and, after it, held against their plain versions
    (``check_encode_calls``). Writes ``rank{r}_{name}.json``."""
    import torch
    import torch.distributed as dist

    from avr_torch.parallel.mesh import initialize_multihost, make_mesh_plan
    from avr_torch.train.runner import AVRRunner
    from avr_torch.train.state import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dev = initialize_multihost("cuda", "gloo")
    real = dist.all_reduce
    try:
        check(dev == torch.device("cuda", 0), f"rank {rank}: gloo with a bare cuda gave {dev}")
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
        cfg = array_config()
        cfg.path.logdir = os.path.join(tmp, f"logs_{name}")
        tc = cfg.train
        plan = make_mesh_plan(batch_size=tc.batch_size, data_parallel=n_data)
        check((plan.n_data, plan.n_ray, plan.rank) == (n_data, world // n_data, rank), f"rank {rank}: plan {plan}")
        runner = AVRRunner(cfg, os.path.join(tmp, "data"), device=dev, mesh_plan=plan)
        init_digest = params_digest(torch, runner.state.params)
        rays, weights = plan.shard_rays(inputs["dirs"][0].to(dev))
        reduces = []

        def timed(tensor, *args, **kwargs):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = real(tensor, *args, **kwargs)
            torch.cuda.synchronize(dev)
            reduces.append((tensor.numel() * tensor.element_size(), (time.perf_counter() - t0) * 1e3))
            return out

        dist.all_reduce = timed
        steps, encode_checks = [], None
        for i in range(PARALLEL_STEPS):
            batch = tree_map(lambda t: t.to(dev), inputs["batches"][i])
            dirs = inputs["dirs"][i].to(dev)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reduces.clear()
            reset_launch_counts()
            with recorded_grad_norms(torch) as norms, \
                    (recorded_encode_calls() if i == 0 else contextlib.nullcontext()) as calls:
                t0 = time.perf_counter()
                runner.state, bundle = runner._step_fn(runner.state, batch, dirs)
                torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
            launches = launch_counts()
            steps.append({"ms": ms, "launches": launches, "losses": {k: float(v) for k, v in bundle.as_dict().items()},
                          "grad_norm": float(norms[0]) if len(norms) == 1 else None,
                          "all_reduce_calls": len(reduces), "all_reduce_bytes": sum(b for b, _ in reduces),
                          "all_reduce_ms": sum(t for _, t in reduces), "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
            runner.save_checkpoint()
            if i == 0:
                # let the recorded inputs go before the steady step, whose peak memory is recorded
                encode_checks = check_encode_calls(torch, calls)
                del calls
                torch.cuda.empty_cache()
        dist.all_reduce = real
        runner.writer.close()
        rows = plan.rows(tc.batch_size)
        rec = {"rank": rank, "device": str(dev), "plan": [plan.n_data, plan.n_ray], "rows": [rows.start, rows.stop],
               "rays": rays.shape[0], "padded_rays": 0 if weights is None else int((weights == 0).sum()),
               "steps": steps, "step": int(runner.state.step),
               "checkpoints": runner.checkpoint_steps(), "encode_checks": encode_checks,
               "init_digest": init_digest, "digest": params_digest(torch, runner.state.params)}
        with open(os.path.join(tmp, f"rank{rank}_{name}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


def phase_parallel_array(torch, dev, smi: str, results) -> None:
    """The data × ray plan (``avr_torch/parallel``) on the array recipe at
    full width, bf16 compute: for each of PARALLEL_RUNS, ranks spawned with
    torchrun's environment join gloo through the port's entry, all on the
    card ``dev``, and take PARALLEL_STEPS steps of ``AVRRunner``'s plan step
    from its seed state on the first batches of the port-written set and
    directions drawn in the parent (``parallel_rank``). Each step is held
    against a single-process step in the parent from the same state (the
    seed's, then rank 0's checkpoint of the previous step), batch and
    directions: every rank's loss terms within 1e-4 and the global norm of
    its all-reduced gradient within 1e-3 (summed, not averaged), rank 0's
    update by ``compare_updates``. Params bit-equal across ranks and to rank
    0's last checkpoint, one checkpoint per step written by rank 0 alone,
    3 + 3 encode launches per rank per step, and every rank's encode calls
    of its first step (its rows and its ray slice, padded rays included)
    held against the plain versions. The record is printed before the
    checks fail. A failed rank fails the phase
    (``torch.multiprocessing.spawn`` raises)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from avr_torch import geometry
    from avr_torch.data.synthetic import RoomSpec, write_real_env_dataset
    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.train.state import AdamState, TrainState, init_state, make_train_step, tree_map

    cfg = array_config()
    tc, rc, T = cfg.train, cfg.render, cfg.model.signal_output_dim
    batches, data_rec = array_batches(torch, dev, cfg)
    run = [batches[i % len(batches)] for i in range(PARALLEL_STEPS)]
    dgen = torch.Generator(device=dev).manual_seed(1)
    dirs = [geometry.ray_directions(rc.n_azi, rc.n_ele, generator=dgen, device=dev) for _ in run]
    fst = field.build_field(cfg.model, cfg.path.dataset_type)
    consts = make_consts(rc, T, device=dev)
    step, _ = make_train_step(fst, consts, rc, tc, CriterionConfig.from_configs(tc, rc))

    def single_step(state, i):
        """Step i in this process from ``state`` (host tensors or on the card):
        (state before, state after, both on the host; ms; loss terms; the
        gradient's global norm)."""
        state = state_on(state, dev)
        before = state_on(state, "cpu")
        torch.cuda.synchronize(dev)
        with recorded_grad_norms(torch) as norms:
            t0 = time.perf_counter()
            state, bundle = step(state, run[i], dirs[i])
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        after = state_on(state, "cpu")
        del state
        torch.cuda.empty_cache()
        return before, after, ms, {k: float(v) for k, v in bundle.as_dict().items()}, float(norms[0])

    first = single_step(init_state(torch.Generator(device=dev).manual_seed(tc.seed), fst, tc, device=dev), 0)
    init_digest = params_digest(torch, first[0].params)

    records, failures = {}, []
    tmp = tempfile.mkdtemp(prefix="avr_parallel_")
    try:
        write_real_env_dataset(os.path.join(tmp, "data"), RoomSpec(speed=rc.speed, fs=rc.fs, seq_len=T),
                               ARRAY_GROUPS, seed=0)
        torch.save({"batches": [tree_map(lambda t: t.cpu(), b) for b in run], "dirs": [d.cpu() for d in dirs]},
                   os.path.join(tmp, "inputs.pt"))
        for name, world, n_data in PARALLEL_RUNS:
            t0 = time.perf_counter()
            mp.spawn(parallel_rank, args=(world, n_data, tmp, name, free_port()), nprocs=world, join=True)
            wall_s = time.perf_counter() - t0
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}_{name}.json")) as f:
                    ranks.append(json.load(f))
            logdir = os.path.join(tmp, f"logs_{name}", cfg.path.expname)
            ckpts = sorted(os.listdir(os.path.join(logdir, "ckpts")), key=int)
            rank0 = [torch.load(os.path.join(logdir, "ckpts", str(i + 1), "state.pt"), weights_only=True)
                     for i in range(PARALLEL_STEPS)]
            with open(os.path.join(logdir, "command_log.txt")) as f:
                command_lines = len(f.read().splitlines())
            # the single-process reference of each step, from rank 0's state before it
            refs = [first] + [
                single_step(TrainState(s["params"], AdamState(s["mu"], s["nu"]), s["step"]), i)
                for i, s in enumerate(rank0[:-1], start=1)
            ]
            n_ray = world // n_data
            per_rank = -(-rc.n_rays // n_ray)
            padded = per_rank * n_ray - rc.n_rays
            rows_per_rank = tc.batch_size // n_data
            if [r["plan"] for r in ranks] != [[n_data, n_ray]] * world:
                failures.append(f"{name}: plans {[r['plan'] for r in ranks]}")
            if any(r["device"] != str(dev) for r in ranks):
                failures.append(f"{name}: rank devices {[r['device'] for r in ranks]}")
            if any((r["rays"], r["padded_rays"]) != (per_rank, padded * (r["rank"] % n_ray == n_ray - 1)) for r in ranks):
                failures.append(f"{name}: ray slices {[(r['rays'], r['padded_rays']) for r in ranks]}")
            if any(r["init_digest"] != init_digest for r in ranks):
                failures.append(f"{name}: a rank's initial params differ from the seed's")
            if len({r["digest"] for r in ranks}) != 1:
                failures.append(f"{name}: the ranks' params are not bit-equal")
            if params_digest(torch, rank0[-1]["params"]) != ranks[0]["digest"]:
                failures.append(f"{name}: rank 0's last checkpoint is not the ranks' params")
            want_ckpts = [str(i + 1) for i in range(PARALLEL_STEPS)]
            if ckpts != want_ckpts or any(r["checkpoints"] != list(range(1, PARALLEL_STEPS + 1)) for r in ranks):
                failures.append(f"{name}: checkpoints {ckpts}, seen by the ranks {[r['checkpoints'] for r in ranks]}")
            if command_lines != 1:
                failures.append(f"{name}: {command_lines} lines in command_log.txt, want rank 0's one")
            terms, norm_errs = [0.0] * PARALLEL_STEPS, [0.0] * PARALLEL_STEPS
            for r in ranks:
                if r["step"] != PARALLEL_STEPS:
                    failures.append(f"{name} rank {r['rank']}: step count {r['step']}")
                for i, (st, ref) in enumerate(zip(r["steps"], refs)):
                    if st["launches"] != counts(encode=3, encode_bwd=3):
                        failures.append(f"{name} rank {r['rank']} step {i}: launches {st['launches']}, want 3 + 3")
                    for k, b in ref[3].items():
                        a = st["losses"][k]
                        terms[i] = max(terms[i], abs(a - b) / max(abs(b), 1e-12))
                        if not (a == a and abs(a) != float("inf") and abs(a - b) <= 1e-4 * abs(b) + 1e-12):
                            failures.append(f"{name} rank {r['rank']} step {i}: {k} {a} against the single-process step's {b}")
                    a, b = st["grad_norm"], ref[4]
                    if a is None or not abs(a - b) <= 1e-3 * b:
                        failures.append(f"{name} rank {r['rank']} step {i}: gradient norm {a} against the "
                                        f"single-process step's {b}")
                    else:
                        norm_errs[i] = max(norm_errs[i], abs(a - b) / b)
                checks = r["encode_checks"]
                failures += [f"{name} rank {r['rank']}: {c['kernel']} at N = {c['N']} (bf16 {c['bf16']}) "
                             f"off its plain version, max|err| {c['max_abs_err']} of {c['scale']}, "
                             f"{c.get('worst_err_over_bound')} of the summation bound"
                             for c in checks if not c["ok"]]
                for kernel in ("encode", "encode_bwd"):
                    seen = sorted(c["N"] for c in checks if c["kernel"] == kernel)
                    if len(seen) != 3 or per_rank not in seen or rows_per_rank * per_rank * rc.n_samples not in seen:
                        failures.append(f"{name} rank {r['rank']}: {kernel} held at N = {seen}, want its "
                                        f"{per_rank} rays and {rows_per_rank} × {per_rank} × {rc.n_samples} points")
            updates = []
            for i, (ref, got) in enumerate(zip(refs, rank0)):
                u, f = compare_updates(torch, f"{name} step {i}", got["params"], ref[0].params, ref[1].params)
                updates.append(u)
                failures += f
            steady = [r["steps"][-1] for r in ranks]
            records[name] = {
                "world": world, "data": n_data, "ray": n_ray, "rays_per_rank": per_rank, "padded_rays": padded,
                "rows_per_rank": rows_per_rank, "wall_s": wall_s, "loss_rel_err_per_step": terms,
                "grad_norm_rel_err_per_step": norm_errs, "single_grad_norm_per_step": [ref[4] for ref in refs],
                "updates_per_step": updates,
                "encode_checks_per_rank": [
                    [{k: v for k, v in c.items() if k not in ("n_rows", "ok")}
                     for c in r["encode_checks"]]
                    for r in ranks
                ],
                "single_step_ms": [ref[2] for ref in refs],
                "step_ms": [[st["ms"] for st in r["steps"]] for r in ranks],
                "steady_ms_per_rank": [st["ms"] for st in steady],
                "all_reduce_ms_per_rank": [st["all_reduce_ms"] for st in steady],
                "all_reduce_bytes_per_step": steady[0]["all_reduce_bytes"],
                "all_reduce_calls_per_step": steady[0]["all_reduce_calls"],
                "peak_mem_bytes_per_rank": [st["peak_mem_bytes"] for st in steady],
                "launches_per_rank_per_step": steady[0]["launches"],
            }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "parallel_array", "steps": PARALLEL_STEPS, "compute_dtype": tc.compute_dtype,
           "batch": tc.batch_size, "rays": rc.n_rays, "shells": rc.n_samples, "T": T,
           "backend": "gloo", "entry": "initialize_multihost + AVRRunner(mesh_plan=)",
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "runs": records, "data": data_rec}
    results["parallel"] = records
    emit(rec)
    check(not failures, "parallel_array: " + "; ".join(failures))


def profile_step(torch, step, state, batch, gen, steady_ms: float, profile_dir: str, name: str) -> None:
    """One more train step under torch.profiler: the kernel table and the
    trace go to ``profile_dir`` as ``{name}_kernels.txt`` and
    ``{name}_trace.json``; prints the step's device kernel time, its share
    of the unprofiled steady step, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(profile_dir, f"{name}_kernels.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(profile_dir, f"{name}_trace.json")
    prof.export_chrome_trace(trace)
    emit({"phase": f"profile_{name}", "written": profile_dir, **trace_summary(trace, steady_ms)})


def trace_summary(trace_path: str, steady_ms: float) -> dict:
    """Device kernel time of a chrome trace, by kernel name (first 80
    characters), and its share of a step of ``steady_ms``."""
    with open(trace_path) as f:
        kern = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "kernel"]
    check(bool(kern), "the profiler recorded no device kernels")
    by_name = {}
    for e in kern:
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + e["dur"] / 1e3
    busy_ms = sum(by_name.values())
    by_kind = {}
    for name, ms in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in TRACE_KINDS if any(s in low for s in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {
        "by_kind_ms": by_kind,
        "kernels_launched": len(kern), "device_kernel_ms": busy_ms,
        "profiled_span_ms": (max(e["ts"] + e["dur"] for e in kern) - min(e["ts"] for e in kern)) / 1e3,
        "busy_share_of_steady_step": busy_ms / steady_ms,
        "port_kernels_ms": {
            k: v for k, v in by_name.items() if any(s in k.lower() for s in dict(TRACE_KINDS)["port"])
        },
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
    }


def array_entry(results, key: str) -> dict:
    """The array path's numbers of one kernel for the ``kernels`` line:
    launches per step (precomputed plan, and the streaming step), and per
    stream its time, error, plain, bound and library numbers (fp32, with
    the step's bf16 mode beside where it has one)."""
    entry = {
        "launches_per_step": results["array_launches"][key] / TRAIN_STEPS,
        "streaming_launches_per_step": results["array_streaming_launches"][key],
    }
    for stream, rec in results["encode_array"].items():
        if key == "scatter":
            a = rec["kernel_a_scatter"]
            entry[stream] = {
                **{k: a[k] for k in ("max_abs_err", "scale", "kernel_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "zero_fill_ms")},
                **{f"{part}_ms": a[part]["kernel_ms"] for part in ("dense_levels", "hashed_levels")},
                **{k: a["all"][k] for k in ("runs", "reds", "row_reds", "smem_row_share")},
            }
            continue
        kind = "forward" if key == "encode" else "backward"
        fp, bf = rec[f"{kind}_fp32"], rec.get(f"{kind}_bf16", {})
        entry[stream] = {
            "N": rec["N"], "n_rows": rec["n_rows"], **fp, "ms": fp["kernel_ms"],
            "bf16_ms": bf.get("kernel_ms"), "bf16_device_ms": bf.get("device_ms"),
            "bf16_max_abs_err": bf.get("max_abs_err"),
        }
    return entry


def population_entry(results, key: str) -> dict:
    """The K-trial numbers of one encode kernel for the ``kernels`` line:
    launches of its K-trial wrapper in population_array's steps and in the
    hpo CLI run, and at the pos stream its time (fp32, the step's bf16
    beside) against POP_K single-table launches, bound and error."""
    kind = "forward" if key == "encode" else "backward"
    pos = results["encode_population"]["pos"]
    fp, bf = pos[f"{kind}_fp32"], pos[f"{kind}_bf16"]
    return {
        "K": POP_K, "launches": results["population"]["launches"][f"{key}_pop"],
        "launches_per_step": results["population"]["launches"][f"{key}_pop"] / TRAIN_STEPS,
        "hpo_cli_launches": results["hpo_cli"]["launches"][f"{key}_pop"],
        "ms": fp["kernel_ms"], "device_ms": fp["device_ms"], "k1_loop_ms": fp["k1_loop_ms"],
        "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"], "max_abs_err": fp["max_abs_err"],
        "plain_ms": fp["plain_ms"], "library_ms": fp["library_ms"],
        "bf16_ms": bf["kernel_ms"], "bf16_k1_loop_ms": bf["k1_loop_ms"],
        "bf16_max_abs_err": bf["max_abs_err"],
        "dir": {k: results["encode_population"]["dir"][f"{kind}_fp32"][k]
                for k in ("kernel_ms", "device_ms", "k1_loop_ms", "bound_ms", "library_ms", "max_abs_err")},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None, help="directory for a torch.profiler trace of one extra step")
    ap.add_argument("--kernel-a-earlier", default=None, metavar="SOURCE",
                    help="a hash_scatter.cu of an earlier commit: kernel A built from it is timed beside the repo's")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from avr_torch.flagship import flagship_config
    from avr_torch.models import field
    from avr_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    a = torch.randn((64, 32), device=dev).to(torch.bfloat16)
    b = torch.randn((32, 16), device=dev).to(torch.bfloat16)
    mm = torch.mm(a, b, out_dtype=torch.float32)
    check(mm.dtype == torch.float32, "bf16 × bf16 → fp32 matmul")
    bmm = torch.bmm(a[None].expand(2, -1, -1), b[None].expand(2, -1, -1), out_dtype=torch.float32)
    check(bmm.dtype == torch.float32 and torch.equal(bmm[1], mm), "batched bf16 × bf16 → fp32 matmul")
    ptxas = {
        n: [ln.strip() for ln in r.splitlines() if "registers" in ln or "spill" in ln]
        for n, r in _build.PTXAS_REPORT.items()
    }
    emit({
        "phase": "device_and_build", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda, "built": built,
        "build_s": build_s, "ptxas": ptxas,
    })

    results = {}
    cfg = flagship_config()
    static = field.build_field(cfg.model, "RAF").encodings["pos"].grid
    x = flagship_points(torch, dev, cfg, seed=0)
    earlier = earlier_kernel_a(torch, args.kernel_a_earlier) if args.kernel_a_earlier else None
    phase_scatter(torch, dev, static, x, results, earlier)
    phase_encode(torch, dev, cfg, static, x, results)
    phase_encode_bwd(torch, dev, cfg, static, x, results)
    phase_small_parity(torch, dev)
    phase_train(torch, dev, args.profile, results)

    acfg = array_config()
    afst = field.build_field(acfg.model, acfg.path.dataset_type)
    ax, aview = step_points(torch, dev, acfg, seed=0, lo=0.5, hi=2.5)
    phase_encode_array(torch, dev, afst, ax, aview, results, earlier)
    phase_encode_population(torch, dev, afst, ax, aview, results)
    del ax, aview
    phase_small_standard(torch, dev)
    phase_train_array(torch, dev, args.profile, results)
    phase_runner_array(torch, dev, array_config(), results)
    phase_population_array(torch, dev, args.profile, results)
    phase_hpo_cli(torch, dev, results)
    phase_native_decode(results)
    phase_runner_flagship(torch, dev, results)
    torch.cuda.empty_cache()
    phase_parallel_array(torch, dev, smi, results)
    emit({"phase": "profiler_misses", **PROFILER_MISSES})

    kernels = (  # name, source, the TPU code it replaces, key of its results and launch count
        ("hash_scatter_add_rows", "hash_scatter.cu", "avr_tpu/ops/hash_scatter.py:872", "scatter"),
        ("hashgrid_encode_fwd", "hashgrid_encode.cu", "avr_tpu/models/hashgrid.py:434", "encode"),
        ("hashgrid_encode_bwd", "hashgrid_encode_bwd.cu", "avr_tpu/ops/hash_scatter.py:872", "encode_bwd"),
    )
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": f"avr_torch/ops/csrc/{src}", "replaces": replaces,
            "launches": results["launches"][key],
            "max_abs_err": results[key]["max_abs_err"],
            "ms": results[key]["kernel_ms"], "kernel_ms": results[key]["kernel_ms"],
            "bf16_ms": results[key].get("bf16_kernel_ms"),
            "bf16_max_abs_err": results[key].get("bf16_max_abs_err"),
            "plain_ms": results[key]["plain_ms"], "bound_ms": results[key]["bound_ms"],
            "bound_by": results[key]["bound_by"], "library_ms": results[key]["library_ms"],
            "array": array_entry(results, key),
            **{phase: {
                "launches": results[rkey]["launches"][key],
                "launches_per_iteration": results[rkey]["launches_per_iteration"][key],
                "launches_per_validation_batch": results[rkey]["launches_per_validation_batch"][key],
            } for phase, rkey in (("runner_array", "runner"), ("runner_flagship", "runner_flagship"))},
            **({"population": population_entry(results, key)} if key != "scatter" else {}),
            "parallel_array": {name: {"launches_per_rank_per_step": r["launches_per_rank_per_step"][key],
                                      "ranks": r["world"]} for name, r in results["parallel"].items()},
        }
        for name, src, replaces, key in kernels
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
