#!/usr/bin/env python3
"""On-card smoke test of the avr_torch port (NVIDIA H100).

    python3 chip_smoke.py [--profile DIR]

Builds the port's CUDA kernels from ``avr_torch/ops/csrc`` (nvcc, cached
in ``build/avr_torch_kernels/``) and drives two paths of the port, each
at full width with random weights from a seed:

  * the flagship training step (complex field, ``avr_torch/flagship.py``);
  * the 8-channel array training step of ``configs/avr_synthetic_array.yml``
    (standard field with channel embeddings and DAS losses) on a synthetic
    Real_env dataset that the port writes, loads and samples, with the
    precomputed plan (``train_array``) and once with the streaming plan.

Before each path it holds each kernel against its plain PyTorch version
at that path's shapes and checks the card against the plain CPU path on a
small config of the same field variant; after it, it shows that the path
went through the encode forward and backward kernels (the generic scatter
kernel is held and timed, but is off both paths). Prints one JSON object
per phase, the ``nvidia-smi`` name/power line, a ``kernels`` summary, and
as its last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the exit code is non-zero. Without a CUDA device it exits with 2 and
prints no result.
"""

from __future__ import annotations

import argparse
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

ROOT = os.path.dirname(os.path.abspath(__file__))
ARRAY_CONFIG = os.path.join(ROOT, "configs", "avr_synthetic_array.yml")
# synthetic Real_env groups written for the array path: the last one is
# the test split, leaving 4 train groups = 32 rows
ARRAY_GROUPS = 5
# shell chunk of the array step's streaming run
STREAMING_SHELL_CHUNK = 8

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


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device kernel time of ``fn`` (torch.profiler, kernels and
    memsets summed): no host gaps, for launches too small to keep the card
    busy back to back."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
    check(bool(kern), "the profiler recorded no device kernels")
    return sum(e["dur"] for e in kern) / 1e3 / iters


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
    fills) upd [M, F] = w·g per corner, level-major as ``corners`` gives."""
    idx, w = he.corners(levels, x)
    N, F = x.shape[0], g.shape[-1]
    upd = torch.empty((idx.shape[0], F), device=x.device)
    groups, start = [], 0
    for lo, hi in he.level_groups(levels):
        n = (hi - lo) * levels[lo].K * N
        groups.append((lo, hi, levels[lo].K, start, n))
        start += n

    def mul():
        for lo, hi, K, s0, n in groups:
            torch.mul(w[s0 : s0 + n].view(hi - lo, K, N, 1), g[:, lo:hi].permute(1, 0, 2).unsqueeze(1),
                      out=upd[s0 : s0 + n].view(hi - lo, K, N, F))

    return idx, upd, mul


def phase_scatter(torch, dev, static, x, results):
    """The generic scatter kernel against index_add_ at the flagship pos_pair
    stream: the corner indices of the flagship points (plain version). Off
    the training path since the encode backward has its own kernel."""
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he

    idx, _ = he.corners_reference(static.levels, x)
    n_rows, M = static.padded_entries, idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"phase": "kernel_a_scatter", "M": M, "n_rows": n_rows}
    for F in (4, 2):
        upd = torch.randn((M, F), generator=g, device=dev)
        ref = hs.scatter_add_rows_reference(idx, upd, n_rows)
        got = hs.scatter_add_rows(idx, upd, n_rows)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= 1e-5 * scale, f"kernel A F={F}: max|err| {err} > 1e-5 × {scale}")
        buf = torch.zeros((n_rows, F), device=dev)

        def library():
            buf.zero_()
            buf.index_add_(0, idx, upd)

        b_ms, b_by = bound(M * 4 + M * F * 4 + n_rows * F * 4, M * F)
        rec = {
            "max_abs_err": err, "scale": scale,
            "kernel_ms": time_ms(lambda: hs.scatter_add_rows(idx, upd, n_rows)),
            "plain_ms": time_ms(lambda: hs.scatter_add_rows_reference(idx, upd, n_rows)),
            "library_ms": time_ms(library),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        out[f"F{F}"] = rec
        if F == 4:
            results["scatter"] = rec
            # Contention: the leading dense levels put m_dense updates on a few
            # thousand rows; time them apart from the hashed levels' updates.
            # Both launches zero the same n_rows-row output.
            m_dense = x.shape[0] * sum(lv.K for lv in static.levels[: static.hashed.index(True)])
            parts = {"dense_levels": slice(0, m_dense), "hashed_levels": slice(m_dense, M)}
            for name, s in parts.items():
                i_s, u_s = idx[s], upd[s]
                rec[name] = {
                    "M": i_s.shape[0], "distinct_rows": int(torch.unique(i_s).numel()),
                    "kernel_ms": time_ms(lambda: hs.scatter_add_rows(i_s, u_s, n_rows)),
                }
            rec["zero_fill_ms"] = time_ms(lambda: torch.zeros((n_rows, F), device=dev))
        del upd, ref, got, buf
    # Rows indexed outside [0, n_rows) are dropped on both sides.
    bad = idx[:4096].clone()
    bad[::7], bad[3::11] = n_rows, -1
    u = torch.randn((bad.shape[0], 4), generator=g, device=dev)
    ref = hs.scatter_add_rows_reference(bad, u, n_rows)
    err = float((hs.scatter_add_rows(bad, u, n_rows) - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= 1e-5 * scale, f"kernel A out-of-range rows: max|err| {err} > 1e-5 × {scale}")
    out["out_of_range"] = {"max_abs_err": err, "scale": scale}
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


def phase_encode_array(torch, dev, fst, x, view, results):
    """The encode pair against its plain versions at the array step's two
    large streams: ``pos`` (bs·R·S ray points, F = 2, in the bf16 rule the
    step runs and in fp32) and ``dir`` (the R view directions through the
    2^20-row table, fp32 as the step runs it). Forward fp32 within 1e-6 of
    scale and bf16 bit-equal; backward within 1e-5 of scale. The backward's
    library route is ``index_add_`` of the fp32 corner update stream (the
    stream itself not timed); the generic scatter kernel is held and timed
    on the same stream."""
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
        buf = torch.zeros((n_rows, F), device=dev)

        def library():
            buf.zero_()
            buf.index_add_(0, idx, upd)

        lib_ms = time_ms(library, iters=5)
        for mode in modes:
            rec[f"backward_{mode}"]["library_ms"] = lib_ms
        got = hs.scatter_add_rows(idx, upd, n_rows)
        torch.cuda.synchronize()
        scale, err = float(ref_fp32.abs().max()), float((got - ref_fp32).abs().max())
        check(err <= 1e-5 * scale, f"kernel A at the {name} stream: max|err| {err} > 1e-5 × {scale}")
        a_ms, a_by = bound(M * 4 + M * F * 4 + n_rows * F * 4, M * F)
        rec["kernel_a_scatter"] = {
            "max_abs_err": err, "scale": scale,
            "kernel_ms": time_ms(lambda: hs.scatter_add_rows(idx, upd, n_rows), iters=5),
            "plain_ms": time_ms(lambda: hs.scatter_add_rows_reference(idx, upd, n_rows), iters=3, warmup=1),
            "library_ms": lib_ms, "bound_ms": a_ms, "bound_by": a_by,
        }
        del idx, upd, mul, buf, got, ref_fp32, table, g
        out[name] = rec
    results["encode_array"] = {k: v for k, v in out.items() if k != "phase"}
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
    hs.scatter_add_rows.launches = 0
    he.encode_rows.launches = 0
    he.encode_backward.launches = 0
    step_ms, bundles = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, bundle = step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bundles.append({k: float(v) for k, v in bundle.as_dict().items()})
    launches = {
        "scatter": hs.scatter_add_rows.launches, "encode": he.encode_rows.launches,
        "encode_bwd": he.encode_backward.launches,
    }
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
    expected = {
        "scatter": 0,
        "encode": n_ctx + 2 * n_chunks * (2 if tcs.remat else 1),
        "encode_bwd": n_ctx + 2 * n_chunks,
    }
    step_s, _ = make_train_step(fst, consts, rc, tcs, crit)
    state, s_ms, s_bundles, s_launches, s_peak = drive_steps(torch, dev, step_s, state, run[:1], gen)
    check(s_launches == expected, f"streaming step launches {s_launches}, the plan predicts {expected}")
    results["array_streaming_launches"] = s_launches
    emit(train_record("train_array_streaming", cfg, s_ms, s_bundles, s_launches, s_peak,
                      point_budget=tcs.point_budget, shell_chunk=tcs.shell_chunk, n_chunks=n_chunks,
                      predicted_launches=expected))


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
            entry[stream] = rec["kernel_a_scatter"]
            continue
        kind = "forward" if key == "encode" else "backward"
        fp, bf = rec[f"{kind}_fp32"], rec.get(f"{kind}_bf16", {})
        entry[stream] = {
            "N": rec["N"], "n_rows": rec["n_rows"], **fp, "ms": fp["kernel_ms"],
            "bf16_ms": bf.get("kernel_ms"), "bf16_device_ms": bf.get("device_ms"),
            "bf16_max_abs_err": bf.get("max_abs_err"),
        }
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None, help="directory for a torch.profiler trace of one extra step")
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
    phase_scatter(torch, dev, static, x, results)
    phase_encode(torch, dev, cfg, static, x, results)
    phase_encode_bwd(torch, dev, cfg, static, x, results)
    phase_small_parity(torch, dev)
    phase_train(torch, dev, args.profile, results)

    acfg = array_config()
    afst = field.build_field(acfg.model, acfg.path.dataset_type)
    ax, aview = step_points(torch, dev, acfg, seed=0, lo=0.5, hi=2.5)
    phase_encode_array(torch, dev, afst, ax, aview, results)
    del ax, aview
    phase_small_standard(torch, dev)
    phase_train_array(torch, dev, args.profile, results)

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
