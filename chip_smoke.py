#!/usr/bin/env python3
"""On-card smoke test of the avr_torch port (NVIDIA H100).

    python3 chip_smoke.py [--profile DIR]

Builds the port's CUDA kernels from ``avr_torch/ops/csrc`` (nvcc, cached
in ``build/avr_torch_kernels/``), holds each kernel against its plain
PyTorch version at the shapes of the flagship training step, checks the
card path against the plain CPU path on a small config, then drives the
port's flagship training step (full width, random weights from a seed)
and shows that it went through both kernels. Prints one JSON object per
phase, the ``nvidia-smi`` name/power line, a ``kernels`` summary, and as
its last line ``{"ok": true, "device": {...}}``. Any failed check raises
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

# Flagship train steps driven on the card; the first one is not steady.
TRAIN_STEPS = 3

# Device kernels of a profiled step, grouped by kind: the first kind with
# a key in the (lower-cased) kernel name.
TRACE_KINDS = (
    ("port", ("hashgrid_encode_kernel", "scatter_add_rows_kernel")),
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


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def flagship_points(torch, dev, cfg, seed: int):
    """The flagship step's encoded points: x01 [bs·R·S, 3] in the unit cube."""
    from avr_torch import geometry
    from avr_torch.render.common import make_consts

    g = torch.Generator(device=dev).manual_seed(seed)
    rc, bs = cfg.render, cfg.train.batch_size
    consts = make_consts(rc, cfg.model.signal_output_dim, device=dev)
    rays_o = torch.rand((bs, 3), generator=g, device=dev) * 4 - 2
    dirs = geometry.ray_directions(rc.n_azi, rc.n_ele, generator=g, device=dev)
    pts = geometry.ray_points(rays_o, dirs, consts.d_vals)
    lo = torch.tensor(rc.xyz_min, device=dev)
    hi = torch.tensor(rc.xyz_max, device=dev)
    pts_n = geometry.normalize_points(pts, lo, hi)
    return ((pts_n + 1.0) / 2.0).reshape(-1, 3).contiguous()


def phase_scatter(torch, dev, static, x, results):
    """Kernel A against index_add_ at the flagship pos_pair stream: the
    corner indices of the flagship points (from the plain encode)."""
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he

    table = torch.zeros((static.padded_entries, 4), device=dev)
    _, idx, _ = he.encode_rows_reference(table, static.levels, x)
    del table
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


def phase_encode(torch, dev, static, x, results):
    """Kernel B against its plain version at the flagship pos_pair encode."""
    from avr_torch.ops import hashgrid_encode as he

    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn((static.padded_entries, 4), generator=g, device=dev)
    levels = static.levels
    N, L, F = x.shape[0], len(levels), 4
    out = {"phase": "kernel_b_encode", "N": N, "levels": L, "F": F}
    ref, ridx, rw = he.encode_rows_reference(table, levels, x)
    got, gidx, gw = he.encode_rows(table, levels, x)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(torch.equal(gidx, ridx), "kernel B corner indices differ from the plain version")
    w_err = float((gw - rw).abs().max())
    check(w_err <= 1e-6, f"kernel B weights: max|err| {w_err} > 1e-6")
    check(err <= 1e-6 * scale, f"kernel B fp32: max|err| {err} > 1e-6 × {scale}")
    ref16, _, _ = he.encode_rows_reference(table, levels, x, round_bf16=True)
    got16, _, _ = he.encode_rows(table, levels, x, round_bf16=True)
    torch.cuda.synchronize()
    err16 = float((got16 - ref16).abs().max())
    # Both sides round the same gathered rows to bf16 before the fp32 sum.
    check(err16 <= 1e-6 * scale, f"kernel B bf16: max|err| {err16} > 1e-6 × {scale}")
    M = gidx.shape[0]
    rows = int(torch.unique(gidx).numel())
    b_ms, b_by = bound(N * 12 + rows * F * 4 + N * L * F * 4 + M * 8, M * 2 * F)
    rec = {
        "max_abs_err": err, "scale": scale, "bf16_max_abs_err": err16,
        "weights_max_abs_err": w_err, "corner_rows": M, "distinct_rows": rows,
        "kernel_ms": time_ms(lambda: he.encode_rows(table, levels, x)),
        "plain_ms": time_ms(lambda: he.encode_rows_reference(table, levels, x), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    out.update(rec)
    results["encode"] = rec
    emit(out)


def phase_small_parity(torch, dev):
    """The card path (kernels) against the CPU path (plain versions) on the
    small flagship config, fp32: forward 5e-5 and table gradients 1e-4 of scale."""
    from avr_torch import geometry
    from avr_torch.flagship import flagship_config
    from avr_torch.models import field
    from avr_torch.render.common import make_consts
    from avr_torch.render.fused import render_fused
    from avr_torch.train.state import named_leaves, tree_map

    cfg = flagship_config(small=True)
    fst = field.build_field(cfg.model, "RAF")
    params_cpu = field.init(torch.Generator().manual_seed(3), fst, device="cpu")
    # N(0,1) tables so that relative tolerances mean something
    gen = torch.Generator().manual_seed(4)
    for k, t in params_cpu["enc"].items():
        params_cpu["enc"][k] = torch.randn(t.shape, generator=gen)
    bs = cfg.train.batch_size
    inputs = {
        "rays_o": torch.rand((bs, 3), generator=gen) * 4 - 2,
        "position_tx": torch.rand((bs, 3), generator=gen) * 4 - 2,
        "direction_tx": torch.nn.functional.normalize(torch.randn((bs, 3), generator=gen), dim=-1),
        "dirs": geometry.ray_directions(cfg.render.n_azi, cfg.render.n_ele, generator=gen, device="cpu"),
    }
    target = torch.randn((bs, cfg.model.signal_output_dim // 2 + 1, 2), generator=gen)
    res = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.detach().to(d).requires_grad_(True), params_cpu)
        out = render_fused(
            params, fst, make_consts(cfg.render, cfg.model.signal_output_dim, device=d), cfg.render,
            **{k: v.to(d) for k, v in inputs.items()}, compute_dtype=None, shell_chunk=2,
        )
        torch.mean((out - target.to(d)) ** 2).backward()
        res[str(d)] = (out.detach().cpu(), {n: t.grad.cpu() for n, t in named_leaves(params)})
    (o_cpu, g_cpu), (o_dev, g_dev) = res["cpu"], res[str(dev)]
    fwd = float((o_dev - o_cpu).abs().max() / o_cpu.abs().max())
    check(fwd <= 5e-5, f"card vs CPU render forward: {fwd} > 5e-5 of scale")
    grad = {n: float((g_dev[n] - g_cpu[n]).abs().max() / (g_cpu[n].abs().max() + 1e-30)) for n in g_cpu}
    worst = max(grad, key=grad.get)
    check(grad[worst] <= 1e-4, f"card vs CPU gradient of {worst}: {grad[worst]} > 1e-4 of scale")
    emit({"phase": "small_card_vs_cpu", "forward_rel_err": fwd, "worst_grad": worst,
          "worst_grad_rel_err": grad[worst]})


def phase_train(torch, dev, profile_dir, results):
    """The port's flagship training step at full width, bf16 compute."""
    from avr_torch.flagship import flagship_config
    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.ops import hash_scatter as hs
    from avr_torch.ops import hashgrid_encode as he
    from avr_torch.render.common import make_consts
    from avr_torch.train.state import init_state, make_train_step, named_leaves

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
    before = {n: t.clone() for n, t in named_leaves(state.params)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    hs.scatter_add_rows.launches = 0
    he.encode_rows.launches = 0
    step_ms, bundles = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, bundle = step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bundles.append({k: float(v) for k, v in bundle.as_dict().items()})
    launches = {"scatter": hs.scatter_add_rows.launches, "encode": he.encode_rows.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    for i, b in enumerate(bundles):
        bad = [k for k, v in b.items() if v != v or v in (float("inf"), float("-inf"))]
        check(not bad, f"train step {i}: non-finite loss terms {bad}")
    check(int(state.step) == TRAIN_STEPS, f"step count {int(state.step)} != {TRAIN_STEPS}")
    unchanged = [n for n, t in named_leaves(state.params) if torch.equal(t, before[n])]
    check(not unchanged, f"params unchanged by training: {unchanged}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched by the training steps")
    results["launches"] = launches
    steady_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    emit({
        "phase": "train_flagship", "steps": TRAIN_STEPS, "compute_dtype": tc.compute_dtype,
        "batch": bs, "rays": rc.n_rays, "shells": rc.n_samples, "T": cfg.model.signal_output_dim,
        "step_ms": step_ms, "steady_ms_per_step": steady_ms,
        "rays_per_s_fwd_bwd": bs * rc.n_rays / (steady_ms / 1e3),
        "peak_mem_bytes": peak, "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "losses_last": bundles[-1],
    })
    if profile_dir:
        profile_step(torch, step, state, batch, gen, steady_ms, profile_dir)


def profile_step(torch, step, state, batch, gen, steady_ms: float, profile_dir: str) -> None:
    """One more train step under torch.profiler: the kernel table and the
    trace go to ``profile_dir``; prints the step's device kernel time, its
    share of the unprofiled steady step, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(profile_dir, "train_step_kernels.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(profile_dir, "train_step_trace.json")
    prof.export_chrome_trace(trace)
    emit({"phase": "profile", "written": profile_dir, **trace_summary(trace, steady_ms)})


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
            k: v for k, v in by_name.items()
            if "hashgrid_encode_kernel" in k or "scatter_add_rows_kernel" in k
        },
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
    }


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
    phase_encode(torch, dev, static, x, results)
    phase_small_parity(torch, dev)
    phase_train(torch, dev, args.profile, results)

    emit({"kernels": [
        {
            "name": "hash_scatter_add_rows", "route": "cuda",
            "source": "avr_torch/ops/csrc/hash_scatter.cu",
            "replaces": "avr_tpu/ops/hash_scatter.py:872",
            "launches": results["launches"]["scatter"],
            "max_abs_err": results["scatter"]["max_abs_err"],
            "ms": results["scatter"]["kernel_ms"], "kernel_ms": results["scatter"]["kernel_ms"],
            "plain_ms": results["scatter"]["plain_ms"], "bound_ms": results["scatter"]["bound_ms"],
            "bound_by": results["scatter"]["bound_by"], "library_ms": results["scatter"]["library_ms"],
        },
        {
            "name": "hashgrid_encode_fwd", "route": "cuda",
            "source": "avr_torch/ops/csrc/hashgrid_encode.cu",
            "replaces": "avr_tpu/models/hashgrid.py:434",
            "launches": results["launches"]["encode"],
            "max_abs_err": results["encode"]["max_abs_err"],
            "ms": results["encode"]["kernel_ms"], "kernel_ms": results["encode"]["kernel_ms"],
            "plain_ms": results["encode"]["plain_ms"], "bound_ms": results["encode"]["bound_ms"],
            "bound_by": results["encode"]["bound_by"], "library_ms": None,
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
