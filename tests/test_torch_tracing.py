"""The port's tracer (``avr_torch.utils.profiling``): spans kept on the host's
clock while it is on, nothing while it is off, always-on counters, and the
spans of one train step and of a render request at a small size on the CPU."""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from avr_torch.config import AVRConfig
from avr_torch.losses import CriterionConfig
from avr_torch.models import field
from avr_torch.render.common import make_consts
from avr_torch.train import state as st
from avr_torch.utils import profiling

ARRAY_RECIPE = Path(__file__).resolve().parents[1] / "configs" / "avr_synthetic_array.yml"
CHUNKS = 4


@pytest.fixture
def tracer():
    """The tracer on, emptied before and after; off again at the end."""
    profiling.drain()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.drain()


def _small_array_setup(population: int = 0):
    """The array recipe's model family at a size the CPU steps in a second:
    n_samples 8 in 4 checkpointed chunks of 2, the precomputed plan."""
    with open(ARRAY_RECIPE) as f:
        d = yaml.safe_load(f)
    d["render"].update(n_samples=8, n_azi=6, n_ele=3)
    d["model"]["signal_output_dim"] = 64
    for v in d["model"].values():
        if isinstance(v, dict) and "n_levels" in v:
            v.update(n_levels=2, log2_hashmap_size=6, base_resolution=2)
        if isinstance(v, dict) and "n_neurons" in v:
            v["n_neurons"] = 16
    d["train"].update(compute_dtype="float32", shell_chunk=8 // CHUNKS, remat=True,
                      runtime_hparams=bool(population))
    cfg = AVRConfig.from_dict(d)
    fst = field.build_field(cfg.model, cfg.path.dataset_type)
    consts = make_consts(cfg.render, cfg.model.signal_output_dim, device="cpu")
    crit = CriterionConfig.from_configs(cfg.train, cfg.render)
    step, render = st.make_train_step(fst, consts, cfg.render, cfg.train, crit, population=population)
    state = st.init_state(torch.Generator().manual_seed(0), fst, cfg.train, device="cpu")
    if population:
        state = st.stack_states([state] * population)
    rng = np.random.default_rng(0)
    F = cfg.model.signal_output_dim // 2 + 1
    batch = {
        "wave": torch.from_numpy((rng.normal(size=(8, F, 2)) * 1e-2).astype(np.float32)),
        "pos_rx": torch.from_numpy(rng.uniform(1, 5, (8, 3)).astype(np.float32)),
        "pos_tx": torch.from_numpy(rng.uniform(1, 5, (8, 3)).astype(np.float32)),
        "ch_idx": torch.arange(8, dtype=torch.int32),
    }
    hp = st.stack_hparams([st.make_hparams(cfg.train)] * population) if population else None
    return cfg, step, render, state, batch, hp


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


def test_off_tracer_records_nothing():
    profiling.drain()
    assert not profiling._on
    with profiling.span("a") as s, profiling.span("b"):
        pass
    assert s is None
    assert profiling.span("a") is profiling.span("b")  # one shared no-op, nothing allocated
    spans, counts = profiling.drain()
    assert spans == [] and counts == {}


def test_spans_nest_share_a_call_and_name_their_thread(tracer):
    seen = {}

    def worker():
        with tracer.span("worker"):
            seen["tid"] = threading.get_native_id()

    with tracer.span("outer"):
        with tracer.span("inner"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
        with tracer.span("second"):
            pass
    assert not t.is_alive()
    with tracer.span("next"):
        pass
    spans, _ = tracer.drain()
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["outer", "inner", "worker", "second", "next"]
    outer = by["outer"]
    assert outer["parent"] is None and outer["call"] == outer["id"]
    assert by["inner"]["parent"] == by["second"]["parent"] == outer["id"]
    # a span on another thread has no parent there, and joins the open call
    assert by["worker"]["parent"] is None and by["worker"]["call"] == outer["id"]
    assert by["worker"]["tid"] == seen["tid"] != outer["tid"] == threading.get_native_id()
    assert {by[n]["call"] for n in ("inner", "second")} == {outer["id"]}
    # a span opened after the call closed starts a call of its own
    assert by["next"]["call"] == by["next"]["id"] != outer["id"]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    assert outer["start_ns"] <= by["inner"]["start_ns"] <= by["inner"]["end_ns"] <= by["second"]["start_ns"]
    assert by["second"]["end_ns"] <= outer["end_ns"]
    assert tracer.drain() == ([], {})


def test_a_span_closed_by_an_exception_is_kept(tracer):
    with pytest.raises(ValueError):
        with tracer.span("outer"), tracer.span("raises"):
            raise ValueError("stop")
    with tracer.span("after"):
        pass
    spans, _ = tracer.drain()
    assert [s["name"] for s in spans] == ["outer", "raises", "after"]
    assert all(s["end_ns"] is not None for s in spans)
    assert spans[2]["parent"] is None and spans[2]["call"] == spans[2]["id"]


def test_count_and_drain():
    profiling.drain()
    profiling.count("a")
    profiling.count("a", 4)
    profiling.count("b", 2)
    assert profiling.counters() == {"a": 5, "b": 2}
    assert profiling.counters() == {"a": 5, "b": 2}  # reading does not clear
    spans, counts = profiling.drain()
    assert spans == [] and counts == {"a": 5, "b": 2}
    assert profiling.counters() == {} and profiling.drain() == ([], {})


def test_train_step_records_its_phases_and_the_recompute(tracer):
    """One step with remat: step > render > {render.context,
    render.attenuation, render.signal > render.chunk × n}, then criterion,
    backward (with n recompute chunks inside it) and optimizer."""
    _, step, _, state, batch, _ = _small_array_setup()
    dirs = torch.nn.functional.normalize(torch.randn(18, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    tracer.drain()
    step(state, batch, dirs)
    spans, counts = tracer.drain()
    by_id = {s["id"]: s for s in spans}
    top = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in top] == ["step"]
    stp = top[0]
    assert {s["call"] for s in spans} == {stp["id"]}
    assert _children(spans, stp) == ["render", "criterion", "backward", "optimizer"]
    render = next(s for s in spans if s["name"] == "render")
    assert _children(spans, render) == ["render.context", "render.attenuation", "render.signal"]
    signal = next(s for s in spans if s["name"] == "render.signal")
    assert _children(spans, signal) == ["render.chunk"] * CHUNKS
    chunks = [s for s in spans if s["name"] == "render.chunk"]
    assert len(chunks) == 2 * CHUNKS
    backward = next(s for s in spans if s["name"] == "backward")
    recompute = [c for c in chunks if c["parent"] != signal["id"]]
    assert len(recompute) == CHUNKS
    for c in recompute:  # on the CPU autograd runs the backward on the calling thread
        assert backward["start_ns"] <= c["start_ns"] <= c["end_ns"] <= backward["end_ns"]
        assert by_id[c["parent"]]["name"] == "backward"
    assert counts["render.chunk_calls"] == 2 * CHUNKS
    # the encode counters move only where a CUDA kernel is launched
    assert not any(k.startswith(("encode.", "scatter.", "corners.")) for k in counts)


def test_off_step_counts_chunks_and_records_no_span():
    profiling.drain()
    _, step, _, state, batch, _ = _small_array_setup()
    dirs = torch.nn.functional.normalize(torch.randn(18, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    step(state, batch, dirs)
    spans, counts = profiling.drain()
    assert spans == [] and counts == {"render.chunk_calls": 2 * CHUNKS, "render.feature_splits": 1}


def test_render_request_records_render_and_no_recompute(tracer):
    _, _, render, state, batch, _ = _small_array_setup()
    dirs = torch.nn.functional.normalize(torch.randn(18, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    with torch.inference_mode():
        render(state.params, batch, dirs)
    spans, counts = tracer.drain()
    assert [s["name"] for s in spans if s["parent"] is None] == ["render"]
    assert [s["name"] for s in spans].count("render.chunk") == CHUNKS
    assert counts == {"render.chunk_calls": CHUNKS, "render.feature_splits": 1}


def test_population_step_records_one_criterion_span(tracer):
    _, step, _, state, batch, hp = _small_array_setup(population=2)
    dirs = torch.nn.functional.normalize(torch.randn(18, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    step(state, batch, dirs, hp)
    spans, counts = tracer.drain()
    names = [s["name"] for s in spans]
    assert names.count("step") == names.count("criterion") == 1
    stp = spans[0]
    assert _children(spans, stp) == ["render", "criterion", "backward", "optimizer"]
    assert counts["render.chunk_calls"] == 2 * CHUNKS


def test_a_span_lands_on_the_profiler_trace_around_its_op(tracer, tmp_path):
    """The chrome trace's ts is (time_ns − baseTimeNanoseconds) / 1000: a span
    around an op, mapped so, contains the op's event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("sum"):
            torch.ones(256, 256).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    (s,), _ = tracer.drain()
    lo, hi = (s["start_ns"] - base) / 1e3, (s["end_ns"] - base) / 1e3
    sums = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("name") == "aten::sum"]
    assert sums  # the op and the overload it dispatches to
    for e in sums:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi


def test_encode_wrappers_count_launches_and_points(monkeypatch):
    """The wrappers' counters, with the launches replaced by shape-only
    stand-ins (tensors on the meta device take the kernel route), and
    ``chip_smoke.launch_counts`` reading them by its own keys."""
    import chip_smoke
    from avr_torch.ops import hashgrid_encode as he

    def encode(what, tables, levels, x, round_bf16):
        return torch.empty(tables.shape[0], x.shape[0], len(levels), tables.shape[-1], device="meta")

    def backward(what, g, levels, x, n_rows, round_bf16):
        return torch.empty(g.shape[0], n_rows, g.shape[-1], device="meta")

    monkeypatch.setattr(he, "_encode", encode)
    monkeypatch.setattr(he, "_encode_backward", backward)
    levels, x = [None, None], torch.empty(100, 3, device="meta")
    chip_smoke.reset_launch_counts()
    he.encode_rows(torch.empty(50, 2, device="meta"), levels, x)
    he.encode_rows(torch.empty(50, 2, device="meta"), levels, x)
    he.encode_rows_pop(torch.empty(4, 50, 2, device="meta"), levels, x)
    he.encode_backward(torch.empty(100, 2, 2, device="meta"), levels, x, 50)
    he.encode_backward_pop(torch.empty(4, 100, 2, 2, device="meta"), levels, x, 50)
    assert chip_smoke.launch_counts() == chip_smoke.counts(encode=2, encode_bwd=1, encode_pop=1, encode_bwd_pop=1)
    assert profiling.counters()["encode.points"] == 2 * 100 + 4 * 100
    chip_smoke.reset_launch_counts()
    assert chip_smoke.launch_counts() == chip_smoke.counts() and profiling.counters() == {}


def test_chip_smoke_holds_counted_step_calls_and_leaves_replays_to_the_trace():
    """``chip_smoke.check_step_calls`` on a stand-in step that counts as the
    graphed step does: eager, capture (which replays), then replays whose
    launch counts are copies. The copies are not held; a wrong count on a
    counted call, or graph counters out of order, fail."""
    import chip_smoke

    chip_smoke.reset_launch_counts()
    kinds = iter(["eager", "capture", "replay", "replay"])

    def step(n_encode):
        kind = next(kinds)
        profiling.count("encode.fwd_launches", n_encode)
        if kind == "eager":
            profiling.count("step.eager_calls")
        else:
            profiling.count("step.graph_captures", kind == "capture")
            profiling.count("step.graph_replays")

    calls = []
    counted = chip_smoke.recorded_calls(step, calls)
    for n in (2, 2, 7, 0):
        counted(n)
    want = chip_smoke.counts(encode=2)
    assert [chip_smoke.replayed(c) for c in calls] == [False, False, True, True]
    assert [c["launches"]["encode"] for c in calls] == [2, 2, 7, 0]
    assert chip_smoke.check_step_calls("stand-in", calls, want) == {"eager": 1, "captures": 1, "replays": 3}
    wrong = [calls[0], {**calls[1], "launches": chip_smoke.counts(encode=3)}] + calls[2:]
    with pytest.raises(AssertionError, match="call 1"):
        chip_smoke.check_step_calls("stand-in", wrong, want)
    with pytest.raises(AssertionError, match="graph counters"):
        chip_smoke.check_step_calls("stand-in", calls[1:], want)
    chip_smoke.reset_launch_counts()


def test_chip_smoke_counts_a_traces_kernels_by_name():
    """``chip_smoke.traced_kernels`` counts device kernels only, each by the
    name of its row of ``KERNELS``, the demangled and the mangled form, and
    matches ``kernel_launches`` of the same launches."""
    import chip_smoke

    def kernel(name, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": 1}

    events = [
        kernel("void hashgrid_encode_kernel<4, true>(float const*, float const*, avr::Levels, float*)"),
        kernel("void hashgrid_encode_kernel<2, false>(float const*, float const*, avr::Levels, float*)"),
        kernel("_Z26hashgrid_encode_bwd_kernelILi2ELb1EEvPKfS1_"),
        kernel("void (anonymous namespace)::mlp_act_bwd_kernel<2, __nv_bfloat16>(float const*)"),
        kernel("mlp_act_sum_kernel(float const*, int, int, int)"),
        kernel("signal_contract_fwd_kernel(float const*, float const*)"),
        kernel("signal_contract_bias_grad_kernel(float const*, float const*)"),
        kernel("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTT"),
        kernel("hashgrid_encode_kernel", cat="cpu_op"),
        {"ph": "i", "cat": "kernel", "name": "mlp_act_fwd_kernel"},
    ]
    launches = chip_smoke.counts(encode=1, encode_pop=1, encode_bwd_pop=1, mlp_act_bwd=1, contract=1)
    assert chip_smoke.traced_kernels(events) == chip_smoke.kernel_launches(launches)
    assert chip_smoke.kernel_launches(launches) == {
        "hash_scatter_add_rows": 0, "hashgrid_encode_fwd": 2, "hashgrid_encode_bwd": 1,
        "signal_contract_fwd": 1, "signal_contract_bwd": 0, "mlp_act_fwd": 0, "mlp_act_bwd": 1,
    }



def test_the_fork_handler_forgets_the_threads_id_and_stack(tracer, monkeypatch):
    """After a fork the child's thread has another native id: the handler
    registered with ``os.register_at_fork`` drops the cached one."""
    with tracer.span("before"):
        pass
    monkeypatch.setattr(threading, "get_native_id", lambda: -7)
    with tracer.span("cached"):
        pass
    tracer._forget_thread()
    with tracer.span("after"):
        pass
    spans, _ = tracer.drain()
    monkeypatch.undo()
    tracer._forget_thread()  # the real id again for later spans on this thread
    assert [s["tid"] for s in spans][1:] == [spans[0]["tid"], -7]
