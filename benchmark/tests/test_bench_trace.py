"""The trace reduction on a hand-made chrome trace: busy time is the
union of device intervals, the span runs from the first step span to the
last device operation, gaps are named by the innermost host op."""

from __future__ import annotations

import pytest

from benchmark import devtrace
from benchmark.harness import reader


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(devtrace.SPAN, "user_annotation", 0.0, 50.0),
    _x(devtrace.SPAN, "user_annotation", 50.0, 40.0),
    _x("aten::mm", "cpu_op", 5.0, 10.0),
    _x("aten::copy_", "cpu_op", 60.0, 30.0),
    _x("cudaMemcpyAsync", "cuda_runtime", 61.0, 2.0),
    _x("void at::native::vectorized_elementwise_kernel<4>", "kernel", 10.0, 20.0),
    _x("nvjet_tst_128x64", "kernel", 20.0, 20.0),  # overlaps the first by 10
    _x("hashgrid_encode_kernel", "kernel", 70.0, 10.0),
    _x("Memset (Device)", "gpu_memset", 95.0, 5.0),
]


def test_reduce_by_hand():
    t = devtrace.reduce(EVENTS, calls=2)
    assert t["span_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert t["kernels"] == 3 and t["device_ops"] == 4
    assert t["kernel_s_by_kind"] == pytest.approx({"elementwise": 20e-6, "matmul": 20e-6, "port": 10e-6})
    gaps = dict((round(s * 1e6), n) for n, s in t["idle_gaps"])
    assert gaps == {10: "aten::mm", 30: "(no host op)", 15: "aten::copy_"}


def test_readers_on_the_reduced_trace():
    t = devtrace.reduce(EVENTS, calls=2)
    t["work"] = {"model_flops_per_call": 989e12 * 1e-6, "encode_least_s_per_call": 2e-6}
    run = {"kind": "train", "trace": t, "window": {"calls": 2, "seconds": 1e-4}}
    assert reader("device_idle_share.train")(run) == pytest.approx(55.0)
    assert reader("kernels_per_step.train")(run) == 1.5
    assert reader("elementwise_ms_per_step.train")(run) == pytest.approx(0.01)
    assert reader("encode_roofline.train")(run) == pytest.approx(40.0)
    assert reader("mfu.train")(run) == pytest.approx(2.0)
    assert reader("mfu.render")(run) is None and reader("device_idle_share.render")(run) is None


@pytest.mark.parametrize("metric", ["device_idle_share", "kernels_per_step", "elementwise_ms_per_step",
                                    "encode_roofline", "mfu"])
def test_population_readers_read_as_the_training_ones(metric):
    t = devtrace.reduce(EVENTS, calls=2)
    t["work"] = {"model_flops_per_call": 989e12 * 1e-6, "encode_least_s_per_call": 2e-6}
    run = {"kind": "train", "trace": t, "window": {"calls": 2, "seconds": 1e-4, "trials_per_call": 4}}
    assert reader(f"{metric}.pop")(run) == reader(f"{metric}.train")(run) is not None
    assert reader("pop_trial_steps_per_s")(run) == reader("trial_steps_per_s")(run) == pytest.approx(8e4)
