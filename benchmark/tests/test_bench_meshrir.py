"""The cell ``meshrir_train`` (the AVR paper's MeshRIR recipe: standard
field, no channel rows, 3,202 rays × 64 shells, T = 2,400 at 24 kHz, batch
4) against its limits.

Here, at a small size on the CPU that keeps T and fs (rays, shells, levels
and widths cut), with the program in float32: a sound run is correct; the
half-batch and unchanged-state faults, the fp8 control and a zero table
gradient are not. Marked ``card``, at the cell's own size: one sound seed
is correct, and the fp8 control, the half-batch fault planted under the
timed path and a zero table gradient are not, so the limits stay tight
enough to catch each; and the port's counters read what one step of this
shape asks for, on the eager step, on the capture and on every replay.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import faults, harness, readings
from benchmark.tests.conftest import small_config

CELL = "meshrir_train"
SEED = 2 ** 31 + 20


def small() -> dict:
    """``small_config``'s cut (rays, shells, levels, widths) with the
    cell's T kept."""
    cfg = small_config(CELL)
    cfg["model"]["signal_output_dim"] = harness.cell(CELL)["config_file"]["config"]["model"]["signal_output_dim"]
    return cfg


def _fails(rec: dict) -> bool:
    limits = harness.cell(CELL)["cell_file"]["limits"]
    return any(rec[k] > v for k, v in limits.items())


def run(device, seconds: float, config=None, seed: int = SEED) -> dict:
    return harness.run(CELL, seed, seconds, False, device, time.perf_counter(), config=config)


def verdict(what: str, device, seconds: float, config=None, seed: int = SEED) -> bool:
    """Whether ``what`` passes the limits: a sound run, a run with a fault
    planted under the timed path (``half_batch``, ``unchanged``), the fp8
    control's readings, or the readings of the reference with a zero table
    gradient in the program's place (``zero_tables``)."""
    if what == "control":
        return not _fails(readings.readings(CELL, seed, device, "control", 0.0, config=config))
    if what == "zero_tables":
        return not _fails(readings.readings(CELL, seed, device, "faults", 0.0, config=config)["zero_tables"])
    if what in ("half_batch", "unchanged"):
        with faults.planted(what):
            return run(device, seconds, config, seed)["correct"]
    result = run(device, seconds, config, seed)
    return result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("what", ["sound", "half_batch", "unchanged", "control", "zero_tables"])
def test_limits_at_small_size(what):
    assert verdict(what, torch.device("cpu"), 0.5, small()) == (what == "sound")


def _build():
    from avr_torch.ops import _build

    _build.build_all()


@pytest.mark.card
# ``unchanged`` plants nothing in the graphed step on the card (it returns
# the state the step has already updated in place), so it is read here only
@pytest.mark.parametrize("what", ["sound", "half_batch", "control", "zero_tables"])
def test_limits_at_cell_size(card, what):
    _build()
    assert verdict(what, card, 2.0, seed=SEED + (what == "control")) == (what == "sound")


@pytest.mark.card
def test_counters_per_step_at_cell_size(card):
    """Each step of 4 × 3,202 × 64 points: the encodes' points (the
    points, the 3,202 view directions, the 4 transmitters), 64 shell
    chunks run and recomputed, one split of the per-point features, the
    contraction and the MLP chain once per chunk call and layer, and from
    the second step on a replay of the captured graph."""
    from benchmark.drivers import train
    from avr_torch.utils import profiling

    _build()
    c = harness.cell(CELL)
    s = train.Session(c["config_file"]["config"], c["traffic_file"], SEED + 2, card)
    want = {"encode.points": 4 * 3202 * 64 + 3202 + 4, "encode.fwd_launches": 3, "encode.bwd_launches": 3,
            "render.chunk_calls": 128, "render.feature_splits": 1,
            "contract.fwd_launches": 128, "contract.bwd_launches": 64,
            "mlp_act.fwd_launches": 6 + 128 * 3, "mlp_act.bwd_launches": 6 + 64 * 3}
    graph = [{"step.eager_calls": 1}, {"step.graph_captures": 1, "step.graph_replays": 1},
             {"step.graph_replays": 1}, {"step.graph_replays": 1}]
    for n, g in enumerate(graph):
        before = profiling.counters()
        _, batch, d = s.feed()
        s.call(batch, d)
        torch.cuda.synchronize(card)
        after = profiling.counters()
        moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        assert {k: moved.get(k, 0) for k in want} == want, (n, moved)
        assert {k: v for k, v in moved.items() if k.startswith("step.")} == g, (n, moved)
