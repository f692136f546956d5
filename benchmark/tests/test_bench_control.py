"""The control, the reference computed in fp8 (one step below the bf16
that the configurations state), put in the program's place, comes out
not correct: at a small size on the CPU here, and at the cell's own size
on the card (marked ``card``)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, readings
from benchmark.tests.conftest import small_config


def _fails(cell: str, rec: dict) -> bool:
    limits = harness.cell(cell)["cell_file"]["limits"]
    return any(rec[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", ["flagship_train", "array_render"])
def test_control_fails_at_small_size(cell):
    rec = readings.readings(cell, 2 ** 31 + 9, torch.device("cpu"), "control", 0.5, config=small_config(cell))
    assert _fails(cell, rec), rec


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flagship_train", "array_train", "array_pop4", "array_render"])
def test_control_fails_at_cell_size(card, cell):
    from avr_torch.ops import _build

    _build.build_all()
    rec = readings.readings(cell, 2 ** 31 + 17, card, "control", 3.0)
    assert _fails(cell, rec), rec
