"""``correct`` comes out false when the timed path is broken underneath.

Each run skips the harness's look for a card and drives the rest of a run
on the CPU, at a small size with the program in float32 (so a sound run
sits far below the cell's limits), with one fault planted in the program
(``benchmark.faults``): a step that returns its state unchanged; half the
batch left out, the loss a mean over the rest; a step that leaves the
hash tables as they were (a zero table gradient), where the cell compares
the tables' change; a render's answer altered
where it is made; a render answering with a stale answer. A sound run of
the same size comes out correct. The cells run on one card, so there is
no exchange between cards to leave out.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.conftest import small_config

SEED = 2 ** 31 + 3


def run(cell: str) -> dict:
    return harness.run(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(), config=small_config(cell))


@pytest.mark.parametrize("cell", ["flagship_train", "array_pop4", "array_render"])
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("flagship_train", "unchanged"), ("flagship_train", "half_batch"),
    ("array_pop4", "unchanged"), ("array_pop4", "half_batch"), ("array_pop4", "tables_unchanged"),
    ("array_render", "altered"), ("array_render", "half_batch"), ("array_render", "stale"),
])
def test_fault_is_caught(cell, fault):
    with faults.planted(fault):
        result = run(cell)
    assert not result["correct"], result["checks"]
