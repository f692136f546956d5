"""Shared pieces of the benchmark's tests: small configurations of the
cells, and the ``card`` marker for tests that need a CUDA card (they skip
here, deciding inside the fixture, never at import)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_config(cell: str, compute_dtype: str = "float32") -> dict:
    """The cell's configuration at a size the CPU runs in seconds: every
    width and depth cut, the structure (variant, encodings, channel
    connections, losses) kept."""
    from benchmark import harness

    cfg = copy.deepcopy(harness.cell(cell)["config_file"]["config"])
    r = cfg["render"]
    r.update(n_samples=8, n_azi=6, n_ele=3)
    cfg["model"]["signal_output_dim"] = 256
    for v in cfg["model"].values():
        if isinstance(v, dict) and "n_levels" in v:
            v.update(n_levels=4, log2_hashmap_size=8, base_resolution=4, per_level_scale=1.5)
            if str(v.get("interpolation", "")).startswith("hybridc"):
                v["interpolation"] = "hybridc:2"
        if isinstance(v, dict) and "n_neurons" in v:
            v["n_neurons"] = 32
    cfg["train"]["compute_dtype"] = compute_dtype
    return cfg
