"""No process of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names (the part
before the first dot) are compared whole: ``avr_torch`` begins with
``avr_t`` but is not ``avr_tpu``."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "avr_tpu"}

RUN_CELLS = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
import benchmark.run  # noqa: F401  (the entry point, as a module)
from benchmark import harness
from benchmark.tests.conftest import small_config
for cell in ("flagship_train", "array_train", "array_pop4", "array_render"):
    harness.run(cell, 2 ** 31 + 5, 0.2, True, torch.device("cpu"), time.perf_counter(),
                config=small_config(cell, "bfloat16"))
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import inputs, weights
from benchmark.reference import Reference, hparams
from benchmark.reference.field import Field
from benchmark.tests.conftest import small_config
cfg = small_config("array_train")
fld = Field(cfg)
w = weights.draw(fld, torch.Generator().manual_seed(0), "cpu")
b = inputs.Batches(cfg, {{"source": "random_spectra", "batches": 2, "scale": 0.01, "box": [1.0, 5.0]}}, 0, "cpu")
batch = {{**b.get(0), "ch_idx": torch.arange(8)}}
d = inputs.ray_directions(6, 3, None, "cpu")
Reference(cfg, "cpu").train(w, [batch], [d], hparams(cfg))
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _top_level(code: str) -> set:
    env_code = code.format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", env_code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_cells_load_no_jax():
    loaded = _top_level(RUN_CELLS)
    assert "avr_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_no_program():
    loaded = _top_level(REFERENCE)
    assert "avr_torch" not in loaded and not loaded & FORBIDDEN
