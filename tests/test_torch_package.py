"""avr_torch stands alone: no JAX and no avr_tpu at import, and entry points
that were not asked for the CPU refuse to run without a CUDA device."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import avr_torch
from avr_torch import geometry
from avr_torch.convert import params_from_jax
from avr_torch.flagship import flagship_config
from avr_torch.models import field, hashgrid, mlp
from avr_torch.render.common import make_consts
from avr_torch.train.state import init_state

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    mods = sorted(
        m.name for m in pkgutil.walk_packages(avr_torch.__path__, "avr_torch.")
    )
    assert "avr_torch.train.state" in mods and "avr_torch.ops.hash_scatter" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'optax', 'avr_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'torch.utils.cpp_extension' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "call",
    [
        lambda cfg, fst: geometry.ray_directions(4, 2),
        lambda cfg, fst: make_consts(cfg.render, cfg.model.signal_output_dim),
        lambda cfg, fst: field.init(torch.Generator().manual_seed(0), fst),
        lambda cfg, fst: init_state(torch.Generator().manual_seed(0), fst, cfg.train),
        lambda cfg, fst: hashgrid.init(None, fst.encodings["pos"].grid),
        lambda cfg, fst: mlp.init(None, fst.signal),
        lambda cfg, fst: params_from_jax({"w": [np.zeros((2, 2), np.float32)]}),
    ],
    ids=["ray_directions", "make_consts", "field_init", "init_state", "table_init", "mlp_init",
         "params_from_jax"],
)
def test_entry_points_refuse_to_run_on_cpu_by_default(monkeypatch, call):
    _no_cuda(monkeypatch)
    cfg = flagship_config(small=True)
    fst = field.build_field(cfg.model, "RAF")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(cfg, fst)


def test_explicit_cpu_runs(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = flagship_config(small=True)
    fst = field.build_field(cfg.model, "RAF")
    st = init_state(torch.Generator().manual_seed(0), fst, cfg.train, device="cpu")
    assert int(st.step) == 0 and st.params["enc"]["pos_pair"].device.type == "cpu"


def test_flagship_config_shapes():
    cfg = flagship_config()
    fst = field.build_field(cfg.model, "RAF")
    g = fst.encodings["pos"].grid
    assert g.interp == "levels:" + "t" * 7 + "s" * 13
    assert g.padded_entries == 4_759_552  # 2 dense + 18 hashed levels, rounded to 4096
    assert cfg.render.n_rays == 650 and cfg.render.n_samples == 32
    assert fst.signal_output_dim == 1600
    # corner rows of the pos_pair stream per point: 7 trilinear + 13 simplex levels
    assert sum(lv.K for lv in g.levels) == 7 * 8 + 13 * 4
    assert flagship_config(small=True).model.pos_encoding_sigma.interpolation == "hybridc:2"
