"""Config sweep generation for control experiments (a copy of
``avr_tpu/utils/config_tools.py``; no repair).

Re-design of reference/make_config_for_control_exp.py:7-130: starting
from a base YAML ``avr_<name>_1.yml`` whose expname contains
``<Name>_param_<idx>``, generate one numbered config variant per value of
each swept parameter (one-at-a-time sweeps), renumbering expname and
filename consecutively. Supports the reference's section layout
(train/render top-level keys and two-level model keys).
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List

import yaml


def generate_param_variants(base_config_dir: str, param_dict: Dict[str, Any]) -> List[str]:
    """Write numbered one-at-a-time sweep configs; returns written paths.

    param_dict example (reference/make_config_for_control_exp.py:63-128):
        {"train": {"lr": [1e-3, 1e-4]},
         "render": {"n_samples": [32, 64]},
         "model": {"signal_network": {"n_neurons": [256, 512]},
                   "signal_output_dim": [1600]}}
    """
    base_path = Path(base_config_dir)
    last_dir = base_path.name
    capitalized = last_dir.capitalize()
    base_file = base_path / f"avr_{last_dir}_1.yml"
    if not base_file.exists():
        raise FileNotFoundError(f"base config {base_file} not found")

    with open(base_file) as f:
        base_config = yaml.safe_load(f)

    base_expname = base_config["path"]["expname"]
    match = re.search(rf"{capitalized}_param_(\d+)", base_expname)
    if not match:
        raise ValueError(
            f"expname {base_expname!r} must contain '{capitalized}_param_<idx>'"
        )
    base_idx = int(match.group(1))

    written: List[str] = []
    count = 0

    def emit(mutate):
        nonlocal count
        cfg = copy.deepcopy(base_config)
        mutate(cfg)
        count += 1
        idx = base_idx + count
        cfg["path"]["expname"] = re.sub(
            rf"{capitalized}_param_\d+", f"{capitalized}_param_{idx}", base_expname
        )
        out = base_path / f"avr_{last_dir}_{idx}.yml"
        with open(out, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        written.append(str(out))

    for section, params in param_dict.items():
        for key1, val1 in params.items():
            if section == "model" and isinstance(val1, dict):
                for key2, values in val1.items():
                    for v in values:
                        emit(lambda c, k1=key1, k2=key2, vv=v: c["model"][k1].__setitem__(k2, vv))
            else:
                for v in val1:
                    emit(lambda c, s=section, k=key1, vv=v: c[s].__setitem__(k, vv))
    return written
