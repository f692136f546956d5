"""Microphone beam patterns (port of ``avr_tpu/utils/spatialization.py``,
after reference/utils/spatialization.py:4-27), on torch tensors.
"""

from __future__ import annotations

import torch


def wide_cardioid_beam_pattern(facing_direction, phi, base_level: float = 2.0) -> torch.Tensor:
    """Microphone gain at query directions `phi` (radians) for a mic
    facing `facing_direction`.

    Wide cardioid: main lobe (1 + cos(φ−θ))/2 plus a base level
    (a falsy base_level becomes 1.0 — reference quirk,
    spatialization.py:22-24), normalized to a peak gain of 1.
    """
    phi = torch.as_tensor(phi)
    main_lobe_gain = (1.0 + torch.cos(phi - facing_direction)) / 2.0
    if not base_level:
        base_level = 1.0
    gain = main_lobe_gain + base_level
    return gain / torch.max(gain)
