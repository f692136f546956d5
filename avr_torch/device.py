"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. A caller that did not ask for
the CPU never silently gets it: with no CUDA device the call raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"avr_torch: device {str(dev)!r} requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels"
        )
    return dev
