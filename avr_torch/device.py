"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. A caller that did not ask for
the CPU never silently gets it: with no CUDA device the call raises. Under
torchrun (``LOCAL_RANK`` set) a bare ``"cuda"`` is the rank's own device,
``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import os

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
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev
