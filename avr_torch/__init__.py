"""avr_torch — Acoustic Volume Rendering in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``avr_tpu`` (JAX on a TPU). The module layout mirrors the JAX
package so each counterpart is easy to find (``avr_torch/models/hashgrid.py``
↔ ``avr_tpu/models/hashgrid.py``, and so on). The package never imports
``jax`` or ``avr_tpu``: framework-free pieces (``config.py``) are copied.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (the CPU tests do). Kernels are built with ``nvcc`` at first use
(``avr_torch.ops._build``), never at import.
"""

from avr_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
