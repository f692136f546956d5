"""Parameter exchange with the JAX package, through numpy.

``params_from_jax`` takes the JAX param tree after ``jax.device_get``
(dicts and lists of numpy arrays, e.g. from ``avr_tpu.models.field.init``)
and returns the port's params: the same tree of float32 tensors on
``device``, under the same names (``enc.pos_pair``, ``sigma_encoder.w.0``,
…). ``params_to_numpy`` is the inverse, for comparing params and gradients.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from avr_torch.device import resolve_device


def params_from_jax(tree, device="cuda"):
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def params_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()
