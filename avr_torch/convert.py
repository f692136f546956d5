"""Parameter exchange with the JAX package, through numpy.

``params_from_jax`` takes the JAX param tree after ``jax.device_get``
(dicts and lists of numpy arrays, e.g. from ``avr_tpu.models.field.init``)
and returns the port's params: the same tree of float32 tensors on
``device``, under the same names (``enc.pos_pair``, ``sigma_encoder.w.0``,
…). ``params_to_numpy`` is the inverse, for comparing params and gradients.

``state_from_jax`` carries a whole JAX ``TrainState`` (after
``jax.device_get``: params, the optax chain state and the step) into the
port's ``TrainState``, Adam moments included; ``state_to_numpy`` is its
inverse as a dict of numpy trees. A JAX population state (every leaf and
the step stacked on a leading K) carries over with its leading axis, as
the port's population state. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from avr_torch.device import resolve_device
from avr_torch.train.state import AdamState, TrainState


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


def _adam_state(tree):
    """The optax ``ScaleByAdamState`` (a NamedTuple with ``count``, ``mu``,
    ``nu``) inside a chain state, wherever the chain puts it: its position
    depends on whether weight decay is on, and ``inject_hyperparams``
    (runtime hparams) nests the chain under ``inner_state``."""
    if hasattr(tree, "_fields") and {"count", "mu", "nu"} <= set(tree._fields):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for sub in items:
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def state_from_jax(state_np, device="cuda") -> TrainState:
    """The port's TrainState from a JAX TrainState after ``jax.device_get``,
    or a population state from a K-stacked one (step [K]).

    The Adam count is optax's bias-correction count; the port derives it
    from the step (``apply_optimizer`` uses step + 1), so the two must agree.
    """
    device = resolve_device(device)
    adam = _adam_state(state_np.opt_state)
    if adam is None:
        raise ValueError("state_from_jax: no ScaleByAdamState (count, mu, nu) in the optimizer state")
    step = np.asarray(state_np.step, dtype=np.int32)
    count = np.asarray(adam.count)
    if count.shape != step.shape or not np.array_equal(count, step):
        raise ValueError(f"state_from_jax: Adam count {count.tolist()} != step {step.tolist()}")
    return TrainState(
        params_from_jax(state_np.params, device),
        AdamState(params_from_jax(adam.mu, device), params_from_jax(adam.nu, device)),
        torch.tensor(step, dtype=torch.int32, device=device),
    )


def state_to_numpy(state: TrainState) -> dict:
    """``{"params", "mu", "nu"}`` as numpy trees and ``"step"`` as an int
    (a list of K ints for a population state)."""
    return {
        "params": params_to_numpy(state.params),
        "mu": params_to_numpy(state.opt_state.mu),
        "nu": params_to_numpy(state.opt_state.nu),
        "step": state.step.tolist(),
    }
