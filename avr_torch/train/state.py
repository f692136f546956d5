"""Optimizer and train step (port of ``avr_tpu/train/state.py``).

The static optax chain of ``make_optimizer`` written out in PyTorch:

  1. clip to global norm 1: g if ‖g‖ < 1 else g/‖g‖ (optax's
     ``clip_by_global_norm``; ``torch.nn.utils.clip_grad_norm_`` adds
     1e−6 to the norm and is not used);
  2. zero every non-finite gradient entry;
  3. optional L2 decay g + wd·p (before Adam, as torch's Adam does);
  4. Adam(0.9, 0.999), eps 1e−8 outside the sqrt, bias-corrected;
  5. the cosine schedule, evaluated at the completed-step count.

If the energy loss is non-finite the whole update — params, moments and
step count — is dropped, as the reference's ``continue`` does. The skip is
decided on the device (``torch.where``), with no host synchronisation.

Params are the JAX package's tree of dicts and lists of tensors; names
like ``enc.pos_pair`` and ``sigma_encoder.w.0`` address its leaves.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple, Union

import torch

from avr_torch import geometry
from avr_torch.config import RenderConfig, TrainConfig
from avr_torch.device import resolve_device
from avr_torch.losses import CriterionConfig, LossBundle, criterion
from avr_torch.models import field as field_lib
from avr_torch.render.common import RenderConsts
from avr_torch.render.fused import render_fused


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) for every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    """The tree shaped like ``template`` whose leaves are ``flat[name]``."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}.") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, flat, f"{prefix}{i}.") for i, v in enumerate(template))
    return flat[prefix[:-1]]


class AdamState(NamedTuple):
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: torch.Tensor  # int32 completed-update counter (also Adam's count)


def cosine_lr(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """optax.cosine_decay_schedule(lr, T_max, eta_min/lr) at ``step``, in fp32."""
    decay_steps = float(max(1, tc.T_max))
    alpha = tc.eta_min / tc.lr if tc.lr else 0.0
    count = torch.clamp(step.to(torch.float32), max=decay_steps)
    cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
    return tc.lr * ((1 - alpha) * cosine + alpha)


def init_state(
    generator: Optional[torch.Generator], fstatic, tc: TrainConfig, device="cuda", params=None,
) -> TrainState:
    """Fresh params (or the given ones) with zero Adam moments and step 0."""
    device = resolve_device(device)
    if params is None:
        params = field_lib.init(generator, fstatic, device)
    zeros = tree_map(torch.zeros_like, params)
    return TrainState(
        params, AdamState(zeros, tree_map(torch.zeros_like, params)),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def apply_optimizer(state: TrainState, grads, tc: TrainConfig, skip: torch.Tensor) -> TrainState:
    """One step of the static optimizer chain; ``skip`` (bool scalar) keeps the old state."""
    names = [n for n, _ in named_leaves(state.params)]
    p = dict(named_leaves(state.params))
    g = dict(named_leaves(grads))
    mu = dict(named_leaves(state.opt_state.mu))
    nu = dict(named_leaves(state.opt_state.nu))

    g_norm = torch.sqrt(sum(torch.sum(g[n] ** 2) for n in names))
    clip = g_norm < 1.0
    count = state.step + 1  # Adam's count after this update
    b1, b2, eps = 0.9, 0.999, 1e-8
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)
    lr = cosine_lr(tc, state.step)

    new_p, new_mu, new_nu = {}, {}, {}
    for n in names:
        u = torch.where(clip, g[n], g[n] / g_norm)
        u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))
        if tc.weight_decay:
            u = u + tc.weight_decay * p[n]
        m = (1 - b1) * u + b1 * mu[n]
        v = (1 - b2) * (u * u) + b2 * nu[n]
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[n] = torch.where(skip, p[n], p[n] + (-lr) * step)
        new_mu[n] = torch.where(skip, mu[n], m)
        new_nu[n] = torch.where(skip, nu[n], v)

    tmpl = state.params
    return TrainState(
        unflatten(tmpl, new_p),
        AdamState(unflatten(tmpl, new_mu), unflatten(tmpl, new_nu)),
        torch.where(skip, state.step, state.step + 1),
    )


def make_train_step(
    fstatic, consts: RenderConsts, rc: RenderConfig, tc: TrainConfig, crit: CriterionConfig,
):
    """Returns (step, render).

    ``step(state, batch, generator_or_dirs) → (state, LossBundle)``:
    batch holds tensors on the device: ``wave`` [bs, F, 2], ``pos_rx`` /
    ``pos_tx`` [bs, 3], and ``rot_tx`` [bs, 3] (complex variant) or
    ``ch_idx`` [bs] integer channels (multi-channel sets); the third
    argument is a ``torch.Generator`` for this step's random ray
    directions, or the [R, 3] directions themselves.
    """
    compute_dtype = (
        None if tc.compute_dtype in ("float32", "none", None) else getattr(torch, tc.compute_dtype)
    )

    def render(params, batch: Dict[str, torch.Tensor], dirs: torch.Tensor) -> torch.Tensor:
        return render_fused(
            params, fstatic, consts, rc,
            batch["pos_rx"], batch["pos_tx"], direction_tx=batch.get("rot_tx"),
            ch_idx=batch.get("ch_idx"), dirs=dirs, compute_dtype=compute_dtype,
            shell_chunk=tc.shell_chunk, remat=bool(tc.remat), point_budget=tc.point_budget,
        )

    def step(
        state: TrainState, batch: Dict[str, torch.Tensor],
        generator_or_dirs: Union[torch.Generator, torch.Tensor],
    ) -> Tuple[TrainState, LossBundle]:
        device = batch["pos_rx"].device
        if "ch_idx" in batch:  # int32 from the sampler; indices are int64
            batch = {**batch, "ch_idx": batch["ch_idx"].long()}
        if isinstance(generator_or_dirs, torch.Tensor):
            dirs = generator_or_dirs
        else:
            dirs = geometry.ray_directions(
                rc.n_azi, rc.n_ele, generator=generator_or_dirs, device=device
            )
        params = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        named = list(named_leaves(params))
        pred = render(params, batch, dirs)
        bundle, _, _ = criterion(pred, batch["wave"], crit)
        grads_flat = torch.autograd.grad(bundle.total, [t for _, t in named], allow_unused=True)
        grads = unflatten(params, {
            n: torch.zeros_like(t) if d is None else d for (n, t), d in zip(named, grads_flat)
        })
        bundle = LossBundle(*(x.detach() for x in bundle))
        with torch.no_grad():
            skip = ~torch.isfinite(bundle.energy)
            new_state = apply_optimizer(state, grads, tc, skip)
        return new_state, bundle

    return step, render
