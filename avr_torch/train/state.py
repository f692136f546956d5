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

With ``train.runtime_hparams`` the step reads the rate schedule, the weight
decay and the loss weights from a bundle of tensors (``make_hparams``), as
the JAX package's runtime-scalar program does: the rate is
eta_min + (lr − eta_min)·cos-factor (``cosine_lr_hp``, not the static
schedule's alpha form, which rounds differently in fp32) and the decay is
always added, also when it is 0.

Population training (``make_train_step(..., population=K)``) advances K
trials in lockstep: every leaf of the state and of the bundle carries a
leading K, the batch and the ray directions are shared. Each trial keeps
its own loss, global-norm clip, non-finite skip, rate and decay; the
gradient is that of Σ_k loss_k, whose trial axes never mix. ``torch.func.vmap``
is not used: it refuses the renderer's checkpointed chunks (saved-tensor
hooks), so the trial axis is written out through the field and the render.

With a data × ray plan (``make_train_step(..., mesh_plan=)``, one process
per device, ``parallel.mesh``) each rank renders its rows over its slice
of the rays, one all-reduce assembles the global prediction, every rank
runs the criterion on the whole batch, and the parameter gradients are
summed over the world before the optimizer, which runs on every rank.

With the tracer of ``utils.profiling`` on, a step records the span
``step`` and in it, in order, ``render`` (the ``render`` closure, also a
render request's one span), ``criterion`` (all K trials), ``backward``
(the gradient, its zero fill and tree) and ``optimizer`` (the skip mask,
clip and Adam).

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
from avr_torch.parallel.mesh import MeshPlan, all_reduce_sum, assemble_prediction, broadcast
from avr_torch.render.common import RenderConsts
from avr_torch.render.fused import render_fused
from avr_torch.utils import profiling


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


HP_WEIGHT_KEYS = (
    "spec_loss_weight", "amplitude_loss_weight", "angle_loss_weight",
    "time_loss_weight", "energy_loss_weight", "multistft_loss_weight",
    "das_reg_loss_weight", "das_ce_loss_weight",
)


def make_hparams(tc: TrainConfig, device="cpu") -> Dict[str, torch.Tensor]:
    """The runtime hyper-parameter bundle of ``tc`` as fp32 0-d tensors: the
    loss weights, ``lr``, ``eta_min``, ``t_max`` and ``weight_decay``."""
    hp = {k: getattr(tc, k) for k in HP_WEIGHT_KEYS}
    hp.update(lr=tc.lr, eta_min=tc.eta_min, t_max=max(1, tc.T_max), weight_decay=tc.weight_decay)
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device) for k, v in hp.items()}


def stack_hparams(hps) -> Dict[str, torch.Tensor]:
    """K bundles of ``make_hparams`` → one bundle of [K] tensors."""
    return {k: torch.stack([hp[k] for hp in hps]) for k in hps[0]}


def cosine_lr_hp(hp: Dict[str, torch.Tensor], step: torch.Tensor) -> torch.Tensor:
    """The cosine rate on a runtime bundle, as the JAX package writes it:
    eta_min + (lr − eta_min)·0.5·(1 + cos(π·min(step, t_max)/t_max)), fp32."""
    t = torch.minimum(step.to(torch.float32), hp["t_max"]) / hp["t_max"]
    cosf = 0.5 * (1.0 + torch.cos(math.pi * t))
    return hp["eta_min"] + (hp["lr"] - hp["eta_min"]) * cosf


def current_lr(tc: TrainConfig, step: int) -> float:
    """The rate ``apply_optimizer`` applies at ``step``, on the host: the
    same ``cosine_lr`` (``cosine_lr_hp`` with ``runtime_hparams``), so the
    logged rate cannot drift from the applied one."""
    if getattr(tc, "runtime_hparams", False):
        return float(cosine_lr_hp(make_hparams(tc), torch.tensor(step)))
    return float(cosine_lr(tc, torch.tensor(step)))


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


def broadcast_state(state: TrainState) -> TrainState:
    """Rank 0's state on every rank of the process group (every leaf and
    the step), as JAX's ``shard_state`` replicates it over the mesh."""
    trees = (state.params, state.opt_state.mu, state.opt_state.nu)
    flat = [dict(named_leaves(t)) for t in trees]
    out = iter(broadcast([t for f in flat for t in f.values()] + [state.step]))
    new = [unflatten(tree, {n: next(out) for n in f}) for tree, f in zip(trees, flat)]
    return TrainState(new[0], AdamState(new[1], new[2]), next(out))


def stack_states(states) -> TrainState:
    """K states → one population state, every leaf (and the step) stacked
    on a leading K."""
    def stacked(get):
        trees = [get(s) for s in states]
        flat = [dict(named_leaves(t)) for t in trees]
        return unflatten(trees[0], {n: torch.stack([f[n] for f in flat]) for n in flat[0]})

    return TrainState(
        stacked(lambda s: s.params),
        AdamState(stacked(lambda s: s.opt_state.mu), stacked(lambda s: s.opt_state.nu)),
        torch.stack([s.step for s in states]),
    )


def lane(state: TrainState, k: int) -> TrainState:
    """Trial k of a population state, as a state of one trial (views)."""
    return TrainState(
        tree_map(lambda t: t[k], state.params),
        AdamState(tree_map(lambda t: t[k], state.opt_state.mu), tree_map(lambda t: t[k], state.opt_state.nu)),
        state.step[k],
    )


def apply_optimizer(
    state: TrainState, grads, tc: TrainConfig, skip: torch.Tensor,
    hp: Optional[Dict[str, torch.Tensor]] = None,
) -> TrainState:
    """One step of the optimizer chain; ``skip`` (bool) keeps the old state.

    Without ``hp`` the static chain of ``tc``. With a runtime bundle ``hp``
    its rate schedule and its weight decay, always added. A population state
    (step [K]) takes ``skip`` and ``hp`` of shape [K]: each trial is clipped
    by the global norm of its own slices of the leaves and keeps or drops its
    own update."""
    names = [n for n, _ in named_leaves(state.params)]
    p = dict(named_leaves(state.params))
    g = dict(named_leaves(grads))
    mu = dict(named_leaves(state.opt_state.mu))
    nu = dict(named_leaves(state.opt_state.nu))
    K = state.step.shape[0] if state.step.dim() == 1 else 0

    def bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A per-trial [K] value broadcast against a leaf [K, ...]."""
        return v.reshape(K, *([1] * (like.dim() - 1))) if K else v

    if K:
        g_norm = torch.sqrt(sum(torch.sum((g[n] ** 2).reshape(K, -1), dim=1) for n in names))
    else:
        g_norm = torch.sqrt(sum(torch.sum(g[n] ** 2) for n in names))
    clip = g_norm < 1.0
    count = state.step + 1  # Adam's count after this update
    b1, b2, eps = 0.9, 0.999, 1e-8
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)
    lr = cosine_lr(tc, state.step) if hp is None else cosine_lr_hp(hp, state.step)
    wd = tc.weight_decay if hp is None else hp["weight_decay"]

    new_p, new_mu, new_nu = {}, {}, {}
    for n in names:
        x = g[n]
        u = torch.where(bc(clip, x), x, x / bc(g_norm, x))
        u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))
        if hp is not None:
            u = u + bc(wd, x) * p[n]
        elif wd:
            u = u + wd * p[n]
        m = (1 - b1) * u + b1 * mu[n]
        v = (1 - b2) * (u * u) + b2 * nu[n]
        step = (m / bc(bc1, x)) / (torch.sqrt(v / bc(bc2, x)) + eps)
        keep = bc(skip, x)
        new_p[n] = torch.where(keep, p[n], p[n] + bc(-lr, x) * step)
        new_mu[n] = torch.where(keep, mu[n], m)
        new_nu[n] = torch.where(keep, nu[n], v)

    tmpl = state.params
    return TrainState(
        unflatten(tmpl, new_p),
        AdamState(unflatten(tmpl, new_mu), unflatten(tmpl, new_nu)),
        torch.where(skip, state.step, state.step + 1),
    )


def make_train_step(
    fstatic, consts: RenderConsts, rc: RenderConfig, tc: TrainConfig, crit: CriterionConfig,
    population: int = 0, mesh_plan: Optional[MeshPlan] = None,
):
    """Returns (step, render).

    ``step(state, batch, generator_or_dirs, hp=None) → (state, LossBundle)``:
    batch holds tensors on the device: ``wave`` [bs, F, 2], ``pos_rx`` /
    ``pos_tx`` [bs, 3], and ``rot_tx`` [bs, 3] (complex variant) or
    ``ch_idx`` [bs] integer channels (multi-channel sets); the third
    argument is a ``torch.Generator`` for this step's random ray
    directions, or the [R, 3] directions themselves. With
    ``tc.runtime_hparams``, ``hp`` is the bundle of ``make_hparams`` (that
    of ``tc`` when omitted).

    ``population=K`` (needs ``tc.runtime_hparams``): the state's leaves and
    step and ``hp``'s values carry a leading K (``stack_states``,
    ``stack_hparams``), batch and directions are shared, and the bundle's
    terms are [K]. ``population=0`` is the single-trial step.

    ``mesh_plan`` (a process group joined; ``parallel.mesh``): every rank
    calls the step with the same global batch and directions, renders its
    rows over its slice of the rays and assembles the global prediction with
    one all-reduce; the criterion runs on the whole batch on every rank, the
    parameter gradients are summed over the world, and the optimizer runs on
    every rank. ``render`` assembles the global prediction the same way.
    """
    runtime_hp = bool(getattr(tc, "runtime_hparams", False))
    if population:
        assert runtime_hp, (
            "population mode needs runtime_hparams=True: the K trials differ "
            "only in the runtime hyper-parameter bundle"
        )
        if mesh_plan is not None:
            raise ValueError("population mode is single-device: it takes no mesh_plan")
    compute_dtype = (
        None if tc.compute_dtype in ("float32", "none", None) else getattr(torch, tc.compute_dtype)
    )
    default_hp: Dict[str, Dict[str, torch.Tensor]] = {}  # by device, for runtime steps without hp

    def render(params, batch: Dict[str, torch.Tensor], dirs: torch.Tensor) -> torch.Tensor:
        with profiling.span("render"):
            ray_weights = None
            if mesh_plan is not None:
                batch_size = batch["pos_rx"].shape[0]
                batch = mesh_plan.shard_batch(batch)
                dirs, ray_weights = mesh_plan.shard_rays(dirs)
            pred = render_fused(
                params, fstatic, consts, rc,
                batch["pos_rx"], batch["pos_tx"], direction_tx=batch.get("rot_tx"),
                ch_idx=batch.get("ch_idx"), dirs=dirs, compute_dtype=compute_dtype,
                shell_chunk=tc.shell_chunk, remat=bool(tc.remat), point_budget=tc.point_budget,
                ray_weights=ray_weights,
            )
            return pred if mesh_plan is None else assemble_prediction(pred, mesh_plan, batch_size)

    def losses(pred: torch.Tensor, wave: torch.Tensor, hp) -> Tuple[torch.Tensor, LossBundle]:
        """(the loss to differentiate, the bundle): per trial for a population."""
        if not population:
            bundle = criterion(pred, wave, crit, weights=hp)[0]
            return bundle.total, bundle
        per_trial = [
            criterion(pred[k], wave, crit, weights={n: v[k] for n, v in hp.items()})[0]
            for k in range(population)
        ]
        bundle = LossBundle(*(torch.stack(terms) for terms in zip(*per_trial)))
        return sum(b.total for b in per_trial), bundle

    def step(
        state: TrainState, batch: Dict[str, torch.Tensor],
        generator_or_dirs: Union[torch.Generator, torch.Tensor],
        hp: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[TrainState, LossBundle]:
        with profiling.span("step"):
            device = batch["pos_rx"].device
            if runtime_hp and hp is None:
                if population:
                    raise ValueError("a population step needs the [K] hyper-parameter bundle hp")
                hp = default_hp.setdefault(str(device), make_hparams(tc, device))
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
            with profiling.span("criterion"):
                total, bundle = losses(pred, batch["wave"], hp if runtime_hp else None)
            with profiling.span("backward"):  # with a mesh plan, the gradients' all-reduce too
                grads_flat = torch.autograd.grad(total, [t for _, t in named], allow_unused=True)
                grads_flat = [torch.zeros_like(t) if d is None else d for (_, t), d in zip(named, grads_flat)]
                if mesh_plan is not None:
                    grads_flat = all_reduce_sum(grads_flat)
                grads = unflatten(params, {n: d for (n, _), d in zip(named, grads_flat)})
            bundle = LossBundle(*(x.detach() for x in bundle))
            with profiling.span("optimizer"), torch.no_grad():
                skip = ~torch.isfinite(bundle.energy)
                new_state = apply_optimizer(state, grads, tc, skip, hp if runtime_hp else None)
            return new_state, bundle

    return step, render
