"""MLP stacks for the neural IR field (port of ``avr_tpu/models/mlp.py``).

Params are plain dicts ``{"w": [...], "b": [...], "emb": [...]}`` of fp32
tensors, as in the JAX package, so converted JAX params plug in directly.
An ``n_hidden_layers=H`` network has H hidden linears of width
``n_neurons`` and one output linear (tcnn's layout). With ``inject`` each
hidden layer also has a ``[ch_num, n_neurons]`` table of channel
embeddings, ``emb[layer]``: the row of the microphone channel ``ch_idx`` is
added to the layer's pre-activation (the reference's "add" connection).

Matmuls run on ``torch.matmul`` (cuBLAS on the card). With a bf16
``compute_dtype`` they take bf16 operands, accumulate in fp32 and return
fp32 — in both directions (``_MatmulCD``). A ReLU network in bf16 compute
(every shipped recipe) runs its hidden layers as ``ops.mlp_act``'s chain:
the same matmuls, with each layer's bias, embedding (and the signal
network's first-layer context), ReLU and bf16 cast in one kernel forward and
the mask, cast and sums in one kernel backward on the card. Another
activation, or fp32 compute, keeps the eager chain.

Population training stacks K trials' params on a leading axis: weights
[K, d_in, d_out], biases [K, d_out], embeddings [K, ch_num, n]. Inputs then
carry the same leading K ([K, ..., d_in]) and every product is a batched
matmul over the trials (``torch.bmm``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from avr_torch.device import resolve_device
from avr_torch.ops import mlp_act
from avr_torch.ops.mlp_act import mm_f32 as _mm_f32
from avr_torch.ops.take import take

Params = Dict[str, list]


_IDENTITY = ("none", "linear", "identity")


def _activation(name: str):
    name = (name or "none").lower()
    if name in _IDENTITY:
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "leakyrelu":
        return lambda x: Fn.leaky_relu(x, 0.01)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: Fn.gelu(x, approximate="tanh")
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    if name in ("exponential", "exp"):
        return torch.exp
    if name == "squareplus":
        return lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0))
    raise ValueError(f"unknown activation {name!r}")


@dataclass(frozen=True)
class MLPStatic:
    n_input_dims: int
    n_output_dims: int
    n_neurons: int
    n_hidden_layers: int
    activation: str = "ReLU"
    output_activation: str = "None"
    use_bias: bool = True
    inject: bool = False  # per-layer channel-embedding injection ("add")
    ch_num: int = 0

    @property
    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        dims = []
        d = self.n_input_dims
        for _ in range(self.n_hidden_layers):
            dims.append((d, self.n_neurons))
            d = self.n_neurons
        dims.append((d, self.n_output_dims))
        return tuple(dims)


def init(generator: Optional[torch.Generator], static: MLPStatic, device="cuda") -> Params:
    """He-normal weights, zero biases, channel embeddings N(0, 1/n_neurons)."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else device

    params: Params = {"w": [], "b": [], "emb": []}
    for d_in, d_out in static.layer_dims:
        w = torch.randn((d_in, d_out), generator=generator, device=gdev).to(device)
        params["w"].append(w * (2.0 / d_in) ** 0.5)
        if static.use_bias:
            params["b"].append(torch.zeros((d_out,), device=device))
    if static.inject:
        for _ in range(static.n_hidden_layers):
            e = torch.randn((static.ch_num, static.n_neurons), generator=generator, device=gdev)
            params["emb"].append(e.to(device) / static.n_neurons**0.5)
    return params


class _MatmulCD(torch.autograd.Function):
    """x @ w in ``compute_dtype`` with fp32 accumulation, both directions.

    x [..., d_in] @ w [d_in, d_out], or per trial x [K, M, d_in] @
    w [K, d_in, d_out]. The backward casts the incoming cotangent to the
    compute dtype before both products (autocast alone would keep an fp32
    cotangent), as the JAX package's ``_matmul_cd`` does.
    """

    @staticmethod
    def forward(ctx, x, w, compute_dtype):
        lead = x.shape[:-1]
        xc = (x if w.dim() == 3 else x.reshape(-1, x.shape[-1])).to(compute_dtype)
        wc = w.to(compute_dtype)
        ctx.save_for_backward(xc, wc)
        ctx.lead, ctx.dtypes, ctx.cd = lead, (x.dtype, w.dtype), compute_dtype
        return _mm_f32(xc, wc).reshape(*lead, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        gc = (g if wc.dim() == 3 else g.reshape(-1, g.shape[-1])).to(ctx.cd)
        dx = _mm_f32(gc, wc.transpose(-1, -2)).reshape(*ctx.lead, wc.shape[-2]).to(ctx.dtypes[0])
        dw = _mm_f32(xc.transpose(-1, -2), gc).to(ctx.dtypes[1])
        return dx, dw, None


def _matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out]; per trial x [K, ..., d_in] @ w [K, d_in, d_out]."""
    if w.dim() == 3 and x.dim() != 3:  # fold the dims after K into one
        out = _matmul(x.reshape(w.shape[0], -1, x.shape[-1]), w, compute_dtype)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    if compute_dtype is None:
        return torch.matmul(x, w)
    return _MatmulCD.apply(x, w, compute_dtype)


def per_trial(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-trial vector [K, d] viewed to broadcast against like [K, ..., d]
    (a plain [d] vector broadcasts as it is)."""
    if v.dim() == 1:
        return v
    return v.reshape(v.shape[0], *([1] * (like.dim() - 2)), v.shape[-1])


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of an embedding table [n, d] → [*idx.shape, d], or per
    trial of [K, n, d] → [K, *idx.shape, d]."""
    return take(table, table.dim() - 2, idx)


def _fused(static: MLPStatic, compute_dtype) -> bool:
    """Whether the hidden layers run as ``ops.mlp_act``'s chain: a ReLU
    network with hidden layers, in bf16 compute."""
    return (
        compute_dtype == torch.bfloat16 and static.n_hidden_layers > 0
        and (static.activation or "").lower() == "relu"
    )


def _trials(params: Params) -> int:
    w = params["w"][0]
    return w.shape[0] if w.dim() == 3 else 0


def _output(params: Params, static: MLPStatic, h: torch.Tensor, split_bias: bool):
    """The output layer's bias and activation on its matmul h (``apply_tail``'s
    return)."""
    if split_bias and static.use_bias and (static.output_activation or "none").lower() in _IDENTITY:
        return h, params["b"][-1]
    if static.use_bias:
        h = h + per_trial(params["b"][-1], h)
    out = _activation(static.output_activation)(h)
    return (out, None) if split_bias else out


def _chain(params, static, first, lead, ch_idx, compute_dtype, split_bias, bias0=None, context=None):
    """The network through ``mlp_act.hidden_chain`` from ``first`` (the first
    layer's product, or its (x, w) parts) over rows with leading dims ``lead``
    (without the trial axis)."""
    K = _trials(params)
    H = static.n_hidden_layers
    inject = static.inject and ch_idx is not None
    lay, ch = mlp_act.layout_of(lead, K, ch_idx if inject else None, context is not None)
    rows = (K, -1) if K else (-1,)
    if isinstance(first, torch.Tensor):
        first = first.reshape(*rows, first.shape[-1])
    else:
        first = [(x.reshape(*rows, x.shape[-1]), w) for x, w in first]
    out = mlp_act.hidden_chain(
        first, params["w"][1:],
        [bias0] + [params["b"][i] if static.use_bias else None for i in range(1, H)],
        [params["emb"][i] if inject else None for i in range(H)], ch, context, lay, compute_dtype,
    )
    return _output(params, static, out.reshape(*((K,) if K else ()), *lead, out.shape[-1]), split_bias)


def _lead(params: Params, x: torch.Tensor):
    """x's leading dims without the trial axis."""
    return x.shape[1:-1] if _trials(params) else x.shape[:-1]


def apply(
    params: Params, static: MLPStatic, x: torch.Tensor, ch_idx: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Forward pass. x: [..., n_input_dims]; ch_idx: integer channels
    broadcastable against x's leading dims, or None."""
    if _fused(static, compute_dtype):
        bias0 = params["b"][0] if static.use_bias else None
        return _chain(params, static, [(x, params["w"][0])], _lead(params, x), ch_idx, compute_dtype,
                      False, bias0=bias0)
    h = _matmul(x, params["w"][0], compute_dtype)
    if static.use_bias:
        h = h + per_trial(params["b"][0], h)
    return apply_tail(params, static, h, ch_idx=ch_idx, compute_dtype=compute_dtype)


def apply_tail(
    params: Params, static: MLPStatic, h: torch.Tensor, ch_idx: Optional[torch.Tensor] = None,
    compute_dtype=None, split_bias: bool = False, add_first_bias: bool = False,
):
    """Run the network given the first layer's pre-activation ``h`` (its
    product before the first bias, with ``add_first_bias``).

    With ``split_bias`` returns (output, bias): where the output layer has a
    bias and the output activation is the identity, the output layer's matmul
    before its bias and the bias ([d_out], or [K, d_out] per trial), so that
    the caller can add it after a linear map of its own; otherwise the whole
    output and None.
    """
    bias0 = params["b"][0] if add_first_bias and static.use_bias else None
    if _fused(static, compute_dtype):
        return _chain(params, static, h, _lead(params, h), ch_idx, compute_dtype, split_bias, bias0=bias0)
    if bias0 is not None:
        h = h + per_trial(bias0, h)
    act = _activation(static.activation)
    n_layers = len(static.layer_dims)
    for layer in range(n_layers - 1):
        if layer > 0:
            h = _matmul(h, params["w"][layer], compute_dtype)
            if static.use_bias:
                h = h + per_trial(params["b"][layer], h)
        if static.inject and ch_idx is not None:
            h = h + rows(params["emb"][layer], ch_idx)
        h = act(h)
    if n_layers == 1:  # h is the output layer's pre-activation, its bias in it
        out = _activation(static.output_activation)(h)
        return (out, None) if split_bias else out
    return _output(params, static, _matmul(h, params["w"][-1], compute_dtype), split_bias)


def apply_parts(
    params: Params, static: MLPStatic, parts, context: Tuple[torch.Tensor, torch.Tensor],
    ch_idx: Optional[torch.Tensor] = None, compute_dtype=None, split_bias: bool = False,
):
    """Run the network whose first layer is Σᵢ xᵢ @ wᵢ over input parts
    (xᵢ [(K,) B, R, C, dᵢ], wᵢ rows of the first weight, ``input_weight_slices``)
    plus the context h_ray [(K,) R, W] + h_batch [(K,) B, W] (the first bias
    folded in); returns as ``apply_tail``. The eager chain adds the context
    as one [(K,) B, R, 1, W] tensor."""
    if _fused(static, compute_dtype):
        return _chain(params, static, parts, _lead(params, parts[0][0]), ch_idx, compute_dtype, split_bias,
                      context=context)
    h = _matmul(parts[0][0], parts[0][1], compute_dtype)
    for x, w in parts[1:]:
        h = h + _matmul(x, w, compute_dtype)
    h_ray, h_batch = context
    h = h + (h_ray.unsqueeze(-2).unsqueeze(-4) + h_batch.unsqueeze(-2).unsqueeze(-2))
    return apply_tail(params, static, h, ch_idx=ch_idx, compute_dtype=compute_dtype, split_bias=split_bias)


def first_layer_weight(params: Params) -> torch.Tensor:
    return params["w"][0]


def input_weight_slices(params: Params, sizes) -> list:
    """Split the first-layer weight rows by input-part sizes: with
    x = concat(parts), x @ W0 = Σᵢ partᵢ @ W0[rowsᵢ] (per trial for a
    weight [K, d_in, d_out])."""
    slices, start = [], 0
    w0 = params["w"][0]
    for s in sizes:
        slices.append(w0[..., start : start + s, :])
        start += s
    assert start == w0.shape[-2], f"part sizes {sizes} != in_dim {w0.shape[-2]}"
    return slices
