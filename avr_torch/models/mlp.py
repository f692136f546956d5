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
fp32 — in both directions (``_MatmulCD``).

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

Params = Dict[str, list]


def _activation(name: str):
    name = (name or "none").lower()
    if name in ("none", "linear", "identity"):
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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 operands, 2-D or batched 3-D, with fp32 accumulation
    and fp32 output.

    On the card cuBLAS takes the bf16 operands and writes fp32
    (``out_dtype``). The CPU has no such kernel: there the bf16 values are
    widened first — each product of two bf16 values is exact in fp32, so
    this is the same arithmetic.
    """
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.is_cuda:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.to(torch.float32), b.to(torch.float32))


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
    return table[idx] if table.dim() == 2 else table[:, idx]


def apply(
    params: Params, static: MLPStatic, x: torch.Tensor, ch_idx: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Forward pass. x: [..., n_input_dims]; ch_idx: integer channels
    broadcastable against x's leading dims, or None."""
    h = _matmul(x, params["w"][0], compute_dtype)
    if static.use_bias:
        h = h + per_trial(params["b"][0], h)
    return apply_tail(params, static, h, ch_idx=ch_idx, compute_dtype=compute_dtype)


def apply_tail(
    params: Params, static: MLPStatic, h: torch.Tensor, ch_idx: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Run the network given the first layer's pre-activation ``h``."""
    act = _activation(static.activation)
    out_act = _activation(static.output_activation)
    n_layers = len(static.layer_dims)
    for layer in range(n_layers):
        if layer > 0:
            h = _matmul(h, params["w"][layer], compute_dtype)
            if static.use_bias:
                h = h + per_trial(params["b"][layer], h)
        if layer < n_layers - 1:
            if static.inject and ch_idx is not None:
                h = h + rows(params["emb"][layer], ch_idx)
            h = act(h)
    return out_act(h)


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
