"""The MLPs' hidden-layer chain, forward and backward, and its plain version.

A hidden layer's matmul writes P [M, W] fp32 whose rows are laid out
[K, B, R, C] (:class:`Layout`: trial k, batch group b, ray r, shell c). Its
pre-activation is, in fp32 and in this order (each term present or not),

    pre = ((P + (h_ray[k, r] + h_batch[k, b])) + bias[k]) + emb[k, ch[b]]

with h_ray [(K,) R, W] and h_batch [(K,) B, W] the signal network's
first-layer context (``field.signal_context``), bias [(K,) W], emb
[(K,) ch_num, W] the channel embeddings and ch [B] the channel of each b.
:func:`act_forward` returns A = bf16(relu(pre)) and a mask of pre > 0 (NaN
passes, as ReLU's backward reads its output). :func:`act_backward` takes the
fp32 cotangent g of A and returns g_pre = g where the mask is set, else 0, in
the compute dtype for the layer's two GEMMs, and fp32 sums of g_pre, never of
its bf16 copy: the bias gradient, the embedding gradient by channel, the
h_batch gradient per (k, b) and the h_ray gradient per (k, r).

:func:`hidden_chain` runs an MLP from its first layer's matmul (or its
product) to its output layer's matmul as one autograd function, with the
matmuls on ``torch.mm``/``torch.bmm`` (cuBLAS on the card) and the chain
between them in these two calls. It is one function because autograd casts
the cotangent of a tensor to that tensor's dtype: across a bf16 activation
the fp32 cotangent of the next matmul would arrive rounded to bf16, and
across an fp32 product the bf16 g_pre would be widened again.

The plain versions are the MLPs' earlier eager ops (the adds, ``torch.relu``,
the cast, ``torch.where`` as ReLU's backward, ``sum`` and ``index_add_``).
CPU tensors take them; CUDA tensors the kernels of ``csrc/mlp_act.cu``, or
the call raises. Each kernel call adds one to ``mlp_act.fwd_launches`` or
``mlp_act.bwd_launches`` of ``utils.profiling`` (a backward call is the
kernel and one small sum over its tiles).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from avr_torch.ops import _build
from avr_torch.utils import profiling

_MAX_W = 2048  # 8 columns a thread, one row in a block of at most 256 threads


class Layout(NamedTuple):
    """Rows m = ((k·B + b)·R + r)·C + c of a hidden layer's [M, W] tensors."""

    K: int
    B: int
    R: int
    C: int

    @property
    def rows(self) -> int:
        return self.K * self.B * self.R * self.C


def layout_of(lead: Sequence[int], K: int, ch: Optional[torch.Tensor], context: bool):
    """The Layout of rows with leading dims ``lead`` (without the trial axis)
    under K trials (0: none), and the channel of each batch group, or None.

    With the context, lead is [B, R, C...] and the channels must be per batch
    element. Without it, the batch groups are the leading dims over which ch
    varies (the rest is R, with C = 1), so that the embedding gradient sums
    whole groups.
    """
    lead = tuple(lead)
    K1 = max(K, 1)
    full = None if ch is None else torch.broadcast_to(ch, lead)
    if context:
        if len(lead) < 2:
            raise ValueError(f"mlp_act: the context needs rows [B, R, ...], got {lead}")
        lay = Layout(K1, lead[0], lead[1], math.prod(lead[2:]))
        if full is None:
            return lay, None
        if any(n != 1 and s != 0 for n, s in zip(lead[1:], full.stride()[1:])):
            raise ValueError("mlp_act: with the context the channels must be per batch element")
        return lay, full[(slice(None),) + (0,) * (len(lead) - 1)]
    if full is None:
        return Layout(K1, 1, math.prod(lead), 1), None
    j = len(lead)
    while j > 0 and (lead[j - 1] == 1 or full.stride(j - 1) == 0):
        j -= 1
    groups = full[(slice(None),) * j + (0,) * (len(lead) - j)].reshape(-1)
    return Layout(K1, math.prod(lead[:j]), math.prod(lead[j:]), 1), groups


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def act_reference(
    p: torch.Tensor, lay: Layout, bias=None, emb=None, ch=None, h_ray=None, h_batch=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (bf16 relu(pre) [M, W], bool mask [M, W] of pre > 0 or NaN)."""
    K, B, R, C = lay
    W = p.shape[-1]
    pre = p.reshape(K, B, R, C, W)
    if h_ray is not None:
        pre = pre + (h_ray.reshape(K, 1, R, 1, W) + h_batch.reshape(K, B, 1, 1, W))
    if bias is not None:
        pre = pre + bias.reshape(K, 1, 1, 1, W)
    if emb is not None:
        pre = pre + emb.reshape(K, -1, W)[:, ch.long()].reshape(K, B, 1, 1, W)
    a = torch.relu(pre)
    return a.to(torch.bfloat16).reshape(p.shape), ~(a <= 0).reshape(p.shape)


def act_backward_reference(
    g: torch.Tensor, mask: torch.Tensor, lay: Layout, ch=None, ch_num: int = 0, bias: bool = False,
    context: bool = False, out_dtype=torch.bfloat16,
):
    """Plain backward: (g_pre [M, W] in out_dtype, dbias [K, W], demb
    [K, ch_num, W], dray [K, R, W], dbatch [K, B, W]), each sum None unless
    asked for."""
    K, B, R, C = lay
    W = g.shape[-1]
    gp = torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))
    g5 = gp.reshape(K, B, R, C, W)
    per_b = g5.sum(dim=(2, 3)) if (bias or ch_num or context) else None
    dbias = per_b.sum(1) if bias else None
    demb = None
    if ch_num:
        demb = torch.zeros((K, ch_num, W), dtype=g.dtype, device=g.device).index_add_(1, ch.long(), per_b)
    dray = g5.sum(dim=(1, 3)) if context else None
    return gp.to(out_dtype), dbias, demb, dray, (per_b if context else None)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "avr_mlp_act_fwd": [_PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _LL, _INT, _INT,
                        _INT, _INT, _INT, _PTR],
    "avr_mlp_act_bwd": [_PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _LL,
                        _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR],
}


def _fn(name: str):
    fn = getattr(_build.load("mlp_act"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_rows(what: str, t: torch.Tensor, lay: Layout, dtype) -> Tuple[int, int]:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device}; the kernels take CUDA tensors (the CPU the plain version)")
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: need a contiguous 16-byte aligned 2-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    M, W = t.shape
    if M != lay.rows or W % 8 or W > _MAX_W or M * (W // 8) >= 2**31:
        raise ValueError(f"{what}: [{M}, {W}] does not fit {lay} (W a multiple of 8 up to {_MAX_W})")
    return M, W


def _table(what: str, t: Optional[torch.Tensor], lay: Layout, mid: Optional[int], W: int, dev):
    """A small table [K, (mid,) W], or without K where K is 1, as a
    contiguous fp32 CUDA tensor."""
    if t is None:
        return None
    tail = ((mid,) if mid is not None else ()) + (W,)
    shapes = [(lay.K, *tail)] + ([tail] if lay.K == 1 else [])
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) not in shapes:
        raise ValueError(f"mlp_act: {what} {t.dtype} {tuple(t.shape)} on {t.device}; "
                         f"need float32 {shapes[0]} on {dev}")
    return t.contiguous()


def _channels(ch: Optional[torch.Tensor], lay: Layout, dev):
    if ch is None:
        return None, 0
    if ch.device != dev or ch.dtype not in (torch.int32, torch.int64) or tuple(ch.shape) != (lay.B,):
        raise ValueError(f"mlp_act: channels {ch.dtype} {tuple(ch.shape)} on {ch.device}; need int32/int64 [{lay.B}] on {dev}")
    ch = ch.contiguous()
    return ch, int(ch.dtype == torch.int64)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")


def _forward_kernel(p, lay: Layout, bias=None, emb=None, ch=None, h_ray=None, h_batch=None, want_mask=True):
    M, W = _check_rows("mlp_act", p, lay, torch.float32)
    dev = p.device
    if (h_ray is None) != (h_batch is None) or (emb is None) != (ch is None):
        raise ValueError("mlp_act: h_ray and h_batch come together, and emb with ch")
    bias = _table("bias", bias, lay, None, W, dev)
    emb = None if emb is None else _table("emb", emb, lay, emb.shape[-2], W, dev)
    h_ray = _table("h_ray", h_ray, lay, lay.R, W, dev)
    h_batch = _table("h_batch", h_batch, lay, lay.B, W, dev)
    ch, ch_i64 = _channels(ch, lay, dev)
    out = torch.empty((M, W), dtype=torch.bfloat16, device=dev)
    mask = torch.empty((M, W // 8), dtype=torch.uint8, device=dev) if want_mask else None
    rc = _fn("avr_mlp_act_fwd")(
        p.data_ptr(), _ptr(bias), _ptr(emb), _ptr(ch), ch_i64, 0 if emb is None else emb.shape[-2],
        _ptr(h_ray), _ptr(h_batch), out.data_ptr(), _ptr(mask), M, W, *lay,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "mlp_act")
    profiling.count("mlp_act.fwd_launches")
    return out, mask


def backward_plan(lay: Layout, W: int, context: bool, n_sm: int) -> dict:
    """The backward's launch shape: units (rows, or with the context rays of
    C rows) a thread (nr), shell groups, units a tile, tiles, b a block, and
    the kernel's template (nray: the context's rays a thread)."""
    K, B, R, C = lay
    rpi = max(1, 256 // (W // 8))
    if context:
        # whole rays a tile, their shells split over the largest power-of-two
        # groups of thread rows that divides rpi and is at most C; the most
        # rays a thread with at least two blocks per SM
        groups = 1
        while rpi % (2 * groups) == 0 and 2 * groups <= C:
            groups *= 2
        per = rpi // groups
        nr = next((n for n in (4, 2) if K * -(-R // (per * n)) >= 2 * n_sm), 1)
        units, total, nray, b_per_block = per * nr, R, nr, B
    else:
        # the fewest partial rows with at least eight blocks per SM
        nr, groups, nray, b_per_block, total = 1, 1, 0, 1, R * C
        while nr < 64 and K * B * -(-total // (rpi * 2 * nr)) >= 8 * n_sm:
            nr *= 2
        units = rpi * nr
    return {"nr": nr, "nray": nray, "groups": groups, "units": units, "n_tiles": -(-total // units),
            "b_per_block": b_per_block, "threads": rpi * (W // 8)}


def _backward_kernel(g, mask, lay: Layout, ch=None, ch_num=0, bias=False, context=False, out_dtype=torch.bfloat16):
    M, W = _check_rows("mlp_act backward", g, lay, torch.float32)
    dev = g.device
    if mask.device != dev or mask.dtype != torch.uint8 or tuple(mask.shape) != (M, W // 8) or not mask.is_contiguous():
        raise ValueError(f"mlp_act backward: need the forward's uint8 mask [{M}, {W // 8}] on {dev}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mlp_act backward: g_pre in bf16 or fp32, not {out_dtype}")
    if ch_num and ch is None:
        raise ValueError("mlp_act backward: the embedding gradient needs the channels")
    ch, ch_i64 = _channels(ch if ch_num else None, lay, dev)
    plan = backward_plan(lay, W, context, torch.cuda.get_device_properties(dev).multi_processor_count)
    K, B, R, C = lay
    f32 = dict(dtype=torch.float32, device=dev)
    new = torch.zeros if M == 0 else torch.empty  # no rows: the sums are zero
    sums = bias or ch_num or context
    partial = torch.empty((K, B, plan["n_tiles"], W), **f32) if sums else None
    gpre = torch.empty((M, W), dtype=out_dtype, device=dev)
    dray = new((K, R, W), **f32) if context else None
    dbatch = new((K, B, W), **f32) if context else None
    dbias = new((K, W), **f32) if bias else None
    demb = new((K, ch_num, W), **f32) if ch_num else None
    rc = _fn("avr_mlp_act_bwd")(
        g.data_ptr(), mask.data_ptr(), gpre.data_ptr(), int(out_dtype == torch.bfloat16), _ptr(partial),
        _ptr(dray), _ptr(dbatch), _ptr(dbias), _ptr(demb), _ptr(ch), ch_i64, ch_num, M, W, K, B, R, C,
        plan["nray"], plan["nr"], plan["groups"], plan["units"], plan["n_tiles"], plan["b_per_block"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "mlp_act backward")
    profiling.count("mlp_act.bwd_launches")
    return gpre, dbias, demb, dray, dbatch


def _device_type(*ts) -> str:
    types = {t.device.type for t in ts if t is not None}
    if len(types) != 1 or next(iter(types)) not in ("cpu", "cuda"):
        raise ValueError(f"mlp_act: tensors on {sorted(types)}; all must be on the CPU or all on CUDA")
    return next(iter(types))


def act_forward(p, lay: Layout, bias=None, emb=None, ch=None, h_ray=None, h_batch=None, want_mask=True):
    """(A [M, W] bf16, mask or None) of the module docstring, for p [M, W] fp32."""
    if _device_type(p, bias, emb, ch, h_ray, h_batch) == "cpu":
        a, mask = act_reference(p, lay, bias, emb, ch, h_ray, h_batch)
        return a, (mask if want_mask else None)
    return _forward_kernel(p, lay, bias, emb, ch, h_ray, h_batch, want_mask)


def act_backward(g, mask, lay: Layout, ch=None, ch_num=0, bias=False, context=False, out_dtype=torch.bfloat16):
    """(g_pre [M, W] in out_dtype, dbias [K, W], demb [K, ch_num, W],
    dray [K, R, W], dbatch [K, B, W]) for the fp32 cotangent g [M, W] of A."""
    if _device_type(g, mask) == "cpu":
        return act_backward_reference(g, mask, lay, ch, ch_num, bias, context, out_dtype)
    return _backward_kernel(g, mask, lay, ch, ch_num, bias, context, out_dtype)


# ----------------------------------------------------------------------
# The chain as one autograd function
# ----------------------------------------------------------------------
def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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


@dataclass(frozen=True)
class _Spec:
    lay: Layout
    n_parts: int  # first-layer (x, w) pairs; 0: the first product is given
    context: bool
    bias: Tuple[bool, ...]  # per hidden layer
    emb: Tuple[bool, ...]
    cd: torch.dtype


def _T(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -2)


def _unflatten(spec: _Spec, ts):
    it = iter(ts)
    xs = [next(it) for _ in range(spec.n_parts)]
    w0s = [next(it) for _ in range(spec.n_parts)]
    p0 = None if spec.n_parts else next(it)
    ctx = (next(it), next(it)) if spec.context else (None, None)
    biases = [next(it) if has else None for has in spec.bias]
    embs = [next(it) if has else None for has in spec.emb]
    ch = next(it) if any(spec.emb) else None
    return xs, w0s, p0, ctx, biases, embs, ch, list(it)


def _run(spec: _Spec, xs, w0s, p0, ctx, biases, embs, ch, ws, keep: bool):
    """The chain forward: (the output layer's product, and what the backward
    keeps: the first layer's operands, the weights and every layer's A and
    mask in the compute dtype)."""
    cd = spec.cd
    xcs = [x.to(cd) for x in xs]
    w0cs = [w.to(cd) for w in w0s]
    if xcs:
        p = mm_f32(xcs[0], w0cs[0])
        for xc, wc in zip(xcs[1:], w0cs[1:]):
            p = p + mm_f32(xc, wc)
    else:
        p = p0.contiguous()
    wcs = [w.to(cd) for w in ws]
    acts, masks = [], []
    for i, wc in enumerate(wcs):
        h_ray, h_batch = ctx if i == 0 else (None, None)
        a, mask = act_forward(p.reshape(-1, p.shape[-1]), spec.lay, biases[i], embs[i],
                              ch if embs[i] is not None else None, h_ray, h_batch, want_mask=keep)
        a = a.reshape(p.shape)
        p = mm_f32(a, wc)
        if keep:
            acts.append(a)
            masks.append(mask)
    return p, xcs, w0cs, wcs, acts, masks


class _HiddenChain(torch.autograd.Function):
    """:func:`hidden_chain` with a backward that keeps every cotangent the
    kernels read in fp32 and every one the GEMMs read in the compute dtype."""

    @staticmethod
    def forward(ctx, spec: _Spec, *ts):
        xs, w0s, p0, cx, biases, embs, ch, ws = _unflatten(spec, ts)
        out, xcs, w0cs, wcs, acts, masks = _run(spec, xs, w0s, p0, cx, biases, embs, ch, ws, keep=True)
        ctx.spec = spec
        ctx.meta = [(t.shape, t.dtype) for t in ts]
        ctx.emb_rows = [0 if e is None else e.shape[-2] for e in embs]
        ctx.save_for_backward(*xcs, *w0cs, *wcs, *acts, *masks, *([ch] if ch is not None else []))
        return out

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        H, n = len(spec.bias), spec.n_parts
        saved = ctx.saved_tensors
        xcs, w0cs, wcs = saved[:n], saved[n:2 * n], saved[2 * n:2 * n + H]
        acts, masks = saved[2 * n + H:2 * n + 2 * H], saved[2 * n + 2 * H:2 * n + 3 * H]
        ch = saved[-1] if any(spec.emb) else None
        g_next = g.to(spec.cd)  # the output layer's cotangent, cast as _MatmulCD casts it
        d_ws, d_bias, d_emb, d_ctx = [None] * H, [None] * H, [None] * H, ()
        for i in reversed(range(H)):
            d_ws[i] = mm_f32(_T(acts[i]), g_next)
            dA = mm_f32(g_next, _T(wcs[i]))  # fp32: the kernel reads it unrounded
            first_ctx = spec.context and i == 0
            gp, d_bias[i], d_emb[i], d_ray, d_batch = act_backward(
                dA.reshape(-1, dA.shape[-1]), masks[i], spec.lay, ch, ctx.emb_rows[i], spec.bias[i],
                first_ctx, torch.float32 if i == 0 and n == 0 else spec.cd,
            )
            g_next = gp.reshape(dA.shape)
            if first_ctx:
                d_ctx = (d_ray, d_batch)
        if n:
            needs = ctx.needs_input_grad[1:1 + n]
            d_head = [mm_f32(g_next, _T(wc)) if need else None for wc, need in zip(w0cs, needs)]
            d_head += [mm_f32(_T(xc), g_next) for xc in xcs]
        else:
            d_head = [g_next]
        grads = [*d_head, *d_ctx, *(d for d in d_bias if d is not None), *(d for d in d_emb if d is not None),
                 *([None] if ch is not None else []), *d_ws]
        # each gradient in its input's shape and dtype
        return (None, *(None if d is None else d.reshape(s).to(dt) for d, (s, dt) in zip(grads, ctx.meta)))


def hidden_chain(
    first, weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
    embs: Sequence[Optional[torch.Tensor]], ch: Optional[torch.Tensor],
    context: Optional[Tuple[torch.Tensor, torch.Tensor]], lay: Layout, compute_dtype,
) -> torch.Tensor:
    """An MLP's H hidden layers with ReLU, from its first layer's matmul to
    its output layer's matmul (before the output bias), as one autograd
    function.

    ``first``: the first layer's fp32 product P0 ([M, W], or [K, M/K, W]
    per trial), or a list of (x, w) pairs whose products x @ w are summed
    into it. ``weights``: the H matmuls after it (the last is the output
    layer's). ``biases`` / ``embs``: per hidden layer, the bias [(K,) W] and
    the channel embedding table [(K,) ch_num, W], or None; ``ch``: the
    channel of each batch group of ``lay``; ``context``: (h_ray, h_batch),
    added in the first hidden layer. Returns the output product fp32,
    shaped like the first layer's rows ([M, d_out] or [K, M/K, d_out]).
    """
    parts = [] if isinstance(first, torch.Tensor) else list(first)
    head = [first] if not parts else [x for x, _ in parts] + [w for _, w in parts]
    spec = _Spec(
        lay=lay, n_parts=len(parts), context=context is not None,
        bias=tuple(b is not None for b in biases), emb=tuple(e is not None for e in embs), cd=compute_dtype,
    )
    ts = [*head, *(context or ()), *(b for b in biases if b is not None),
          *(e for e in embs if e is not None), *([ch] if any(spec.emb) else []), *weights]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _HiddenChain.apply(spec, *ts)
    return _run(spec, *_unflatten(spec, ts), keep=False)[0]
