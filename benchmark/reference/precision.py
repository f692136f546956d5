"""Arithmetic precision of the reference: float32, or the control's fp8.

The reference computes in float32 with TF32 off. The control is the same
reference with the operands of every matmul and of the hash-grid
interpolation rounded to fp8 (e4m3, one scale per tensor from its largest
magnitude, as fp8 training scales a tensor), the products summed in
float32: the step below the bf16 that the configurations state.
"""

from __future__ import annotations

import contextlib

import torch

FP32 = "fp32"
FP8 = "fp8"
BF16 = "bf16"  # a witness: the configurations' own precision, in the reference
_E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 under a per-tensor scale, returned in float32."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, _E4M3_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.float().to(torch.bfloat16).float()


_ROUND = {FP8: round_fp8, BF16: round_bf16}


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """t in ``precision``; the rounding passes the gradient through unchanged."""
    if precision == FP32:
        return t
    return t + (_ROUND[precision](t) - t).detach()


class _LowMatmul(torch.autograd.Function):
    """x @ w with both operands, and the incoming gradient, rounded."""

    @staticmethod
    def forward(ctx, x, w, precision):
        q = _ROUND[precision]
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq)
        ctx.q = q
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.q(g)
        dx = gq @ wq.transpose(-1, -2)
        dw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ gq.reshape(-1, gq.shape[-1]))
        return dx, dw, None


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out] in ``precision``, summed in float32."""
    if precision == FP32:
        return x @ w
    return _LowMatmul.apply(x, w, precision)
