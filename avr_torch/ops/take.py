"""``take(x, dim, idx)``: ``x`` indexed by an integer tensor along one dim,
as ``x[..., idx]`` at that dim, with a backward that reads nothing back to
the host.

Autograd's backward of such an index is ``index_put`` with accumulation,
which on a CUDA card first checks the indices' range on the host (a min and
a max read back, two synchronisations). That stalls the step and is refused
inside a CUDA graph's capture. Here the backward is the same accumulating
``index_put`` kernel without the check: the forward's indexing already
checked the indices, on the device. Forward and gradient are bit-equal to
autograd's.
"""

from __future__ import annotations

import torch


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.dim, ctx.shape = dim, x.shape
        return x[(slice(None),) * dim + (idx,)]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros(ctx.shape)
        torch.ops.aten._index_put_impl_(out, [None] * ctx.dim + [idx], g, accumulate=True, unsafe=True)
        return out, None, None


def take(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """x indexed by the integer tensor idx along ``dim`` (0 ≤ dim < x.dim()):
    idx.shape takes the place of that dim."""
    return _Take.apply(x, dim, idx)
