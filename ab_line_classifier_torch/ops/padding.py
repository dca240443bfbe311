"""TF ``SAME`` padding, shared by the graph's convs and pools and by the
depthwise reference: the pads that give ``ceil(size / stride)`` outputs,
the odd pixel after (bottom/right); and :func:`pad_hw`, the spatial pad
every graph layer uses, which keeps the channels_last layout of stacked
trials under ``torch.func.vmap``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _PadHW(torch.autograd.Function):
    """A constant pad of the last two (H, W) axes of an NCHW tensor. Its
    batching rule pads the stacked trials' physical tensor with its
    channels last, as ``[B, H, W, F, C]``: vmap's own rule pads the 5-D
    tensor into plain contiguous memory, which would leave every later
    layer in NCHW (and kernel B2 an input to copy)."""

    @staticmethod
    def forward(x, pads, value):
        return F.pad(x, pads, value=value)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.pads = inputs[1]

    @staticmethod
    def backward(ctx, g):
        left, right, top, bottom = ctx.pads
        h, w = g.shape[-2:]
        return g[..., top:h - bottom, left:w - right], None, None

    @staticmethod
    def vmap(info, in_dims, x, pads, value):
        left, right, top, bottom = pads
        x = x.movedim(in_dims[0], 1).permute(0, 3, 4, 1, 2)
        y = F.pad(x, (0, 0, 0, 0, left, right, top, bottom), value=value)
        return y.permute(0, 3, 4, 1, 2), 1


def pad_hw(x: torch.Tensor, pads: Tuple[int, int, int, int],
           value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, pads, value=value)`` of an NCHW tensor's H and W axes
    (``pads`` = (left, right, top, bottom)); under ``torch.func.vmap``
    through :class:`_PadHW`, whose rule keeps the stacked trials'
    channels_last layout."""
    if torch._C._functorch.is_batchedtensor(x):
        return _PadHW.apply(x, tuple(pads), value)
    return F.pad(x, pads, value=value)


def pad_same(x: torch.Tensor, kernel: Tuple[int, int],
             strides: Tuple[int, int], value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor for a TF ``SAME`` window (a no-op when the pads
    are zero, as for a 1x1 kernel at stride 2)."""
    (top, bottom), (left, right) = (
        same_pads(x.shape[2], kernel[0], strides[0]),
        same_pads(x.shape[3], kernel[1], strides[1]))
    if top or bottom or left or right:
        x = pad_hw(x, (left, right, top, bottom), value)
    return x
