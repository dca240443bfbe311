"""TF ``SAME`` padding, shared by the graph's convs and pools and by the
depthwise reference: the pads that give ``ceil(size / stride)`` outputs,
the odd pixel after (bottom/right)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Tuple[int, int],
             strides: Tuple[int, int], value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor for a TF ``SAME`` window (a no-op when the pads
    are zero, as for a 1x1 kernel at stride 2)."""
    (top, bottom), (left, right) = (
        same_pads(x.shape[2], kernel[0], strides[0]),
        same_pads(x.shape[3], kernel[1], strides[1]))
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x
