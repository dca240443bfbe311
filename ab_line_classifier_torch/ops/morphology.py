"""Binary morphology on the device, the auto-masking path's mask cleanup
(port of the JAX package's ``ops/morphology.py``).

The reference cleans masks with cv2 on the host: an elliptical erode (the
edge-preserve kernel), an elliptical dilate (the smoothing kernel), a 5x5
box filter over the per-frame mask average and a majority vote. Here, as
in the JAX package, each is a convolution of ``[B, H, W]`` tensors: for a
binary image B and structuring element S,

    dilate(B, S) = conv(B, S) > 0
    erode(B, S)  = conv(B, S) == sum(S)

Every value that reaches a comparison is a small integer held exactly in
float32, so the results are exact on any device and under TF32 too. Border
semantics are cv2's: erosion treats outside pixels as 1, dilation as 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ellipse_kernel(size: int) -> np.ndarray:
    """Elliptical structuring element, bit-exact with
    ``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))``: centre
    at ``size // 2``, row ``i`` filled over ``[c - dx, c + dx]`` with
    ``dx = round_half_even(c * sqrt(r^2 - dy^2) / r)`` (cv2's 3x3 is the
    5-pixel cross)."""
    size = max(int(size), 1)
    r = size // 2
    if r == 0:
        return np.ones((1, 1), np.float32)
    c = size // 2
    k = np.zeros((size, size), np.float32)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0)) / r))
            k[i, max(c - dx, 0): min(c + dx + 1, size)] = 1.0
    return k


def _conv2d_same(x: torch.Tensor, kernel: torch.Tensor,
                 pad_value: float) -> torch.Tensor:
    """2-D correlation of ``[B, H, W]`` with cv2's anchor and an explicit
    border fill. cv2 anchors the element at ``(kh // 2, kw // 2)``
    unflipped, so the pad split is ``(k // 2, (k - 1) // 2)``: for an even
    kernel the larger pad goes BEFORE, where ``padding="same"`` puts it
    after (one pixel of shift at the 24x24 ellipse of a 480-row clip)."""
    kh, kw = kernel.shape
    xp = F.pad(x.to(torch.float32)[:, None],
               (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2),
               value=pad_value)
    return F.conv2d(xp, kernel.to(torch.float32)[None, None])[:, 0]


def binary_dilate(mask: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` binary dilate."""
    conv = _conv2d_same(mask, kernel, pad_value=0.0)
    return (conv > 0.5).to(mask.dtype)


def binary_erode(mask: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` binary erode (outside counts as 1). The threshold is
    ``kernel``'s sum as a 0-dim tensor, read by the compare on the device,
    so a CUDA graph can capture it; it is exact (an integer of at most
    54 * 54 in float32)."""
    conv = _conv2d_same(mask, kernel, pad_value=1.0)
    return (conv >= kernel.sum() - 0.5).to(mask.dtype)


def _window_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over each ``size x size`` window of ``[B, H, W]``, cv2's default
    BORDER_REFLECT_101 border (``F.pad``'s ``reflect``)."""
    ph = (size - 1) // 2
    xp = F.pad(x.to(torch.float32)[:, None],
               (ph, size - 1 - ph, ph, size - 1 - ph), mode="reflect")
    ones = torch.ones((1, 1, size, size), dtype=torch.float32,
                      device=x.device)
    return F.conv2d(xp, ones)[:, 0]


def box_filter(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Mean filter (cv2.filter2D with a normalized box): the window sum
    over ``size * size``."""
    return _window_sum(x, size) / float(size * size)


_ellipses: Dict[tuple, torch.Tensor] = {}


def _device_ellipse(size: int, device: torch.device) -> torch.Tensor:
    """:func:`ellipse_kernel` on ``device``, made once per ``(size,
    device)``: a call after the first copies nothing from the host, so a
    CUDA graph can capture it."""
    key = (int(size), device)
    k = _ellipses.get(key)
    if k is None:
        k = _ellipses[key] = torch.as_tensor(ellipse_kernel(size),
                                             device=device)
    return k


def clean_binary_masks(binary_masks: torch.Tensor, *, erode_size: int,
                       dilate_size: int) -> torch.Tensor:
    """Elliptical erode then dilate of ``[B, H, W]`` binary masks; float32
    0/1 out."""
    dev = binary_masks.device
    binary = binary_masks.to(torch.float32)
    binary = binary_erode(binary, _device_ellipse(erode_size, dev))
    return binary_dilate(binary, _device_ellipse(dilate_size, dev))


def clean_masks(prob_masks: torch.Tensor, *, erode_size: int,
                dilate_size: int, threshold: float = 0.4) -> torch.Tensor:
    """Threshold the U-Net probabilities, then :func:`clean_binary_masks`."""
    return clean_binary_masks((prob_masks > threshold).to(torch.float32),
                              erode_size=erode_size, dilate_size=dilate_size)


def majority_average_mask(binary_masks: torch.Tensor) -> torch.Tensor:
    """Average the sampled frames' masks, 5x5 smooth, majority vote:
    ``[B, H, W]`` in, ``[H, W]`` float32 0/1 out.

    The vote ``box(sum) >= n / 2`` is taken on the integer window sum,
    ``25 * box(sum) >= 12.5 * n``, which is exact; an exact tie (even n)
    maps to 1, the JAX package's documented choice. Its float32 mean of
    25 products by 1/25 may round a tie either way."""
    total = binary_masks.to(torch.float32).sum(dim=0, keepdim=True)
    window = _window_sum(total, 5)[0]
    return (2.0 * window >= 25.0 * binary_masks.shape[0]).to(torch.float32)


def bounding_box(mask) -> Tuple[int, int, int, int]:
    """``(min_row, max_row, min_col, max_col)`` of the nonzero area (the
    whole frame when there is none)."""
    mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    i, j = np.where(mask)
    if len(i) == 0:
        h, w = mask.shape
        return (0, h - 1, 0, w - 1)
    return (int(i.min()), int(i.max()), int(j.min()), int(j.max()))
