"""Plain layers of the reference models, float32, NCHW inside."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_FORWARD = (torch.float8_e4m3fn, 448.0)
FP8_BACKWARD = (torch.float8_e5m2, 57344.0)


def _round(x: torch.Tensor, kind) -> torch.Tensor:
    """``x`` rounded to a float8 format after scaling its largest magnitude
    to the format's largest value, and scaled back."""
    dtype, top = kind
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Rounds the value to e4m3 going forward and its gradient to e5m2
    going back, as float8 training rounds activations, weights and
    gradients."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, FP8_FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _round(g, FP8_BACKWARD)


def lowered(x: Optional[torch.Tensor], precision) -> Optional[torch.Tensor]:
    if x is None or precision is None:
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


def same_padding(size: Tuple[int, int], kernel: Tuple[int, int],
                 stride: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """TensorFlow's ``SAME`` padding as ``F.pad``'s (left, right, top,
    bottom): output ``ceil(n / s)``, the odd pixel after."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    return (left, right, top, bottom)


class Conv(nn.Conv2d):
    """Keras Conv2D / DepthwiseConv2D (``groups`` = channels): TF ``SAME``
    or ``VALID`` padding; the weight ``[out, in / groups, kh, kw]``. With a
    ``precision`` its input, weight and output are rounded to it (each
    layer's output is what the next reads), as :class:`Dense`'s and
    :class:`BatchNorm`'s output."""

    precision = None

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", groups: int = 1, bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)
        self.tf_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tf_padding == "SAME":
            x = F.pad(x, same_padding(x.shape[-2:], self.kernel_size,
                                      self.stride))
        return lowered(F.conv2d(lowered(x, self.precision),
                                lowered(self.weight, self.precision),
                                self.bias, self.stride, 0, 1, self.groups),
                       self.precision)


class Dense(nn.Linear):
    precision = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lowered(F.linear(lowered(x, self.precision),
                                lowered(self.weight, self.precision),
                                self.bias), self.precision)


class BatchNorm(nn.Module):
    """Keras BatchNormalization in inference form (the configurations'
    batch norms are frozen in training too): ``(x - mean) / sqrt(var +
    eps) * gamma + beta``."""

    precision = None

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        inv = (self.running_var + self.eps).rsqrt() * self.weight
        return lowered((x - self.running_mean.view(shape)) * inv.view(shape)
                       + self.bias.view(shape), self.precision)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout in training (a generator given): each element kept
    where a uniform draw of the generator, one per element in row-major
    order, is below ``1 - rate``, and scaled by ``1 / (1 - rate)``."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, device=x.device, generator=generator)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))
