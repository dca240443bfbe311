"""EfficientNet (Tan & Le, arXiv:1905.11946; Keras Applications
``EfficientNetB0`` ... ``B7``) with the project's head: global average
pool, dropout, Dense(n_classes). Layer names are Keras's.

Keras EfficientNet normalizes inside the model: ``rescaling`` (x / 255),
``normalization`` ``(x - mean) / max(sqrt(variance), 1e-7)`` with the
layer's ``mean`` and ``variance``, and ``rescaling_1`` (x / sqrt(ImageNet
std), a constant the ImageNet build carries). The benchmark hands every
reference the ``tf`` scaling, [-1, 1], so the first step here maps it back
to [0, 1], which is ``rescaling``'s output in exact arithmetic.

Each MBConv block: expand 1x1 conv, BN, swish (when the ratio is not 1);
the depthwise conv (TF ``SAME`` at stride 1, ``correct_pad`` then ``VALID``
at stride 2), BN, swish; squeeze-excite (GAP, 1x1 conv with swish, 1x1
conv with sigmoid, the gate multiplied in); project 1x1 conv, BN; the
residual where the block keeps its shape. Stochastic depth is the identity
when serving."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.layers import BatchNorm, Conv, Dense, dropout
from reference.mobilenetv2 import correct_pad


def round_filters(filters: float, width: float, divisor: int) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def swish(x: torch.Tensor) -> torch.Tensor:
    """In place: every caller hands over a tensor it holds alone."""
    return F.silu(x, inplace=True)


class Normalization(nn.Module):
    """Keras ``layers.Normalization(axis=-1)`` with its two statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("variance", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return ((x - self.mean.view(shape))
                / self.variance.sqrt().clamp(min=1e-7).view(shape))


class Model(nn.Module):
    """``config["blocks"]``: ``[kernel, repeats, filters_out, expansion,
    stride]`` of B0, scaled by ``width`` and ``depth``; ``stem_filters``
    and ``top_filters`` B0's, scaled alike; ``se_ratio`` of a block's
    input channels."""

    def __init__(self, config: dict):
        super().__init__()
        eps = float(config["bn_epsilon"])
        width, depth = config["width"], config["depth"]
        div = int(config["depth_divisor"])
        cin = config["input_shape"][2]
        self.normalization = Normalization(cin)
        self.register_buffer("std_root", torch.tensor(
            config["imagenet_std"]).sqrt().view(1, -1, 1, 1),
            persistent=False)
        stem = round_filters(config["stem_filters"], width, div)
        self.stem_conv = Conv(cin, stem, 3, stride=2, padding="VALID",
                              bias=False)
        self.stem_bn = BatchNorm(stem, eps)
        self.blocks = []
        cin = stem
        for stage, (k, repeats, f_out, t, s) in enumerate(config["blocks"],
                                                          1):
            cout = round_filters(f_out, width, div)
            for r in range(round_repeats(repeats, depth)):
                b = f"block{stage}{chr(ord('a') + r)}"
                stride = s if r == 0 else 1
                mid = cin * t
                if t != 1:
                    self.add_module(f"{b}_expand_conv",
                                    Conv(cin, mid, 1, bias=False))
                    self.add_module(f"{b}_expand_bn", BatchNorm(mid, eps))
                self.add_module(f"{b}_dwconv", Conv(
                    mid, mid, k, stride=stride,
                    padding="SAME" if stride == 1 else "VALID", groups=mid,
                    bias=False))
                self.add_module(f"{b}_bn", BatchNorm(mid, eps))
                se = max(1, int(cin * config["se_ratio"]))
                self.add_module(f"{b}_se_reduce", Conv(mid, se, 1))
                self.add_module(f"{b}_se_expand", Conv(se, mid, 1))
                self.add_module(f"{b}_project_conv",
                                Conv(mid, cout, 1, bias=False))
                self.add_module(f"{b}_project_bn", BatchNorm(cout, eps))
                self.blocks.append((b, t != 1, k, stride,
                                    stride == 1 and cin == cout))
                cin = cout
        top = round_filters(config["top_filters"], width, div)
        self.top_conv = Conv(cin, top, 1, bias=False)
        self.top_bn = BatchNorm(top, eps)
        self.rate = float(config["dropout"])
        self.logits = Dense(top, config["n_classes"])

    def forward(self, x: torch.Tensor, generator=None):
        """NHWC float32 input in [-1, 1] -> ``(logits, {})``; dropout draws
        from ``generator`` when one is given."""
        m = self._modules
        x = (x.permute(0, 3, 1, 2) + 1.0) / 2.0
        x = self.normalization(x) / self.std_root
        x = F.pad(x, correct_pad(x.shape[-2:], 3))
        x = swish(self.stem_bn(self.stem_conv(x)))
        for b, expand, k, stride, residual in self.blocks:
            y = x
            if expand:
                y = swish(m[f"{b}_expand_bn"](m[f"{b}_expand_conv"](y)))
            if stride == 2:
                y = F.pad(y, correct_pad(y.shape[-2:], k))
            y = swish(m[f"{b}_bn"](m[f"{b}_dwconv"](y)))
            gate = swish(m[f"{b}_se_reduce"](y.mean((2, 3), keepdim=True)))
            y = y * torch.sigmoid(m[f"{b}_se_expand"](gate))
            y = m[f"{b}_project_bn"](m[f"{b}_project_conv"](y))
            x = x + y if residual else y
        x = swish(self.top_bn(self.top_conv(x)))
        x = dropout(x.mean((2, 3)), self.rate, generator)
        return self.logits(x), {}
