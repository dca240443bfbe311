"""MobileNetV2 (Sandler et al., arXiv:1801.04381; Keras Applications
``MobileNetV2``, alpha 1.0) through the configuration's last block, with the
project's head: global average pool, dropout, Dense(fc0, ReLU), dropout,
Dense(n_classes). Layer names are Keras's."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.layers import BatchNorm, Conv, Dense, dropout


def correct_pad(size, kernel: int):
    """Keras ``imagenet_utils.correct_pad`` as ``F.pad``'s (left, right,
    top, bottom)."""
    adjust = (1 - size[0] % 2, 1 - size[1] % 2)
    c = kernel // 2
    return (c - adjust[1], c, c - adjust[0], c)


class Model(nn.Module):
    """``config["stages"]``: ``[expansion, channels, repeats, stride]``;
    blocks numbered from 0 across the stages, kept through
    ``config["last_block"]``."""

    def __init__(self, config: dict):
        super().__init__()
        eps = float(config["bn_epsilon"])
        first = int(config["first_filters"])
        self.Conv1 = Conv(config["input_shape"][2], first, 3, stride=2,
                          bias=False)
        self.bn_Conv1 = BatchNorm(first, eps)
        self.blocks = []
        cin, block = first, 0
        for t, c, n, s in config["stages"]:
            for i in range(n):
                if block > config["last_block"]:
                    break
                stride = s if i == 0 else 1
                p = "expanded_conv" if block == 0 else f"block_{block}"
                mid = cin * t
                if block:
                    self.add_module(f"{p}_expand", Conv(cin, mid, 1,
                                                        bias=False))
                    self.add_module(f"{p}_expand_BN", BatchNorm(mid, eps))
                self.add_module(f"{p}_depthwise", Conv(
                    mid, mid, 3, stride=stride,
                    padding="SAME" if stride == 1 else "VALID", groups=mid,
                    bias=False))
                self.add_module(f"{p}_depthwise_BN", BatchNorm(mid, eps))
                self.add_module(f"{p}_project", Conv(mid, c, 1, bias=False))
                self.add_module(f"{p}_project_BN", BatchNorm(c, eps))
                self.blocks.append((p, block > 0, stride,
                                    stride == 1 and cin == c))
                cin, block = c, block + 1
        self.rate = float(config["dropout"])
        self.fc0 = Dense(cin, config["fc0"])
        self.logits = Dense(config["fc0"], config["n_classes"])

    def forward(self, x: torch.Tensor, generator=None):
        """NHWC float32 model input -> ``(logits, {"fc0": its ReLU
        output})``; dropout draws from ``generator`` when one is given."""
        m = self._modules
        x = x.permute(0, 3, 1, 2)
        x = F.relu6(self.bn_Conv1(self.Conv1(x)))
        for p, expand, stride, residual in self.blocks:
            y = x
            if expand:
                y = F.relu6(m[f"{p}_expand_BN"](m[f"{p}_expand"](y)))
            if stride == 2:
                y = F.pad(y, correct_pad(y.shape[-2:], 3))
            y = F.relu6(m[f"{p}_depthwise_BN"](m[f"{p}_depthwise"](y)))
            y = m[f"{p}_project_BN"](m[f"{p}_project"](y))
            x = x + y if residual else y
        x = dropout(x.mean((2, 3)), self.rate, generator)
        fc0 = F.relu(self.fc0(x))
        return self.logits(dropout(fc0, self.rate, generator)), {"fc0": fc0}
