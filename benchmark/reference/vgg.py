"""VGG16 (Simonyan & Zisserman, arXiv:1409.1556; Keras Applications
``VGG16``) cut after the configuration's blocks, with the project's head:
global average pool, dropout, Dense(n_classes). Layer names are Keras's."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.layers import Conv, Dense, dropout


class Model(nn.Module):
    """``config["blocks"]``: ``[convs, filters, pool after]`` per block;
    every conv 3x3 ``SAME`` with a bias and a ReLU; pools 2x2 max."""

    def __init__(self, config: dict):
        super().__init__()
        cin = config["input_shape"][2]
        self.plan = []
        for b, (convs, filters, pool) in enumerate(config["blocks"], 1):
            for c in range(1, convs + 1):
                name = f"block{b}_conv{c}"
                self.add_module(name, Conv(cin, filters, config["kernel"]))
                self.plan.append(name)
                cin = filters
            if pool:
                self.plan.append(None)
        self.rate = float(config["dropout"])
        self.logits = Dense(cin, config["n_classes"])

    def forward(self, x: torch.Tensor, generator=None):
        """NHWC float32 model input -> ``(logits, {})``; dropout draws from
        ``generator`` when one is given (training)."""
        x = x.permute(0, 3, 1, 2)
        for name in self.plan:
            if name is None:
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(self._modules[name](x))
        x = dropout(x.mean((2, 3)), self.rate, generator)
        return self.logits(x), {}
