"""Shared model-zoo infrastructure: ModelSpec, the classifier head and the
stride-2 padding helpers (the serving part of the JAX package's
``models/common.py``). The training phases, optimizers and activity
regularizers come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A fully-specified zoo model. ``dtype`` is the compute dtype the
    model serves in: bfloat16 for a mixed-precision model, float32
    otherwise (the JAX package bakes the same choice into its layers)."""

    name: str
    graph: G.LayerGraph
    preprocess_mode: str
    input_shape: Tuple[int, int, int]
    n_classes: int
    dtype: torch.dtype = torch.float32

    def module(self, capture: Tuple[str, ...] = (),
               generator: Optional[torch.Generator] = None) -> G.GraphModule:
        """A freshly initialized (Keras initializers) float32 module on the
        CPU; ``generator`` seeds it (default: seed 0)."""
        return G.GraphModule(self.graph, capture=capture, generator=generator)

    @property
    def last_conv_layer(self) -> str:
        """Last conv-like layer (the Grad-CAM tap)."""
        return self.graph.last_layer_of_kind(G.KIND_CONV, G.KIND_DEPTHWISE)


def compute_dtype(mixed_precision: bool) -> torch.dtype:
    return torch.bfloat16 if mixed_precision else torch.float32


def output_bias_init(output_bias: Optional[np.ndarray]
                     ) -> Optional[Callable[[torch.Tensor], None]]:
    """Keras ``bias_initializer=Constant(log_odds)`` equivalent: fills the
    final Dense bias in place."""
    if output_bias is None:
        return None
    arr = np.asarray(output_bias, dtype=np.float32)

    def init(bias: torch.Tensor) -> None:
        bias.copy_(torch.as_tensor(arr).expand(bias.shape))

    return init


def correct_pad(size: Tuple[int, int], kernel: int
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Keras ``imagenet_utils.correct_pad``: the zero padding before a
    stride-2 ``VALID`` conv that makes its output ``ceil(size / 2)``."""
    adjust = (1 - size[0] % 2, 1 - size[1] % 2)
    correct = kernel // 2
    return ((correct - adjust[0], correct), (correct - adjust[1], correct))


def stride2_out(size: Tuple[int, int]) -> Tuple[int, int]:
    """Spatial size after a correct_pad + stride-2 ``VALID`` conv (or a
    stride-2 ``SAME`` one): ``ceil(s / 2)`` for both parities."""
    return ((size[0] + 1) // 2, (size[1] + 1) // 2)


def classifier_head(backbone: G.LayerGraph, *, n_classes: int,
                    dropout: float,
                    output_bias: Optional[np.ndarray] = None,
                    fc0_nodes: Optional[int] = None,
                    double_dropout: bool = False) -> G.LayerGraph:
    """Append the standard head: GAP -> Dropout [-> Dense(fc0_nodes) with a
    fused relu (one node, as Keras ``Dense(activation='relu')``) (->
    Dropout)] -> Dense(n_classes) -> float32 softmax."""
    src = backbone.output
    specs: List[G.LayerSpec] = [
        G.global_avg_pool("global_avgpool", src),
        G.dropout("dropout_head", "global_avgpool", dropout)]
    prev, width = "dropout_head", backbone.features_of(src)
    if fc0_nodes:
        specs.append(G.dense("fc0", prev, width, fc0_nodes, act=F.relu))
        prev, width = "fc0", fc0_nodes
        if double_dropout:
            specs.append(G.dropout("dropout_head1", prev, dropout))
            prev = "dropout_head1"
    specs += [G.dense("logits", prev, width, n_classes,
                      bias_init=output_bias_init(output_bias)),
              G.softmax("output", "logits")]
    return backbone.append(specs, output="output")
