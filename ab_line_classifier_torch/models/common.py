"""Shared model-zoo infrastructure: ModelSpec and the classifier head (the
serving part of the JAX package's ``models/common.py``). The training
phases, optimizers and activity regularizers, and the head's ``fc0``
variant, come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

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


def classifier_head(backbone: G.LayerGraph, *, n_classes: int,
                    dropout: float,
                    output_bias: Optional[np.ndarray] = None
                    ) -> G.LayerGraph:
    """Append the standard head: GAP -> Dropout -> Dense(n_classes) ->
    float32 softmax."""
    src = backbone.output
    return backbone.append([
        G.global_avg_pool("global_avgpool", src),
        G.dropout("dropout_head", "global_avgpool", dropout),
        G.dense("logits", "dropout_head", backbone.features_of(src),
                n_classes, bias_init=output_bias_init(output_bias)),
        G.softmax("output", "logits"),
    ], output="output")
