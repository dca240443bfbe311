"""``custom_resnetv2``, a bottleneck pre-activation ResNetV2 (port of the
JAX package's ``models/resnet_v2.py``).

A conv-first stem (conv -> BN -> relu), then 3 stages of BLOCKS bottleneck
units in pre-activation order (BN -> relu -> conv) with a 1x1 projection
shortcut on each stage's first unit, then SpatialDropout -> GAP ->
Dense-softmax. Stage 0 expands filters x4; stages 1-2 expand x2 and
down-sample with stride-2 ``SAME`` convs in their first unit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import common as C


def _residual_chain(specs: List[G.LayerSpec], prefix: str, inp: str,
                    in_ch: int, num_filters: int, stride: int = 1,
                    kernel_size: int = 3, activation: bool = True,
                    bn: bool = True, conv_first: bool = True) -> str:
    """Append one reference ``residual_block``: conv -> bn -> act when
    ``conv_first`` else bn -> act -> conv. Returns the final node's name."""
    prev = inp

    def conv():
        nonlocal prev
        specs.append(G.conv2d(f"{prefix}_conv", prev, in_ch, num_filters,
                              (kernel_size, kernel_size),
                              strides=(stride, stride), padding="SAME"))
        prev = f"{prefix}_conv"

    def bn_act(width: int):
        nonlocal prev
        if bn:
            specs.append(G.batch_norm(f"{prefix}_bn", prev, width))
            prev = f"{prefix}_bn"
        if activation:
            specs.append(G.relu(f"{prefix}_act", prev))
            prev = f"{prefix}_act"

    if conv_first:
        conv()
        bn_act(num_filters)
    else:
        bn_act(in_ch)
        conv()
    return prev


def build_custom_resnetv2(hparams: Dict[str, Any],
                          input_shape: Tuple[int, int, int], n_classes: int,
                          mixed_precision: bool = False,
                          output_bias: Optional[np.ndarray] = None
                          ) -> C.ModelSpec:
    num_filters_in = int(hparams.get("INIT_FILTERS", 16))
    num_res_block = int(hparams.get("BLOCKS", 2))
    dropout1 = float(hparams.get("DROPOUT1", 0.4))

    specs: List[G.LayerSpec] = []
    x = _residual_chain(specs, "stem", G.INPUT, input_shape[-1],
                        num_filters_in, conv_first=True)
    x_ch = num_filters_in
    for stage in range(3):
        for unit in range(num_res_block):
            activation = bn = True
            stride = 1
            if stage == 0:
                num_filters_out = num_filters_in * 4
                if unit == 0:
                    activation = bn = False
            else:
                num_filters_out = num_filters_in * 2
                if unit == 0:
                    stride = 2
            p = f"stage{stage}_unit{unit}"
            y = _residual_chain(specs, f"{p}_a", x, x_ch, num_filters_in,
                                kernel_size=1, stride=stride,
                                activation=activation, bn=bn,
                                conv_first=False)
            y = _residual_chain(specs, f"{p}_b", y, num_filters_in,
                                num_filters_in, conv_first=False)
            y = _residual_chain(specs, f"{p}_c", y, num_filters_in,
                                num_filters_out, kernel_size=1,
                                conv_first=False)
            if unit == 0:
                # Linear projection shortcut to the changed dims.
                x = _residual_chain(specs, f"{p}_proj", x, x_ch,
                                    num_filters_out, kernel_size=1,
                                    stride=stride, activation=False,
                                    bn=False, conv_first=True)
            specs.append(G.add(f"{p}_add", x, y))
            x, x_ch = f"{p}_add", num_filters_out
        num_filters_in = num_filters_out

    # SpatialDropout2D drops whole channels: one draw per (sample, channel).
    specs.append(G.dropout("spatial_dropout", x, dropout1,
                           broadcast_dims=(1, 2)))
    specs.append(G.global_avg_pool("global_avgpool", "spatial_dropout"))
    specs.append(G.dense("logits", "global_avgpool", x_ch, n_classes,
                         bias_init=C.output_bias_init(output_bias)))
    specs.append(G.softmax("output", "logits"))
    graph = G.graph_of(*specs, output="output")
    # The reference model function never freezes: its batch norms train.
    phases = C.single_phase(graph, -1, float(hparams["LR"]),
                            freeze_bn=False)
    return C.ModelSpec(name="custom_resnetv2", graph=graph,
                       preprocess_mode="tf", input_shape=tuple(input_shape),
                       n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases)
