"""MobileNetV2 with Keras layer-name and layer-index parity (port of the JAX
package's ``models/mobilenet_v2.py``).

The graph reproduces the Keras layer list (154 layers for alpha 1.0,
include_top=False), so ``CUTOFF_IDX`` 115 is ``block_12_add`` and
``FREEZE_IDX`` keeps its meaning. At 128x128 the kept stack has 13
inverted-residual blocks: 10 stride-1 ``SAME`` depthwise layers (the CUDA
depthwise kernel, from ``[B, 64, 64, 32]`` down to ``[B, 8, 8, 576]``) and 3
stride-2 ones behind a ``correct_pad`` zero pad (grouped conv).

Head: GAP -> Dropout -> Dense(NODES_DENSE0, relu) -> Dropout ->
Dense(n_classes) -> softmax, with an L2 activity regularizer (L2_LAMBDA) on
``fc0``. One Adam phase at LR; layers up to FREEZE_IDX and every batch norm
of the backbone are frozen (Keras ``freeze_layers``), so those batch norms
run in inference mode in training.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import common as C
from ab_line_classifier_torch.ops.bn_act_cuda import relu6

# Inverted-residual stages (expansion t, channels c, repeats n, stride s)
# for alpha 1.0.
MBV2_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

_BN = dict(momentum=0.999, epsilon=1e-3)  # Keras MobileNetV2's BN settings
# ReLU6, stated as data so the batch norm pass can take it (graph.py).
_RELU6 = dict(fn=relu6, op=("relu6",))


def mobilenetv2_backbone(input_size: Tuple[int, int] = (128, 128),
                         in_channels: int = 3) -> G.LayerGraph:
    """Full MobileNetV2 backbone, Keras layer order and names."""
    specs: List[G.LayerSpec] = []
    size = tuple(input_size)

    specs.append(G.conv2d("Conv1", G.INPUT, in_channels, 32, (3, 3),
                          strides=(2, 2), padding="SAME", use_bias=False))
    size = C.stride2_out(size)
    specs.append(G.batch_norm("bn_Conv1", "Conv1", 32, **_BN))
    specs.append(G.activation("Conv1_relu", "bn_Conv1", **_RELU6))
    prev, in_ch = "Conv1_relu", 32

    block_id = 0
    for t, c, n, s in MBV2_STAGES:
        for i in range(n):
            stride = s if i == 0 else 1
            if block_id == 0:
                p, x, dw_in = "expanded_conv", prev, in_ch
            else:
                p, dw_in = f"block_{block_id}", in_ch * t
                specs.append(G.conv2d(f"{p}_expand", prev, in_ch, dw_in,
                                      (1, 1), use_bias=False))
                specs.append(G.batch_norm(f"{p}_expand_BN", f"{p}_expand",
                                          dw_in, **_BN))
                specs.append(G.activation(f"{p}_expand_relu",
                                          f"{p}_expand_BN", **_RELU6))
                x = f"{p}_expand_relu"

            if stride == 2:
                specs.append(G.zero_pad(f"{p}_pad", x, C.correct_pad(size, 3)))
                specs.append(G.depthwise_conv2d(
                    f"{p}_depthwise", f"{p}_pad", dw_in, (3, 3),
                    strides=(2, 2), padding="VALID"))
                size = C.stride2_out(size)
            else:
                specs.append(G.depthwise_conv2d(f"{p}_depthwise", x, dw_in,
                                                (3, 3), padding="SAME"))
            specs.append(G.batch_norm(f"{p}_depthwise_BN", f"{p}_depthwise",
                                      dw_in, **_BN))
            specs.append(G.activation(f"{p}_depthwise_relu",
                                      f"{p}_depthwise_BN", **_RELU6))
            specs.append(G.conv2d(f"{p}_project", f"{p}_depthwise_relu",
                                  dw_in, c, (1, 1), use_bias=False))
            specs.append(G.batch_norm(f"{p}_project_BN", f"{p}_project", c,
                                      **_BN))
            out = f"{p}_project_BN"
            if stride == 1 and in_ch == c and block_id > 0:
                specs.append(G.add(f"{p}_add", prev, out))
                out = f"{p}_add"
            prev, in_ch = out, c
            block_id += 1

    specs.append(G.conv2d("Conv_1", prev, in_ch, 1280, (1, 1),
                          use_bias=False))
    specs.append(G.batch_norm("Conv_1_bn", "Conv_1", 1280, **_BN))
    specs.append(G.activation("out_relu", "Conv_1_bn", **_RELU6))
    return G.graph_of(*specs)


def build_mobilenetv2(hparams: Dict[str, Any],
                      input_shape: Tuple[int, int, int], n_classes: int,
                      mixed_precision: bool = False,
                      output_bias: Optional[np.ndarray] = None
                      ) -> C.ModelSpec:
    full = mobilenetv2_backbone(tuple(input_shape[:2]), input_shape[-1])
    backbone = full.cut(int(hparams.get("CUTOFF_IDX", len(full.layers) - 1)))
    graph, regs = C.classifier_head(
        backbone, n_classes=n_classes, dropout=float(hparams["DROPOUT"]),
        output_bias=output_bias, fc0_nodes=int(hparams["NODES_DENSE0"]),
        fc0_l2=float(hparams.get("L2_LAMBDA", 0.0)), double_dropout=True)
    phases = C.single_phase(graph, int(hparams.get("FREEZE_IDX", -1)),
                            float(hparams["LR"]),
                            backbone_len=len(backbone.layers))
    return C.ModelSpec(name="mobilenetv2", graph=graph, preprocess_mode="tf",
                       input_shape=tuple(input_shape), n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases,
                       activity_regularizers=regs)
