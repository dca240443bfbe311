"""Xception: the full Keras backbone + GAP/Dropout/Dense-softmax head (port
of the JAX package's ``models/xception.py``).

Layer names and order are Keras's, including its auto-names for the
residual-projection convs (``conv2d`` .. ``conv2d_3``), their batch norms
(``batch_normalization`` .. ``_3``) and the merge nodes (``add`` ..
``add_11``), and its ordering (a down-sampling block's residual conv and BN
come after its sepconvs and pool). The 34 separable convs each hold one
stride-1 ``SAME`` 3x3 depthwise layer (the CUDA depthwise kernel), at
61/31/16/8/4 px for a 128x128 input.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import common as C


def xception_backbone(in_channels: int = 3) -> G.LayerGraph:
    specs: List[G.LayerSpec] = []

    def sepconv_bn(name: str, inp: str, in_ch: int, filters: int) -> str:
        specs.append(G.separable_conv2d(name, inp, in_ch, filters, (3, 3),
                                        use_bias=False))
        specs.append(G.batch_norm(f"{name}_bn", name, filters))
        return f"{name}_bn"

    # Entry flow, stem (VALID padding, as in Keras).
    specs.append(G.conv2d("block1_conv1", G.INPUT, in_channels, 32, (3, 3),
                          strides=(2, 2), padding="VALID", use_bias=False))
    specs.append(G.batch_norm("block1_conv1_bn", "block1_conv1", 32))
    specs.append(G.relu("block1_conv1_act", "block1_conv1_bn"))
    specs.append(G.conv2d("block1_conv2", "block1_conv1_act", 32, 64, (3, 3),
                          padding="VALID", use_bias=False))
    specs.append(G.batch_norm("block1_conv2_bn", "block1_conv2", 64))
    specs.append(G.relu("block1_conv2_act", "block1_conv2_bn"))

    def res_block(prev: str, in_ch: int, block: int, filters: Tuple[int, int],
                  first_act: bool, res_idx: int, merge: str) -> str:
        """Down-sampling residual block in Keras layer order."""
        b = f"block{block}"
        sfx = "" if res_idx == 0 else f"_{res_idx}"
        res_conv, res_bn = f"conv2d{sfx}", f"batch_normalization{sfx}"
        x = prev
        if first_act:
            specs.append(G.relu(f"{b}_sepconv1_act", x))
            x = f"{b}_sepconv1_act"
        x = sepconv_bn(f"{b}_sepconv1", x, in_ch, filters[0])
        specs.append(G.relu(f"{b}_sepconv2_act", x))
        x = sepconv_bn(f"{b}_sepconv2", f"{b}_sepconv2_act", filters[0],
                       filters[1])
        specs.append(G.conv2d(res_conv, prev, in_ch, filters[1], (1, 1),
                              strides=(2, 2), padding="SAME",
                              use_bias=False))
        specs.append(G.max_pool(f"{b}_pool", x, (3, 3), strides=(2, 2),
                                padding="SAME"))
        specs.append(G.batch_norm(res_bn, res_conv, filters[1]))
        specs.append(G.add(merge, f"{b}_pool", res_bn))
        return merge

    prev = res_block("block1_conv2_act", 64, 2, (128, 128), False, 0, "add")
    prev = res_block(prev, 128, 3, (256, 256), True, 1, "add_1")
    prev = res_block(prev, 256, 4, (728, 728), True, 2, "add_2")

    # Middle flow: 8 identity-residual triple-sepconv blocks (add_3 ..
    # add_10 in Keras's auto-numbering).
    for block in range(5, 13):
        b = f"block{block}"
        x = prev
        for j in (1, 2, 3):
            specs.append(G.relu(f"{b}_sepconv{j}_act", x))
            x = sepconv_bn(f"{b}_sepconv{j}", f"{b}_sepconv{j}_act", 728, 728)
        specs.append(G.add(f"add_{block - 2}", prev, x))
        prev = f"add_{block - 2}"

    # Exit flow (residual conv2d_3 / batch_normalization_3 / add_11).
    prev = res_block(prev, 728, 13, (728, 1024), True, 3, "add_11")
    x = sepconv_bn("block14_sepconv1", prev, 1024, 1536)
    specs.append(G.relu("block14_sepconv1_act", x))
    x = sepconv_bn("block14_sepconv2", "block14_sepconv1_act", 1536, 2048)
    specs.append(G.relu("block14_sepconv2_act", x))
    return G.graph_of(*specs)


def build_xception(hparams: Dict[str, Any],
                   input_shape: Tuple[int, int, int], n_classes: int,
                   mixed_precision: bool = False,
                   output_bias: Optional[np.ndarray] = None) -> C.ModelSpec:
    graph, regs = C.classifier_head(
        xception_backbone(input_shape[-1]), n_classes=n_classes,
        dropout=float(hparams["DROPOUT"]), output_bias=output_bias)
    # The reference model function never freezes Xception's layers: its
    # batch norms train.
    phases = C.single_phase(graph, -1, float(hparams["LR"]),
                            freeze_bn=False)
    return C.ModelSpec(name="xception", graph=graph, preprocess_mode="tf",
                       input_shape=tuple(input_shape), n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases,
                       activity_regularizers=regs)
