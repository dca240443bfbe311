"""``cnn0``, the from-scratch conv-block CNN (port of the JAX package's
``models/cnn0.py``): ZeroPad -> [Conv(relu) + BN + MaxPool(SAME)] x blocks
-> GAP -> Dropout -> Dense(relu) -> Dense -> softmax. As in the JAX
package, KERNEL_SIZE / STRIDES / MAXPOOL_SIZE take ints or [h, w] pairs and
FILTER_EXP_BASE is honored. The convs and ``fc0`` start from Keras
``he_uniform`` and carry an L2 activity regularizer (L2_LAMBDA); one Adam
phase at LR freezes nothing, so the batch norms train.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import common as C


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def build_cnn0(hparams: Dict[str, Any], input_shape: Tuple[int, int, int],
               n_classes: int, mixed_precision: bool = False,
               output_bias: Optional[np.ndarray] = None) -> C.ModelSpec:
    kernel = _pair(hparams.get("KERNEL_SIZE", 3))
    strides = _pair(hparams.get("STRIDES", 1))
    pool = _pair(hparams.get("MAXPOOL_SIZE", 2))
    n_blocks = int(hparams.get("BLOCKS", 4))
    init_filters = int(hparams.get("INIT_FILTERS", 32))
    base = float(hparams.get("FILTER_EXP_BASE", 2))
    l2_lambda = float(hparams.get("L2_LAMBDA", 0.0))
    pad = kernel[0] // 2

    specs = [G.zero_pad("zero_padding", G.INPUT, ((pad, pad), (pad, pad)))]
    prev, width = "zero_padding", input_shape[-1]
    regs: Dict[str, float] = {}
    for i in range(n_blocks):
        filters = int(init_filters * (base ** i))
        conv, bn = f"conv2d_block{i}_0", f"bn_block{i}"
        specs.append(G.with_init(
            G.conv2d(conv, prev, width, filters, kernel, strides=strides,
                     padding="SAME", act=F.relu), C.he_uniform))
        if l2_lambda:
            regs[conv] = l2_lambda
        specs.append(G.batch_norm(bn, conv, filters))
        prev, width = bn, filters
        if i < n_blocks - 1:
            specs.append(G.max_pool(f"maxpool{i}", prev, pool,
                                    padding="SAME"))
            prev = f"maxpool{i}"

    graph, head_regs = C.classifier_head(
        G.graph_of(*specs), n_classes=n_classes,
        dropout=float(hparams.get("DROPOUT", 0.35)), output_bias=output_bias,
        fc0_nodes=int(hparams.get("NODES_DENSE0", 64)), fc0_l2=l2_lambda,
        fc0_init=C.he_uniform)
    regs.update(head_regs)
    phases = C.single_phase(graph, -1, float(hparams["LR"]), freeze_bn=False)
    return C.ModelSpec(name="cnn0", graph=graph, preprocess_mode="tf",
                       input_shape=tuple(input_shape), n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases,
                       activity_regularizers=regs)
