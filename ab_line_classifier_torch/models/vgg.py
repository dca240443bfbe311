"""VGG16 family: the full ``vgg16`` classifier and the production
``cutoffvgg16`` (port of the JAX package's ``models/vgg.py``).

cutoffvgg16 trains in two phases: ``extract`` (every backbone layer
frozen, the head trains with Adam at LR_EXTRACT for EXTRACT_EPOCHS) then
``finetune`` (backbone layers at list index >= FINETUNE_LAYER of the
sliced layer list unfrozen, RMSprop at LR_FINETUNE for EPOCHS -
EXTRACT_EPOCHS + 1 epochs, as Keras's second ``fit`` with
``initial_epoch=EXTRACT_EPOCHS - 1``).

Keras layer numbering of VGG16 (include_top=False), which CUTOFF_LAYER
indexes into: 0=input, 1=block1_conv1, 2=block1_conv2, 3=block1_pool,
4=block2_conv1, 5=block2_conv2, 6=block2_pool, 7=block3_conv1,
8=block3_conv2, 9=block3_conv3, 10=block3_pool, 11..13=block4 convs,
14=block4_pool, 15..17=block5 convs, 18=block5_pool.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import common as C

# (n_convs, filters) per VGG16 block.
VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def vgg16_backbone(in_channels: int = 3) -> G.LayerGraph:
    """Full VGG16 conv stack with Keras layer names and ordering."""
    specs = []
    prev, width = G.INPUT, in_channels
    for b, (n_convs, filters) in enumerate(VGG16_BLOCKS, start=1):
        for c in range(1, n_convs + 1):
            name = f"block{b}_conv{c}"
            specs.append(G.conv2d(name, prev, width, filters, (3, 3),
                                  act=F.relu))
            prev, width = name, filters
        pool = f"block{b}_pool"
        specs.append(G.max_pool(pool, prev, (2, 2)))
        prev = pool
    return G.graph_of(*specs)


def build_vgg16(hparams: Dict[str, Any], input_shape: Tuple[int, int, int],
                n_classes: int, mixed_precision: bool = False,
                output_bias: Optional[np.ndarray] = None) -> C.ModelSpec:
    """The ``vgg16`` zoo entry: full backbone, GAP -> Dropout ->
    Dense(n_classes) -> softmax head; FREEZE_IDX freezes the backbone."""
    backbone = vgg16_backbone(input_shape[-1])
    graph, regs = C.classifier_head(
        backbone, n_classes=n_classes, dropout=float(hparams["DROPOUT"]),
        output_bias=output_bias)
    phases = C.single_phase(graph, int(hparams.get("FREEZE_IDX", -1)),
                            float(hparams["LR"]),
                            backbone_len=len(backbone.layers))
    return C.ModelSpec(name="vgg16", graph=graph, preprocess_mode="caffe",
                       input_shape=tuple(input_shape), n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases,
                       activity_regularizers=regs)


def build_cutoffvgg16(hparams: Dict[str, Any],
                      input_shape: Tuple[int, int, int], n_classes: int,
                      mixed_precision: bool = False,
                      output_bias: Optional[np.ndarray] = None,
                      total_epochs: Optional[int] = None) -> C.ModelSpec:
    """The production ``cutoffvgg16``: VGG16 layers ``[1:CUTOFF_LAYER]``
    (through block3_conv3 at the default 10) + GAP/Dropout/softmax-Dense,
    and its two-phase plan (module docstring). Without ``total_epochs``
    the finetune phase runs until the fit's epoch budget is spent."""
    cutoff_layer = int(hparams.get("CUTOFF_LAYER", 10))
    finetune_layer = int(hparams.get("FINETUNE_LAYER", 7))
    extract_epochs = int(hparams.get("EXTRACT_EPOCHS", 6))
    dropout = float(hparams.get("DROPOUT", 0.45))
    # Keras slices vgg16.layers[1:cutoff_layer]; with the input node at
    # index 0 that keeps graph indices 1..cutoff_layer-1.
    backbone = vgg16_backbone(input_shape[-1]).cut(cutoff_layer - 1)
    graph, regs = C.classifier_head(backbone, n_classes=n_classes,
                                    dropout=dropout, output_bias=output_bias)
    # The sliced Keras layer list [1:cutoff] and its parameterized layers.
    sliced = [s.name for s in backbone.layers[1:]]
    extract = {n: True for n in graph.param_layer_names()}
    finetune = dict(extract)
    for i, n in enumerate(sliced):
        if graph[n].has_params:
            extract[n] = False
            finetune[n] = i >= finetune_layer
    finetune_epochs = (None if total_epochs is None
                       else max(0, int(total_epochs) - extract_epochs + 1))
    phases = (
        C.TrainPhase(name="extract", optimizer="adam",
                     lr=float(hparams.get("LR_EXTRACT", 3e-4)),
                     trainable=extract, epochs=extract_epochs),
        C.TrainPhase(name="finetune", optimizer="rmsprop",
                     lr=float(hparams.get("LR_FINETUNE", 9.3e-6)),
                     trainable=finetune, epochs=finetune_epochs))
    return C.ModelSpec(name="cutoffvgg16", graph=graph,
                       preprocess_mode="caffe",
                       input_shape=tuple(input_shape), n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases,
                       activity_regularizers=regs)
